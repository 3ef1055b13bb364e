"""The held-out mesh-pair bank of the learned matching components.

Port of ``_random_cube_mesh`` and ``build_mesh_pair_bank``
(``pixtrack_tpu/mapping/train_matcher.py:231-416``): renders of textured
cubes on the SfM capture rig's geometry, real detected keypoints and
descriptors, and ground-truth assignments from depth-consistent
reprojection. It is the protocol of ``assets/dense_descriptor_eval.json``'s
``deployment_ab_seed31`` (``scripts_dev/train_dense_descriptor_run.py``):
the dense descriptor against the patch descriptor at NN + ratio matching.
Every draw is numpy's (``default_rng(seed)``), so both packages build the
same scenes. The matcher's trainers are not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_cube_mesh(workdir, seed: int):
    """A textured cube with one distinct random tile per face. The texture is
    written reversed in its channels, as the JAX package's ``cv2.imwrite``
    of an RGB array writes it, so both packages render the same cube."""
    import scipy.ndimage as ndi

    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, write_png

    d = Path(workdir) / f"cube_{seed}"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, (128, 192, 3))
    tex = ndi.gaussian_filter(tex, (rng.uniform(1.0, 3.0),) * 2 + (0,))
    tex = ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.uint8)
    write_png(d / "tex.png", tex[..., ::-1])
    (d / "cube.mtl").write_text("newmtl m\nmap_Kd tex.png\n")
    s = 0.2
    v = [(x, y, z) for x in (-s, s) for y in (-s, s) for z in (-s, s)]
    faces = [  # (vertex quad, uv tile) per cube face
        ((0, 1, 3, 2), 0), ((4, 6, 7, 5), 1), ((0, 4, 5, 1), 2),
        ((2, 3, 7, 6), 3), ((0, 2, 6, 4), 4), ((1, 5, 7, 3), 5),
    ]
    lines = ["mtllib cube.mtl\nusemtl m"]
    for x, y, z in v:
        lines.append(f"v {x} {y} {z}")
    uv_tiles = [(c / 3.0, r / 2.0) for r in range(2) for c in range(3)]
    for (u0, v0) in uv_tiles:
        for (du, dv) in ((0, 0), (1 / 3, 0), (1 / 3, 1 / 2), (0, 1 / 2)):
            lines.append(f"vt {u0 + du} {v0 + dv}")
    for quad, tile in faces:
        a, b, c, dd = (i + 1 for i in quad)
        t = tile * 4 + 1
        lines.append(f"f {a}/{t} {b}/{t + 1} {c}/{t + 2}")
        lines.append(f"f {a}/{t} {c}/{t + 2} {dd}/{t + 3}")
    (d / "cube.obj").write_text("\n".join(lines) + "\n")
    return load_obj(d / "cube.obj")


def build_mesh_pair_bank(workdir, n_scenes: int = 4, n_views: int = 18, res: int = 192, max_kp: int = 256,
                         nms_radius: int = 1, min_deg: float = 8.0, max_deg: float = 52.0, gt_radius_px: float = 2.0,
                         seed: int = 0, verbose: bool = False, rich_textures: bool = False, detector=None,
                         device=None):
    """Detected keypoints + descriptors + depth-verified ground-truth
    assignments over wide-baseline mesh-render pairs.

    The geometry is the SfM capture rig's (a ring with elevation wobble,
    radius 0.9); detection and description are ``detector`` (the
    ``detect_and_describe`` contract; the production Harris + patch
    descriptor on ``device``, None the CUDA card, by default). Returns
    static-shape arrays: desc0/1 (P, K, D) f32, kpn0/1 (P, K, 2) in [-1, 1],
    valid0/1 (P, K) bool, gt (P, K) int32 (-1 = unmatched), angle_deg (P,).
    ``rich_textures`` draws each face from ``mapping/textures.py``'s family
    mix instead of blurred noise."""
    from pixtrack_tpu_torch.features.train_basin import _look_at_w2c
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.mapping.detector import detect_and_describe
    from pixtrack_tpu_torch.mapping.mesh_render import render_mesh
    from pixtrack_tpu_torch.mapping.textures import rich_cube_mesh

    if detector is None:
        def detector(image, **kw):
            return detect_and_describe(image, device=device, **kw)

    workdir = Path(workdir)
    rng = np.random.default_rng(seed)
    camera = Camera.pinhole(res * 1.1, res * 1.1, (res - 1) / 2, (res - 1) / 2, res, res, device="cpu")
    fx = fy = res * 1.1
    cx = cy = (res - 1) / 2

    P_desc0, P_desc1, P_kp0, P_kp1 = [], [], [], []
    P_v0, P_v1, P_gt, P_ang = [], [], [], []
    for sc in range(n_scenes):
        mesh = (rich_cube_mesh(workdir, seed * 100 + sc) if rich_textures
                else _random_cube_mesh(workdir, seed * 100 + sc))
        views = []
        for i in range(n_views):
            ang = 2 * np.pi * i / n_views + rng.uniform(-0.04, 0.04)
            el = rng.uniform(0.15, 0.55)
            center = 0.9 * np.array([np.sin(ang) * np.cos(el), np.sin(el), np.cos(ang) * np.cos(el)])
            T = _look_at_w2c(torch.as_tensor(center, dtype=torch.float32),
                             torch.tensor(rng.uniform(-0.3, 0.3), dtype=torch.float32))
            img, depth = render_mesh(mesh, T, camera, return_depth=True)
            kp, _, desc = detector(img, max_keypoints=max_kp, nms_radius=nms_radius)
            views.append((T, _np(kp), _np(desc), depth))

        def pad(a, fill=0.0):
            out = np.full((max_kp,) + a.shape[1:], fill, np.float32)
            out[: len(a)] = a
            return out

        centers = [-(_np(T.R).T @ _np(T.t)) for (T, _, _, _) in views]
        for i in range(n_views):
            for j in range(n_views):
                if i == j:
                    continue
                ci, cj = centers[i], centers[j]
                cosang = (ci @ cj) / (np.linalg.norm(ci) * np.linalg.norm(cj))
                ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
                if not (min_deg <= ang <= max_deg):
                    continue
                (Ti, kpi, dei, zi) = views[i]
                (Tj, kpj, dej, zj) = views[j]
                ni, nj = len(kpi), len(kpj)
                # backproject kp_i with its z-buffer depth
                xi = np.clip(np.round(kpi[:, 0]).astype(int), 0, res - 1)
                yi = np.clip(np.round(kpi[:, 1]).astype(int), 0, res - 1)
                z = zi[yi, xi]
                has_d = z > 0
                Xc = np.stack([(kpi[:, 0] - cx) / fx * z, (kpi[:, 1] - cy) / fy * z, z], axis=-1)
                Ri, ti = _np(Ti.R), _np(Ti.t)
                Xw = (Xc - ti) @ Ri
                uv, vis = camera.world2image(Tj, torch.as_tensor(Xw, dtype=torch.float32))
                uv, vis = _np(uv), _np(vis) & has_d
                # occlusion: depth in view j must agree with the z-buffer
                Rj, tj = _np(Tj.R), _np(Tj.t)
                zc_j = (Xw @ Rj.T + tj)[:, 2]
                xj = np.clip(np.round(uv[:, 0]).astype(int), 0, res - 1)
                yj = np.clip(np.round(uv[:, 1]).astype(int), 0, res - 1)
                zbuf_j = zj[yj, xj]
                vis &= (zbuf_j > 0) & (np.abs(zbuf_j - zc_j) < 0.04 * zc_j)
                # snap to the nearest detected keypoint in view j
                gt = np.full(max_kp, -1, np.int32)
                if vis.any() and nj:
                    d2 = ((uv[:, None, :] - kpj[None, :, :]) ** 2).sum(-1)
                    d2[~vis] = np.inf
                    best = np.argmin(d2, axis=1)
                    bd = d2[np.arange(ni), best]
                    ok = bd <= gt_radius_px**2
                    # injectivity: the nearer keypoint wins a contested target
                    taken = set()
                    for o in np.argsort(bd):
                        if not ok[o] or int(best[o]) in taken:
                            continue
                        gt[o] = best[o]
                        taken.add(int(best[o]))
                if (gt >= 0).sum() < 12:
                    continue  # too little supervision in this pair
                P_desc0.append(pad(dei))
                P_desc1.append(pad(dej))
                P_kp0.append(pad(kpi / (res - 1) * 2.0 - 1.0))
                P_kp1.append(pad(kpj / (res - 1) * 2.0 - 1.0))
                v0 = np.zeros(max_kp, bool)
                v0[:ni] = True
                v1 = np.zeros(max_kp, bool)
                v1[:nj] = True
                P_v0.append(v0)
                P_v1.append(v1)
                P_gt.append(gt)
                P_ang.append(ang)
        if verbose:
            print(f"bank scene {sc}: {len(P_gt)} pairs so far", flush=True)

    return {
        "desc0": np.stack(P_desc0), "desc1": np.stack(P_desc1),
        "kpn0": np.stack(P_kp0), "kpn1": np.stack(P_kp1),
        "valid0": np.stack(P_v0), "valid1": np.stack(P_v1),
        "gt": np.stack(P_gt), "angle_deg": np.asarray(P_ang, np.float32),
    }
