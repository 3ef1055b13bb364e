"""Train the attentional matcher; the mesh-pair bank of the learned components.

Port of ``pixtrack_tpu/mapping/train_matcher.py``. Two data sources:

1. Plane pairs (``make_pair``, ``make_batch``, ``train_matcher``): textured
   planes rendered with exact two-view geometry (``features/train_basin.py``'s
   scene machinery), planted keypoints at plane points seen in both views
   plus distractors, described by the production patch descriptor; the loss
   is the dual-softmax NLL of the planted assignment (``matcher_loss``).
   The JAX pair draws the direction and the magnitude of the second view's
   motion from one key (``k_rel``); the port keeps that arithmetic: the
   direction's first normal is the one ``jax.random.normal`` makes of the
   magnitude's uniform. Draws are dicts of canonical draws
   (``pair_draws``) from a ``torch.Generator``, or given from outside.
2. The mesh-pair bank (``_random_cube_mesh``, ``build_mesh_pair_bank``):
   renders of textured cubes on the SfM capture rig's geometry, real
   detected keypoints and descriptors, and ground-truth assignments from
   depth-consistent reprojection (also the protocol of
   ``assets/dense_descriptor_eval.json``'s ``deployment_ab_seed31``). Every
   draw is numpy's (``default_rng(seed)``), so both packages build the same
   scenes. ``train_matcher_on_bank`` trains on it against
   ``assignment_nll``: the host path draws its split, batches, rotations
   and descriptor noise from ``np.random.default_rng(cfg.seed)`` as the
   JAX package does, so its batches equal JAX's; the device-resident path
   (``scan_chunk > 0``) uploads the bank once (descriptors in f16) and
   samples on the card from a ``torch.Generator``.

Both trainers run ``clip_by_global_norm(1.0)`` then Adam under
``warmup_cosine_decay_schedule(0, lr, min(200, n // 10), n, 0.05 lr)``
(``nerf/optim.py``).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch._draws import _normal_of_uniform, _rand, _randn, _uniform


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


# ------------------------------------------------------------ plane pairs ---
@dataclasses.dataclass(frozen=True)
class MatcherTrainConfig:
    n_steps: int = 2000
    batch: int = 4
    size: int = 160
    tex_size: int = 192
    n_match: int = 96           # planted correspondences per pair
    n_distract: int = 32        # per-view unmatched keypoints
    max_rel_deg: float = 45.0   # relative-rotation range (wide baseline)
    jitter_px: float = 0.5      # keypoint localization noise
    lr: float = 2e-4
    log_every: int = 50
    seed: int = 0
    # bank-training augmentation: an independent in-plane rotation of each
    # view's normalized keypoints, and descriptor noise + renormalization
    aug_rotate: bool = True
    aug_desc_noise: float = 0.02


def pair_draws(cfg: MatcherTrainConfig, lead: tuple = (), generator=None, device=None) -> dict:
    """The draws of ``make_pair`` for pairs over ``lead``: the texture's,
    the first view's distance, polar and azimuth angles and roll, the
    relative motion (``rel``: its magnitude's uniform; ``rel_dir``: its six
    normals, the first made of that same uniform), the planted points, the
    two views' distractors and the keypoint jitter's normals."""
    from pixtrack_tpu_torch.features.train_basin import texture_draws

    rel = _rand(generator, device, *lead)
    rel_dir = _randn(generator, device, *lead, 6)
    rel_dir[..., 0] = _normal_of_uniform(rel)
    return {"texture": texture_draws(lead, 48, generator, device), "pose": _rand(generator, device, *lead, 3),
            "roll": _rand(generator, device, *lead), "rel": rel, "rel_dir": rel_dir,
            "points": _rand(generator, device, *lead, cfg.n_match, 2),
            "d0": _rand(generator, device, *lead, cfg.n_distract, 2),
            "d1": _rand(generator, device, *lead, cfg.n_distract, 2),
            "jitter": _randn(generator, device, *lead, 2, cfg.n_match, 2)}


def make_pair(d: dict, cfg: MatcherTrainConfig, camera):
    """Training pairs from their draws ``d`` (batched over a leading axis or
    not): (img0, img1, kp0, kp1, valid_match); the keypoints hold the
    planted matches first, then the distractors."""
    from pixtrack_tpu_torch.features.train_basin import _look_at_w2c, random_texture, render_plane

    size = cfg.size
    dev = d["rel"].device
    texture = random_texture(cfg.tex_size, draws=d["texture"], device=dev)
    dist = _uniform(d["pose"][..., 0], 1.3, 1.9)
    th = _uniform(d["pose"][..., 1], 0.05, 0.7)
    ph = _uniform(d["pose"][..., 2], 0.0, 2 * np.pi)
    center = dist[..., None] * torch.stack([torch.sin(th) * torch.cos(ph), torch.sin(th) * torch.sin(ph),
                                            torch.cos(th)], dim=-1)
    T0 = _look_at_w2c(center, _uniform(d["roll"], -np.pi, np.pi))
    # the second view: a random relative motion up to max_rel_deg
    dr = d["rel_dir"] / torch.linalg.vector_norm(d["rel_dir"], dim=-1, keepdim=True).clamp_min(1e-8)
    mag = float(np.deg2rad(cfg.max_rel_deg)) * d["rel"]
    scale = torch.tensor([1, 1, 1, 0.25, 0.25, 0.25], dtype=dr.dtype, device=dev)
    T1 = T0.retract(dr * mag[..., None] * scale)
    img0 = render_plane(texture, None, T0, camera, (size, size))
    img1 = render_plane(texture, None, T1, camera, (size, size))

    # planted correspondences: plane points visible in both views
    uvp = _uniform(d["points"], -0.45, 0.45)
    p3d = torch.cat([uvp, torch.zeros_like(uvp[..., :1])], dim=-1)
    kp0m, v0 = camera.world2image(T0, p3d)
    kp1m, v1 = camera.world2image(T1, p3d)

    def inb(k):
        return (k[..., 0] > 8) & (k[..., 0] < size - 9) & (k[..., 1] > 8) & (k[..., 1] < size - 9)

    valid_match = v0 & v1 & inb(kp0m) & inb(kp1m)
    # localization jitter (detector noise), then the distractors
    kp0m = kp0m + d["jitter"][..., 0, :, :] * cfg.jitter_px
    kp1m = kp1m + d["jitter"][..., 1, :, :] * cfg.jitter_px
    kp0 = torch.cat([kp0m, _uniform(d["d0"], 10.0, size - 11.0)], dim=-2)
    kp1 = torch.cat([kp1m, _uniform(d["d1"], 10.0, size - 11.0)], dim=-2)
    return img0, img1, kp0, kp1, valid_match


def make_batch(cfg: MatcherTrainConfig, d: dict):
    """A training batch from ``cfg.batch`` pairs' draws: (desc0, kpn0,
    desc1, kpn1, valid_match), the keypoints normalised to [-1, 1] and
    described by the production patch descriptor (13 x 13 samples, 2 px)."""
    from pixtrack_tpu_torch._device import true_f32
    from pixtrack_tpu_torch.features.train_basin import plane_camera
    from pixtrack_tpu_torch.mapping.detector import _describe

    size = cfg.size
    dev = d["rel"].device
    img0, img1, kp0, kp1, vm = make_pair(d, cfg, plane_camera(size, dev))
    with true_f32():
        de0 = torch.stack([_describe(img0[b], kp0[b], 13, 2.0) for b in range(img0.shape[0])])
        de1 = torch.stack([_describe(img1[b], kp1[b], 13, 2.0) for b in range(img1.shape[0])])
    return de0, kp0 / (size - 1) * 2.0 - 1.0, de1, kp1 / (size - 1) * 2.0 - 1.0, vm


def matcher_loss(logp: torch.Tensor, valid_match: torch.Tensor, n_match: int, n_total: int) -> torch.Tensor:
    """NLL of the planted assignment: pair i <-> i where valid; every other
    keypoint (invalid plants and distractors) belongs to a dustbin."""
    B = logp.shape[0]
    idx = torch.arange(n_match, device=logp.device)
    pos = torch.where(valid_match, logp[:, idx, idx], 0.0)
    n_pos = valid_match.sum(1).clamp_min(1)
    row_bin = logp[:, :n_total, n_total]
    col_bin = logp[:, n_total, :n_total]
    unm0 = torch.cat([~valid_match, torch.ones((B, n_total - n_match), dtype=torch.bool, device=logp.device)], 1)
    neg0 = torch.where(unm0, row_bin, 0.0)
    neg1 = torch.where(unm0, col_bin, 0.0)  # the same planted validity by symmetry
    n_neg = unm0.sum(1).clamp_min(1)
    loss = -(pos.sum(1) / n_pos) - 0.5 * (neg0.sum(1) / n_neg + neg1.sum(1) / n_neg)
    return loss.mean()


def _step(model, opt, params, loss_fn):
    """One step: the loss, its backward, the global-norm clip, Adam."""
    from pixtrack_tpu_torch.nerf.optim import clip_by_global_norm

    loss = loss_fn()
    loss.backward()
    clip_by_global_norm(params, 1.0)
    opt.step()
    return loss.detach()


def train_matcher(cfg: MatcherTrainConfig = MatcherTrainConfig(), mcfg=None, model=None, callback=None,
                  device=None, generator: Optional[torch.Generator] = None, draws: Optional[Iterable[dict]] = None):
    """Train on plane pairs; ``model`` (else ``init_matcher(mcfg)`` from
    ``cfg.seed``) is trained in place on ``device`` (None is the CUDA
    card). Each step's draws: ``pair_draws`` over the batch from
    ``generator`` (seeded ``cfg.seed + 1`` by default) or ``draws``. The
    loss at step i (from 1) is logged at i = 1 and every ``log_every``;
    ``callback(step, loss, model)``. Returns (model, info)."""
    from pixtrack_tpu_torch.mapping.attention_matcher import MatcherConfig, assignment_log_probs, init_matcher
    from pixtrack_tpu_torch.nerf.optim import Adam, matcher_schedule

    device = resolve(device)
    mcfg = mcfg or MatcherConfig()
    model = model if model is not None else init_matcher(mcfg, torch.Generator().manual_seed(cfg.seed), device)
    model.train()
    params = list(model.parameters())
    opt = Adam(params, matcher_schedule(cfg.lr, cfg.n_steps))
    gen = generator or torch.Generator(device=device).manual_seed(cfg.seed + 1)
    draws = iter(draws) if draws is not None else None
    n_total = cfg.n_match + cfg.n_distract
    history = []
    t0 = time.time()
    for i in range(cfg.n_steps):
        d = next(draws) if draws is not None else pair_draws(cfg, (cfg.batch,), gen, device)
        with torch.no_grad():
            de0, kn0, de1, kn1, vm = make_batch(cfg, d)
        valid = torch.ones((de0.shape[0], n_total), dtype=torch.bool, device=device)

        def loss_fn():
            scores = model(de0, kn0, valid, de1, kn1, valid)
            return matcher_loss(assignment_log_probs(scores), vm, cfg.n_match, n_total)

        loss = _step(model, opt, params, loss_fn)
        if (i + 1) % cfg.log_every == 0 or i == 0:
            lv = float(loss)
            history.append((i + 1, lv))
            if callback:
                callback(i + 1, lv, model)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return model.eval(), {"history": history, "seconds": time.time() - t0}


# ----------------------------------------------------------- bank trainer ---
def assignment_nll(logp: torch.Tensor, gt0: torch.Tensor, valid0: torch.Tensor, valid1: torch.Tensor
                   ) -> torch.Tensor:
    """NLL of an arbitrary ground-truth assignment, per pair over the leading
    axes: logp (..., N0 + 1, N1 + 1) dual-softmax log-probs, gt0 (..., N0)
    view-1 keypoint indices or -1, valid masks (..., N0), (..., N1). A
    view-1 keypoint counts as matched where the last row that points at it
    is matched: the JAX package's scatter, whose unmatched rows (clipped to
    index 0) write False, applies its updates in row order."""
    N0, N1 = gt0.shape[-1], logp.shape[-1] - 1
    matched = (gt0 >= 0) & valid0
    idx = gt0.clamp(0, N1 - 1).long()
    pos = torch.where(matched, torch.gather(logp[..., :N0, :N1], -1, idx[..., None])[..., 0], 0.0)
    n_pos = matched.sum(-1).clamp_min(1)
    unm0 = valid0 & ~matched
    neg0 = torch.where(unm0, logp[..., :N0, N1], 0.0)
    rows = torch.arange(N0, device=idx.device).expand(idx.shape)
    last = torch.full((*idx.shape[:-1], N1), -1, dtype=torch.long, device=idx.device)
    last = last.scatter_reduce(-1, idx, rows, reduce="amax")
    hit = (last >= 0) & torch.gather(matched, -1, last.clamp_min(0))
    unm1 = valid1 & ~hit
    neg1 = torch.where(unm1, logp[..., N0, :N1], 0.0)
    return (-(pos.sum(-1) / n_pos)
            - 0.5 * (neg0.sum(-1) / unm0.sum(-1).clamp_min(1) + neg1.sum(-1) / unm1.sum(-1).clamp_min(1)))


def bank_batch(host: dict, idx, cfg: MatcherTrainConfig, rng: Optional[np.random.Generator] = None) -> tuple:
    """The host path's batch: the pairs ``idx`` of a bank's numpy arrays as
    (desc0, kpn0, valid0, desc1, kpn1, valid1, gt), descriptors and keypoints
    in f32; augmented from ``rng`` when one is given, with the JAX package's
    draws in its order (a roll per pair of view 0, then of view 1, then the
    descriptor noise of view 0, then of view 1)."""
    d0 = host["desc0"][idx].astype(np.float32)
    d1 = host["desc1"][idx].astype(np.float32)
    k0 = host["kpn0"][idx].astype(np.float32)
    k1 = host["kpn1"][idx].astype(np.float32)
    if rng is not None:
        if cfg.aug_rotate:
            for karr in (k0, k1):  # an independent roll per view
                th = rng.uniform(-np.pi, np.pi, size=len(idx))
                ca, sa = np.cos(th), np.sin(th)
                R = np.stack([np.stack([ca, -sa], -1), np.stack([sa, ca], -1)], -2)
                karr[:] = np.einsum("bij,bnj->bni", R, karr)
        if cfg.aug_desc_noise > 0:
            for darr in (d0, d1):
                darr += rng.normal(0, cfg.aug_desc_noise, darr.shape)
                darr /= np.clip(np.linalg.norm(darr, axis=-1, keepdims=True), 1e-8, None)
    return d0, k0, host["valid0"][idx], d1, k1, host["valid1"][idx], host["gt"][idx]


def upload_bank(host: dict, rows, device) -> dict:
    """The device-resident path's bank: the pairs ``rows`` on ``device``,
    the descriptors in f16 (as the JAX package keeps them on the TPU)."""
    dev = {k: torch.as_tensor(host[k][rows], device=device) for k in ("kpn0", "kpn1", "valid0", "valid1", "gt")}
    dev.update({k: torch.as_tensor(host[k][rows], dtype=torch.float16, device=device) for k in ("desc0", "desc1")})
    return dev


def device_draws(dev: dict, cfg: MatcherTrainConfig, gen: torch.Generator) -> dict:
    """One device batch's draws from ``gen``: ``idx`` the pairs (rows of
    ``dev``), ``th0``, ``th1`` a roll per pair and view in [-pi, pi), ``n0``,
    ``n1`` unit normals per descriptor entry (those the configuration uses)."""
    device = dev["gt"].device
    d = {"idx": torch.randint(0, dev["gt"].shape[0], (cfg.batch,), generator=gen, device=device)}
    if cfg.aug_rotate:
        for k in ("th0", "th1"):
            d[k] = torch.rand(cfg.batch, generator=gen, device=device) * (2 * np.pi) - np.pi
    if cfg.aug_desc_noise > 0:
        for k, name in (("n0", "desc0"), ("n1", "desc1")):
            d[k] = torch.randn((cfg.batch, *dev[name].shape[1:]), generator=gen, device=device)
    return d


def device_batch(dev: dict, cfg: MatcherTrainConfig, d: dict) -> tuple:
    """The device-resident path's batch (``bank_batch``'s layout) from the
    uploaded bank and one batch's draws (``device_draws``)."""
    idx = d["idx"]
    d0, d1 = dev["desc0"][idx].float(), dev["desc1"][idx].float()
    k0, k1 = dev["kpn0"][idx].float(), dev["kpn1"][idx].float()
    if cfg.aug_rotate:
        def rot(karr, th):
            ca, sa = torch.cos(th), torch.sin(th)
            R = torch.stack([torch.stack([ca, -sa], -1), torch.stack([sa, ca], -1)], -2)
            return torch.einsum("bij,bnj->bni", R, karr)
        k0, k1 = rot(k0, d["th0"]), rot(k1, d["th1"])
    if cfg.aug_desc_noise > 0:
        def noisy(desc, n):
            desc = desc + cfg.aug_desc_noise * n
            return desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-8)
        d0, d1 = noisy(d0, d["n0"]), noisy(d1, d["n1"])
    return d0, k0, dev["valid0"][idx], d1, k1, dev["valid1"][idx], dev["gt"][idx]


def train_matcher_on_bank(bank: dict, cfg: MatcherTrainConfig = MatcherTrainConfig(), mcfg=None, model=None,
                          holdout_frac: float = 0.1, callback=None, scan_chunk: int = 0, device=None,
                          generator: Optional[torch.Generator] = None):
    """Train on a mesh-pair bank (``build_mesh_pair_bank``) on ``device``
    (None is the CUDA card). Returns (model, info) with the held-out NLL.

    - ``scan_chunk=0``: the bank stays on the host and each batch is
      sampled and augmented with numpy from ``default_rng(cfg.seed)``, the
      JAX package's draws in its order; logged at step 1 and every
      ``log_every``.
    - ``scan_chunk=K>0``: the bank is uploaded once (descriptors in f16) and
      each batch is sampled and augmented on the device from ``generator``
      (seeded ``cfg.seed + 7`` by default); logged every K steps, where the
      JAX package ends a ``lax.scan`` chunk."""
    from pixtrack_tpu_torch.mapping.attention_matcher import MatcherConfig, assignment_log_probs, init_matcher
    from pixtrack_tpu_torch.nerf.optim import Adam, matcher_schedule

    device = resolve(device)
    mcfg = mcfg or MatcherConfig(desc_dim=bank["desc0"].shape[-1])
    model = model if model is not None else init_matcher(mcfg, torch.Generator().manual_seed(cfg.seed), device)
    model.train()
    params = list(model.parameters())
    P = bank["gt"].shape[0]
    n_hold = max(1, int(P * holdout_frac))
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(P)
    hold, tr = perm[:n_hold], perm[n_hold:]
    host = {k: np.asarray(v) for k, v in bank.items()}
    opt = Adam(params, matcher_schedule(cfg.lr, cfg.n_steps))
    dtype = next(model.parameters()).dtype

    def to_dev(arrays):
        return tuple(torch.as_tensor(a, device=device) for a in arrays)

    def nll(batch):
        d0, k0, v0, d1, k1, v1, gt = batch
        d0, k0, d1, k1 = (a.to(dtype) for a in (d0, k0, d1, k1))  # the model's first layers promote, as flax's
        return assignment_nll(assignment_log_probs(model(d0, k0, v0, d1, k1, v1)), gt, v0, v1)

    def holdout_nll() -> float:
        total = 0.0
        with torch.no_grad():
            for s in range(0, len(hold), cfg.batch):
                idx = hold[s: s + cfg.batch]
                if len(idx) < cfg.batch:  # pad to the batch shape, as the JAX package's jitted batch
                    idx = np.concatenate([idx, hold[: cfg.batch - len(idx)]])
                total += float(nll(to_dev(bank_batch(host, idx, cfg))).sum())
        return total / (-(-len(hold) // cfg.batch) * cfg.batch)

    history = []
    t0 = time.time()
    if scan_chunk > 0:
        dev = upload_bank(host, tr, device)
        gen = generator or torch.Generator(device=device).manual_seed(cfg.seed + 7)
        done = 0
        while done < cfg.n_steps:
            for _ in range(scan_chunk):
                batch = device_batch(dev, cfg, device_draws(dev, cfg, gen))
                loss = _step(model, opt, params, lambda: nll(batch).mean())
            done += scan_chunk
            lv = float(loss)
            history.append((done, lv))
            if callback:
                callback(done, lv, model)
    else:
        for i in range(cfg.n_steps):
            idx = rng.integers(0, len(tr), cfg.batch)
            batch = to_dev(bank_batch(host, tr[idx], cfg, rng))
            loss = _step(model, opt, params, lambda: nll(batch).mean())
            if (i + 1) % cfg.log_every == 0 or i == 0:
                lv = float(loss)
                history.append((i + 1, lv))
                if callback:
                    callback(i + 1, lv, model)
    model.eval()
    h_nll = holdout_nll()
    return model, {"history": history, "holdout_nll": h_nll, "seconds": time.time() - t0, "n_pairs": int(P)}
