"""Featuremetric refinement: keypoint adjustment, point adjustment and
featuremetric bundle adjustment (the pixel-perfect-sfm role).

Port of ``pixtrack_tpu/mapping/featuremetric.py``. Dense feature pyramids
and bilinear sampling as in the tracker, with batched LM solves:

- keypoint adjustment (KA): each observation takes batched 2x2 LM steps
  toward its track's current mean descriptor, in a trust region;
- point adjustment (PA): each 3D point takes batched 3x3 LM steps against
  its observations' descriptors, anchored to its triangulated position;
- featuremetric BA: per-image pose refinement through ``align.lm`` against
  leave-one-out track means, then PA.

Everything runs on the extractor's device; products and solves in true f32
(``_device.true_f32``). The segment sums of KA gather each track's
observations into a padded (tracks, longest track) table and sum its rows,
so that they are deterministic on the card, where ``index_add_`` on floats
sums in atomic order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch._device import true_f32
from pixtrack_tpu_torch.features.extractor import FeatureExtractor
from pixtrack_tpu_torch.geometry import Pose
from pixtrack_tpu_torch.geometry.rotation import rotmat_to_quat
from pixtrack_tpu_torch.sfm.scene import SceneModel


@dataclasses.dataclass(frozen=True)
class FeatureMetricConfig:
    num_iters: int = 20
    lambda_init: float = 1e-2
    level: int = 0            # pyramid level to refine against (finest)
    max_shift_px: float = 4.0  # KA trust region
    # PA prior on the initial triangulated position: featuremetric point
    # adjustment is weakly constrained along viewing rays, so it is anchored
    # to the geometric solution
    position_prior: float = 10.0


# ---------------------------------------------------------------- KA ----
def _interp_multi(flat, off, Wv, Hv, pts):
    """Bilinear sample and gradient from a multi-image flat feature table.

    ``flat`` (S, C) is all images' maps concatenated row-major; observation b
    lives in the image whose rows start at ``off[b]``, of width ``Wv[b]`` and
    height ``Hv[b]``. Index-centred, as ``align.interpolate``. Returns
    (values (B, C), grads (B, C, 2), valid (B,))."""
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    valid = (x0i >= 0) & (x0i + 1 <= Wv - 1) & (y0i >= 0) & (y0i + 1 <= Hv - 1)
    base = off + torch.minimum(y0i.clamp(min=0), Hv - 2) * Wv + torch.minimum(x0i.clamp(min=0), Wv - 2)
    f00, f01 = flat[base], flat[base + 1]
    f10, f11 = flat[base + Wv], flat[base + Wv + 1]
    wx0, wx1 = (1.0 - fx)[..., None], fx[..., None]
    wy0, wy1 = (1.0 - fy)[..., None], fy[..., None]
    values = (f00 * wx0 + f01 * wx1) * wy0 + (f10 * wx0 + f11 * wx1) * wy1
    gx = (f01 - f00) * wy0 + (f11 - f10) * wy1
    gy = (f10 - f00) * wx0 + (f11 - f01) * wx1
    return values, torch.stack([gx, gy], dim=-1), valid


def _segment_table(track_idx: np.ndarray, n_tracks: int) -> torch.Tensor:
    """(n_tracks, longest track) indices of each track's observations in
    order, padded with B (a zero row appended to the values)."""
    B = len(track_idx)
    counts = np.bincount(track_idx, minlength=n_tracks)
    table = np.full((n_tracks, max(int(counts.max(initial=0)), 1)), B, np.int64)
    order = np.argsort(track_idx, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(B) - starts[track_idx[order]]
    table[track_idx[order], slot] = order
    return torch.as_tensor(table)


def _ka_solve(flat, off, Wv, Hv, p0, track_idx, lam, max_shift, iters: int, n_tracks: int):
    """The KA loop on the device: each iteration, every observation takes
    one LM step toward its track's current mean descriptor, clipped to 1 px
    and to a trust region of ``max_shift`` around its start. ``track_idx``
    is a numpy (B,) array; the other arrays are tensors on one device."""
    dev = flat.device
    table = _segment_table(np.asarray(track_idx, np.int64), n_tracks).to(dev)
    tix = torch.as_tensor(np.asarray(track_idx, np.int64), device=dev)
    cnt = torch.as_tensor(np.bincount(track_idx, minlength=n_tracks), dtype=p0.dtype, device=dev).clamp(min=1.0)
    eye2 = torch.eye(2, dtype=p0.dtype, device=dev)
    p = p0
    with true_f32():
        for _ in range(iters):
            vals, J, _ = _interp_multi(flat, off, Wv, Hv, p)
            padded = torch.cat([vals, vals.new_zeros((1, vals.shape[1]))])
            sums = padded[table].sum(1)                       # (n_tracks, C)
            target = sums[tix] / cnt[tix][:, None]
            r = vals - target
            g = torch.einsum("bck,bc->bk", J, r)
            H = torch.einsum("bck,bcl->bkl", J, J)
            H = H + (lam * torch.diagonal(H, dim1=-2, dim2=-1)[..., None] + 1e-8) * eye2
            delta = -torch.linalg.solve_ex(H, g[..., None])[0][..., 0]
            drift = (p + delta.clamp(-1.0, 1.0) - p0).clamp(-max_shift, max_shift)
            p = p0 + drift
    return p


def _level_map(extractor: FeatureExtractor, image, level: int):
    """(level map (H, W, C) f32 on the extractor's device, (sx, sy) scale)."""
    pyr = extractor(image)
    return pyr.levels[level].float(), np.asarray(pyr.scales[level])


def keypoint_adjustment(
    images: Dict[int, np.ndarray],
    keypoints: Dict[int, np.ndarray],
    tracks: List[List[Tuple[int, int]]],
    extractor: FeatureExtractor,
    cfg: FeatureMetricConfig = FeatureMetricConfig(),
) -> Dict[int, np.ndarray]:
    """Refine keypoint locations so tracks agree feature-metrically; returns
    the updated keypoints (corner convention kept). One flat feature table
    of all images and per-observation row offsets, on the extractor's
    device."""
    obs = [(ti, iid, kidx) for ti, tr in enumerate(tracks) for iid, kidx in tr]
    new_kp = {iid: kp.copy().astype(np.float64) for iid, kp in keypoints.items()}
    if not obs:
        return new_kp
    used = sorted({iid for _, iid, _ in obs})
    feats, scales = {}, {}
    for iid in used:
        feats[iid], scales[iid] = _level_map(extractor, images[iid], cfg.level)
    offsets, rows = {}, 0
    for iid in used:
        offsets[iid] = rows
        rows += feats[iid].shape[0] * feats[iid].shape[1]
    C = feats[used[0]].shape[-1]
    flat = torch.cat([feats[i].reshape(-1, C) for i in used])
    dev = flat.device

    def per_obs(values):
        return torch.as_tensor(np.asarray(values, np.int64), device=dev)

    iids = [o[1] for o in obs]
    p0 = np.stack([(new_kp[iid][kidx] - 0.5) * scales[iid] for _, iid, kidx in obs]).astype(np.float32)
    p_final = _ka_solve(
        flat, per_obs([offsets[i] for i in iids]), per_obs([feats[i].shape[1] for i in iids]),
        per_obs([feats[i].shape[0] for i in iids]), torch.as_tensor(p0, device=dev),
        np.asarray([o[0] for o in obs], np.int64), cfg.lambda_init, cfg.max_shift_px,
        iters=cfg.num_iters, n_tracks=len(tracks),
    ).cpu().numpy().astype(np.float64)
    for (_, iid, kidx), q in zip(obs, p_final):
        new_kp[iid][kidx] = q / scales[iid] + 0.5
    return new_kp


def _cubic_taps(n_out: int, n_in: int, scale: int, device):
    """Source rows (n_out, 4) and weights (n_out, 4) of cv2's INTER_CUBIC:
    pixel centres aligned, (d + 0.5) / scale - 0.5, the a = -0.75 kernel,
    indices past the edge clamped (the edge pixel repeats)."""
    a = -0.75
    f = ((np.arange(n_out) + 0.5) / scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    t = (f - s).astype(np.float32)
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], -1).astype(np.float32)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None], 0, n_in - 1)
    return torch.as_tensor(idx, device=device), w


def resize_cubic(image, scale: int, device=None) -> torch.Tensor:
    """``cv2.resize(image, None, fx=scale, fy=scale, interpolation=INTER_CUBIC)``
    on the device for an integer ``scale``: (H, W) or (H, W, C), uint8 or
    float. uint8 follows cv2's fixed point (weights rounded to 1/2048, the
    rows' integer sums, rounded back and saturated); float sums in f32."""
    img = torch.as_tensor(np.asarray(image)) if not isinstance(image, torch.Tensor) else image
    img = img.to(device if device is not None else img.device)
    H, W = img.shape[:2]
    iy, wy = _cubic_taps(H * scale, H, scale, img.device)
    ix, wx = _cubic_taps(W * scale, W, scale, img.device)
    if img.dtype == torch.uint8:
        x = img.long()
        ax = torch.as_tensor(np.round(wx * 2048).astype(np.int64), device=img.device)
        ay = torch.as_tensor(np.round(wy * 2048).astype(np.int64), device=img.device)
    else:
        x = img.float()
        ax, ay = torch.as_tensor(wx, device=img.device), torch.as_tensor(wy, device=img.device)
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    h = sum(x[:, ix[:, k]] * ax[:, k][ex] for k in range(4))           # (H, W * s, ...)
    v = sum(h[iy[:, k]] * ay[:, k][(slice(None), None) + ex[1:]] for k in range(4))
    if img.dtype == torch.uint8:
        return ((v + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)
    return v


def refine_scene_keypoints(
    scene: SceneModel,
    images: Dict[int, np.ndarray],
    extractor: FeatureExtractor,
    cfg: FeatureMetricConfig = FeatureMetricConfig(),
    upsample: int = 1,
) -> SceneModel:
    """KA over the converged model's tracks; the refined observations are
    written back into the image records (the caller re-BAs). ``upsample``
    > 1 extracts the features of images upsampled by that factor (cubic, as
    cv2's ``INTER_CUBIC``), keypoints and trust region scaled along."""
    tracks = []
    for pid in sorted(scene.points3D):
        rec = scene.points3D[pid]
        tr = [(int(i), int(k)) for i, k in zip(rec.image_ids, rec.point2D_idxs) if int(i) in images]
        if len(tr) >= 2:
            tracks.append(tr)
    if not tracks:
        return scene
    kps = {int(iid): np.asarray(im.xys, np.float64).copy() for iid, im in scene.images.items() if int(iid) in images}
    if upsample > 1:
        imgs_u = {iid: resize_cubic(img, upsample, extractor.device) for iid, img in images.items()}
        kps_u = {iid: kp * upsample for iid, kp in kps.items()}
        cfg_u = dataclasses.replace(cfg, max_shift_px=cfg.max_shift_px * upsample)
        refined = keypoint_adjustment(imgs_u, kps_u, tracks, extractor, cfg_u)
        refined = {iid: kp / upsample for iid, kp in refined.items()}
    else:
        refined = keypoint_adjustment(images, kps, tracks, extractor, cfg)
    new_images = {}
    for iid, im in scene.images.items():
        if int(iid) in refined:
            im = dataclasses.replace(im, xys=refined[int(iid)])
        new_images[iid] = im
    return SceneModel(scene.cameras, new_images, scene.points3D)


# ---------------------------------------------------------------- PA ----
def point_adjustment(
    scene: SceneModel,
    images: Dict[int, np.ndarray],
    extractor: FeatureExtractor,
    cfg: FeatureMetricConfig = FeatureMetricConfig(),
    max_views: int = 8,
) -> np.ndarray:
    """Refine 3D points feature-metrically, poses fixed: each point minimises
    the spread of its first ``max_views`` views' descriptors at its
    projections, batched 3x3 LM with a position prior. Returns xyz (M, 3)."""
    feats, scales, poses, cams = {}, {}, {}, {}
    for iid in scene.image_ids:
        iid = int(iid)
        if images.get(iid) is None:
            continue
        feats[iid], scales[iid] = _level_map(extractor, images[iid], cfg.level)
        poses[iid] = scene.pose_w2c(iid)
        cams[iid] = scene.camera_for_image(iid)
    M, V = len(scene.point_ids), max_views
    fidx_list = sorted(feats)
    f_of = {iid: k for k, iid in enumerate(fidx_list)}
    Hf, Wf, C = feats[fidx_list[0]].shape
    dev = feats[fidx_list[0]].device
    flat = torch.stack([feats[i] for i in fidx_list]).reshape(-1, C)   # (n_images * H * W, C)

    view_idx = np.zeros((M, V), np.int64)
    view_mask = np.zeros((M, V), np.float32)
    R_stack = np.zeros((M, V, 3, 3), np.float32)
    t_stack = np.zeros((M, V, 3), np.float32)
    K_f = np.zeros((M, V, 2), np.float32)
    K_c = np.zeros((M, V, 2), np.float32)
    sc_stack = np.ones((M, V, 2), np.float32)
    for mi, pid in enumerate(scene.point_ids):
        vs = [int(i) for i in scene.points3D[int(pid)].image_ids if int(i) in feats][:V]
        for vi, iid in enumerate(vs):
            view_idx[mi, vi] = f_of[iid]
            view_mask[mi, vi] = 1.0
            R_stack[mi, vi] = poses[iid].R.numpy()
            t_stack[mi, vi] = poses[iid].t.numpy()
            K_f[mi, vi] = cams[iid].f.numpy()
            K_c[mi, vi] = cams[iid].c.numpy()
            sc_stack[mi, vi] = scales[iid]

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    R_s, t_s, mask = on_dev(R_stack), on_dev(t_stack), on_dev(view_mask)
    f_s, c_s, sc = on_dev(K_f), on_dev(K_c), on_dev(sc_stack)
    off = on_dev(view_idx * (Hf * Wf))
    Wv, Hv = on_dev(np.int64(Wf)), on_dev(np.int64(Hf))
    eye3 = torch.eye(3, device=dev)
    xyz0 = on_dev(scene.xyz.astype(np.float32))
    xyz, lam, mu = xyz0, cfg.lambda_init, cfg.position_prior
    with true_f32():
        for _ in range(cfg.num_iters):
            pc = torch.einsum("mvij,mj->mvi", R_s, xyz) + t_s
            z = pc[..., 2].clamp(min=1e-4)
            uv = pc[..., :2] / z[..., None]
            p2d = (uv * f_s + c_s) * sc
            vals, grads, ok = _interp_multi(flat, off, Wv, Hv, p2d)       # (M, V, C), (M, V, C, 2)
            w = mask * ok
            mean = torch.einsum("mv,mvc->mc", w, vals) / w.sum(1).clamp(min=1)[:, None]
            r = (vals - mean[:, None, :]) * w[..., None]
            iz = 1.0 / z
            zero = torch.zeros_like(iz)
            J_uv = torch.stack([torch.stack([iz, zero, -uv[..., 0] * iz], -1),
                                torch.stack([zero, iz, -uv[..., 1] * iz], -1)], dim=-2)   # (M, V, 2, 3)
            J_pix = J_uv * (f_s * sc)[..., None]
            J_x = torch.einsum("mvik,mvkj->mvij", J_pix, R_s)
            J = torch.einsum("mvcd,mvdk->mvck", grads, J_x)                # (M, V, C, 3)
            Jw = J * w[..., None, None]
            g = torch.einsum("mvck,mvc->mk", Jw, r) + mu * (xyz - xyz0)
            H = torch.einsum("mvck,mvcl->mkl", Jw, J) + mu * eye3
            H = H + (lam * torch.diagonal(H, dim1=-2, dim2=-1)[..., None] + 1e-8) * eye3
            delta = -torch.linalg.solve_ex(H, g[..., None])[0][..., 0]
            xyz = xyz + delta.clamp(-0.02, 0.02)
    return xyz.cpu().numpy()


def _scene_with(scene: SceneModel, poses: Dict[int, Pose], xyz: np.ndarray) -> SceneModel:
    """SceneModel with updated per-image poses and packed-order xyz."""
    images = {}
    for iid, im in scene.images.items():
        if int(iid) in poses:
            T = poses[int(iid)]
            im = dataclasses.replace(im, qvec=rotmat_to_quat(T.R).cpu().numpy().astype(np.float64),
                                     tvec=T.t.cpu().numpy().astype(np.float64))
        images[iid] = im
    points = {}
    for k, pid in enumerate(scene.point_ids):
        points[int(pid)] = dataclasses.replace(scene.points3D[int(pid)], xyz=np.asarray(xyz[k], np.float64))
    return SceneModel(scene.cameras, images, points)


def featuremetric_ba(
    scene: SceneModel,
    images: Dict[int, np.ndarray],
    extractor: FeatureExtractor,
    rounds: int = 2,
    pose_iters: int = 30,
    cfg: FeatureMetricConfig = FeatureMetricConfig(),
    point_block: bool = True,
    finest_only: bool = True,
    verbose: bool = False,
) -> SceneModel:
    """Joint featuremetric refinement of poses and points, block by block:

    (a) pose block: each image's pose aligned by ``align.lm`` against the
        leave-one-out track means of its observed points (the mean over the
        other views' current projections);
    (b) point block: ``point_adjustment``, anchored to the geometric points.

    ``finest_only`` aligns poses on the finest pyramid level only. Returns
    a SceneModel with the same tracks, new poses and xyz, on the
    extractor's device."""
    from pixtrack_tpu_torch.align.lm import AlignConfig, align_pyramid
    from pixtrack_tpu_torch.align.observations import aggregate_observations, build_level_data, observe_points
    from pixtrack_tpu_torch.features.pyramid import FeaturePyramid

    iids = [int(i) for i in scene.image_ids if int(i) in images]
    if len(iids) < 3:
        return scene
    M = len(scene.point_ids)
    if M == 0:
        return scene
    dev = extractor.device
    pyrs = {iid: extractor(images[iid]) for iid in iids}
    poses = {iid: scene.pose_w2c(iid, dev) for iid in iids}
    cams = {iid: scene.camera_for_image(iid, dev) for iid in iids}
    xyz = torch.as_tensor(scene.xyz.astype(np.float32), device=dev)
    obs = {iid: np.zeros(M, bool) for iid in iids}
    for k, pid in enumerate(scene.point_ids):
        for im in scene.points3D[int(pid)].image_ids:
            if int(im) in obs:
                obs[int(im)][k] = True
    obs_t = {iid: torch.as_tensor(m, device=dev) for iid, m in obs.items()}

    lvl_sel = [0] if finest_only else list(range(pyrs[iids[0]].num_levels))
    align_cfg = AlignConfig(num_iters=pose_iters)
    for r in range(rounds):
        per_view = {iid: observe_points(pyrs[iid], poses[iid], cams[iid], xyz, obs_t[iid]) for iid in iids}
        F = [torch.stack([per_view[i][0][lv] for i in iids]) for lv in lvl_sel]
        Wg = [torch.stack([per_view[i][1][lv] for i in iids]) for lv in lvl_sel]
        Vl = [torch.stack([per_view[i][2][lv] for i in iids]) for lv in lvl_sel]
        for vi, iid in enumerate(iids):
            keep = torch.as_tensor([k for k in range(len(iids)) if k != vi], device=dev)
            agg = [aggregate_observations(F[li][keep], Wg[li][keep], Vl[li][keep]) for li in range(len(lvl_sel))]
            pyr = pyrs[iid]
            pyr_sel = FeaturePyramid(
                levels=tuple(pyr.levels[lv] for lv in lvl_sel),
                scales=tuple(pyr.scales[lv] for lv in lvl_sel),
                confidences=None if pyr.confidences is None else tuple(pyr.confidences[lv] for lv in lvl_sel),
            )
            levels = build_level_data(pyr_sel, tuple(a[0] for a in agg), tuple(a[1] for a in agg),
                                      tuple(a[2] for a in agg), xyz, obs_t[iid])
            final, _ = align_pyramid(poses[iid], levels, cams[iid], align_cfg)
            poses[iid] = final.T
        if point_block:
            scene_r = _scene_with(scene, poses, xyz.cpu().numpy())
            xyz = torch.as_tensor(point_adjustment(scene_r, images, extractor, cfg), device=dev)
        if verbose:
            print(f"featuremetric BA round {r + 1}/{rounds} done")
    return _scene_with(scene, poses, xyz.cpu().numpy())
