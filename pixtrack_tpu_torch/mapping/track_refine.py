"""Warp-compensated photometric track refinement.

Port of ``pixtrack_tpu/mapping/track_refine.py``. Every track observation is
aligned against the track's anchor observation under the plane-induced
homography of the point's tangent plane:

1. normals by local PCA over the k nearest 3D neighbours (host numpy, as in
   the JAX package);
2. for each (anchor a -> observation b) the homography
   H = K_b (R_ab + t_ab n_a^T / d_a) K_a^{-1} maps anchor-patch samples into
   view b (host f64);
3. a batched 2-parameter Lucas-Kanade translation solve per observation on
   the device aligns the warped patch photometrically; the refined keypoint
   replaces the observation where the fit improved.

The caller re-triangulates or re-BAs afterwards.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve, true_f32
from pixtrack_tpu_torch.mapping.featuremetric import _interp_multi
from pixtrack_tpu_torch.sfm.scene import SceneModel


@dataclasses.dataclass(frozen=True)
class TrackRefineConfig:
    patch: int = 9            # patch side (samples), anchor-view pixels
    iters: int = 8            # LK iterations
    max_shift_px: float = 3.0  # trust region around the initial keypoint
    knn: int = 8              # neighbours for normal estimation
    min_grad: float = 1e-4    # reject textureless patches
    max_planarity: float = 0.15  # PCA lambda_min / lambda_mid gate (edges out)
    # a refinement is kept only if the warped photometric residual fell to
    # this share of its start (bad normals, occlusions leave it flat or up)
    accept_ratio: float = 0.8


def estimate_normals(xyz: np.ndarray, knn: int = 8, return_planarity: bool = False):
    """Per-point normal by local PCA: the smallest eigenvector of the k-NN
    scatter, orientation unresolved. ``return_planarity`` also returns
    lambda_min / lambda_mid (near 0 where the neighbourhood is planar)."""
    n = len(xyz)
    k = min(knn + 1, n)
    d2 = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1)[:, 1:k]
    nbrs = xyz[idx]
    X = nbrs - nbrs.mean(axis=1, keepdims=True)
    w, v = np.linalg.eigh(np.einsum("nkd,nke->nde", X, X))
    if return_planarity:
        return v[:, :, 0], w[:, 0] / np.maximum(w[:, 1], 1e-12)
    return v[:, :, 0]


def _gray_stack(images: Dict[int, np.ndarray], iids):
    """{iid: (H, W) f32 grayscale in [0, 1]}."""
    out = {}
    for iid in iids:
        img = np.asarray(images[iid], np.float32)
        if img.dtype == np.uint8 or img.max() > 2.0:
            img = img / 255.0
        if img.ndim == 3:
            img = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
        out[iid] = img.astype(np.float32)
    return out


def _lk_batch(flat, off, Wv, Hv, Hmats, u_a, grid, patch_a, p0, iters: int = 8, max_shift: float = 3.0):
    """Batched warp-compensated LK translation solve on ``flat``'s device.

    flat (S,) all target images' grayscale, concatenated row-major;
    off / Wv / Hv (B,) per-observation image offsets, widths, heights;
    Hmats (B, 3, 3) anchor -> observation homographies (pixels);
    u_a (B, 2) anchor keypoints; grid (P, 2) patch sample offsets;
    patch_a (B, P) anchor patches (mean removed); p0 (B, 2) initial
    observation keypoints. Returns (refined keypoints (B, 2), ok (B,),
    cost before, cost after)."""
    off, Wv, Hv = off[:, None], Wv[:, None], Hv[:, None]
    eye2 = torch.eye(2, device=flat.device)
    with true_f32():
        pts_a = u_a[:, None, :] + grid[None, :, :]                                # (B, P, 2)
        ph = torch.cat([pts_a, torch.ones_like(pts_a[..., :1])], -1)
        q = torch.einsum("bij,bpj->bpi", Hmats, ph)
        base_b = q[..., :2] / q[..., 2:].abs().clamp(min=1e-8) * torch.sign(q[..., 2:])
        # the refined keypoint is H(u_a) + delta, started at p0
        u_warp = base_b[:, (grid.shape[0] - 1) // 2, :]
        delta0 = p0 - u_warp

        def residual(delta):
            v, g, valid = _interp_multi(flat[:, None], off, Wv, Hv, base_b + delta[:, None, :])
            v, g = v[..., 0], g[..., 0, :]
            mean = torch.where(valid, v, 0.0).sum(1, keepdim=True) / valid.sum(1, keepdim=True).clamp(min=1)
            r = torch.where(valid, v - mean - patch_a, 0.0)
            return r, torch.where(valid[..., None], g, 0.0), valid

        def cost(delta):
            r, _, valid = residual(delta)
            return (r * r).sum(1) / valid.sum(1).clamp(min=1)

        delta, ok = delta0, torch.ones(p0.shape[0], dtype=torch.bool, device=flat.device)
        for _ in range(iters):
            r, gw, _ = residual(delta)
            Jg = torch.einsum("bpk,bp->bk", gw, r)
            Hm = torch.einsum("bpk,bpl->bkl", gw, gw)
            tr = Hm[:, 0, 0] + Hm[:, 1, 1]
            ok = tr > 1e-6
            Hm = Hm + (1e-3 * tr[:, None, None] + 1e-9) * eye2
            step = -torch.linalg.solve_ex(Hm, Jg[..., None])[0][..., 0]
            delta = torch.minimum(torch.maximum(delta + step.clamp(-1.0, 1.0), delta0 - max_shift), delta0 + max_shift)
        return u_warp + delta, ok, cost(delta0), cost(delta)


def refine_tracks_photometric(
    scene: SceneModel,
    images: Dict[int, np.ndarray],
    cfg: TrackRefineConfig = TrackRefineConfig(),
    device=None,
) -> SceneModel:
    """Refine every track observation against its anchor view under the
    plane-induced homography. Returns a SceneModel with updated ``xys``
    (re-triangulate or re-BA after); ``_track_refine_applied`` counts the
    observations moved. ``device`` None is the CUDA card."""
    dev = resolve(device)
    iids = sorted(int(i) for i in scene.image_ids if int(i) in images)
    if len(iids) < 2 or not scene.points3D:
        return scene
    gray = _gray_stack(images, iids)
    offsets, rows = {}, 0
    for iid in iids:
        offsets[iid] = rows
        rows += gray[iid].size
    flat = np.concatenate([gray[i].reshape(-1) for i in iids])

    K = {iid: scene.camera_for_image(iid).K().numpy().astype(np.float64) for iid in iids}
    Kinv = {iid: np.linalg.inv(K[iid]) for iid in iids}
    Rt = {}
    for iid in iids:
        T = scene.pose_w2c(iid)
        Rt[iid] = T.R.numpy().astype(np.float64), T.t.numpy().astype(np.float64)

    pids = sorted(scene.points3D)
    xyz = np.stack([scene.points3D[p].xyz for p in pids])
    normals, planarity = estimate_normals(xyz, cfg.knn, return_planarity=True)
    P = cfg.patch
    half = (P - 1) / 2.0
    gy, gx = np.mgrid[0:P, 0:P]
    grid = np.stack([gx.ravel() - half, gy.ravel() - half], -1).astype(np.float32)

    obs_iid, obs_kidx, obs_Hm, obs_ua, obs_p0, obs_anchor_iid = [], [], [], [], [], []
    for mi, pid in enumerate(pids):
        rec = scene.points3D[pid]
        tr = [(int(i), int(k)) for i, k in zip(rec.image_ids, rec.point2D_idxs) if int(i) in gray]
        if len(tr) < 2 or planarity[mi] > cfg.max_planarity:
            continue  # an edge or corner point's tangent plane is meaningless
        X, n = xyz[mi], normals[mi]

        def frontality(iid):
            R, t = Rt[iid]
            Xc = R @ X + t
            return abs(float(n @ R.T @ (Xc / max(np.linalg.norm(Xc), 1e-9))))

        # the anchor: the view most frontal to the plane
        a_iid, a_kidx = max(tr, key=lambda o: frontality(o[0]))
        Ra, ta = Rt[a_iid]
        Xa = Ra @ X + ta
        n_a = Ra @ n
        if n_a @ Xa > 0:  # face the camera
            n_a = -n_a
        d_a = float(n_a @ Xa)
        if abs(d_a) < 1e-9:
            continue
        u_a = np.asarray(scene.images[a_iid].xys[a_kidx], np.float64) - 0.5
        for b_iid, b_kidx in tr:
            if b_iid == a_iid:
                continue
            Rb, tb = Rt[b_iid]
            R_ab = Rb @ Ra.T
            t_ab = tb - R_ab @ ta
            obs_iid.append(b_iid)
            obs_kidx.append(b_kidx)
            obs_Hm.append(K[b_iid] @ (R_ab + np.outer(t_ab, n_a) / d_a) @ Kinv[a_iid])
            obs_ua.append(u_a)
            obs_p0.append(np.asarray(scene.images[b_iid].xys[b_kidx], np.float64) - 0.5)
            obs_anchor_iid.append(a_iid)
    if not obs_iid:
        return scene

    B = len(obs_iid)
    # anchor patches, sampled on the host once, mean removed
    patch_a = np.zeros((B, P * P), np.float32)
    for b in range(B):
        g = gray[obs_anchor_iid[b]]
        Hh, Wh = g.shape
        pts = obs_ua[b][None, :] + grid
        x = np.clip(pts[:, 0], 0, Wh - 1.001)
        y = np.clip(pts[:, 1], 0, Hh - 1.001)
        x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
        fx, fy = x - x0, y - y0
        v = (g[y0, x0] * (1 - fx) * (1 - fy) + g[y0, x0 + 1] * fx * (1 - fy)
             + g[y0 + 1, x0] * (1 - fx) * fy + g[y0 + 1, x0 + 1] * fx * fy)
        patch_a[b] = v - v.mean()
    texture_ok = np.abs(np.diff(patch_a.reshape(B, P, P), axis=2)).mean((1, 2)) > cfg.min_grad

    def on_dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    p_ref, ok, cost0, cost1 = _lk_batch(
        on_dev(flat, torch.float32), on_dev([offsets[i] for i in obs_iid], torch.int64),
        on_dev([gray[i].shape[1] for i in obs_iid], torch.int64), on_dev([gray[i].shape[0] for i in obs_iid], torch.int64),
        on_dev(np.stack(obs_Hm), torch.float32), on_dev(np.stack(obs_ua), torch.float32), on_dev(grid, torch.float32),
        on_dev(patch_a, torch.float32), on_dev(np.stack(obs_p0), torch.float32), iters=cfg.iters,
        max_shift=cfg.max_shift_px,
    )
    p_ref = p_ref.cpu().numpy().astype(np.float64) + 0.5
    cost0, cost1 = cost0.cpu().numpy(), cost1.cpu().numpy()
    # keep genuinely improved fits, inside the trust region of the original keypoint
    ok = ok.cpu().numpy() & texture_ok & (cost1 <= np.maximum(cfg.accept_ratio * cost0, 1e-8))
    ok &= np.linalg.norm(p_ref - (np.stack(obs_p0) + 0.5), axis=1) <= cfg.max_shift_px + 1e-6

    new_images = {iid: dataclasses.replace(im, xys=np.asarray(im.xys, np.float64).copy())
                  for iid, im in scene.images.items()}
    for b in np.nonzero(ok)[0]:
        new_images[obs_iid[b]].xys[obs_kidx[b]] = p_ref[b]
    out = SceneModel(scene.cameras, new_images, scene.points3D)
    out._track_refine_applied = int(ok.sum())
    return out
