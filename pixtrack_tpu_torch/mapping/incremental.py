"""Incremental SfM from unposed images: the COLMAP-mapper role.

Port of ``pixtrack_tpu/mapping/incremental.py``. Every RANSAC is
hypothesis-batched on the device (hundreds to thousands of minimal solves as
one batched SVD and one dense scoring pass, no per-sample Python loop), pose
polish is a fixed number of Gauss-Newton steps on the device with no host
sync per step, and the final assembly reuses the batched multi-view
triangulator (``mapping/triangulate.py``).

Algorithm (the standard incremental pipeline):
  1. detect, describe and mutual-ratio match every pair; verify each pair by
     essential-matrix and homography RANSAC;
  2. featuremetric keypoint adjustment (optional);
  3. initialise the poses: the strongest-neighbour chain, then global
     rotation and translation averaging (``mapping/global_init.py``), or
     (``strategy="pnp"``) an init pair;
  4. register the other images by robust Gauss-Newton from the best
     registered neighbour and by DLT-6pt PnP RANSAC, the better of the two
     behind an inlier gate;
  5. triangulate what the registered images support, bundle-adjust the
     whole model now and then, cull outlying observations, re-register
     every pose against the converged structure;
  6. assemble a SceneModel through ``triangulate_scene``, then featuremetric
     BA (optional).

The host loops stay host loops, as in the JAX package: the pair loop,
registration and culling. Random draws come from one ``torch.Generator``
seeded by ``seed``, through ``_draw_indices``, on the CPU, so one seed gives
the same hypotheses on either device. Products run in true f32
(``_device.true_f32``) where the JAX package forces
``default_matmul_precision("float32")``; SVDs run in f64 (``_svd``). Two
deliberate deltas from the JAX package: a RANSAC never chooses a sample
that draws one correspondence twice (``_repeats``), and the Sampson polish
takes its Jacobian in closed form (the same derivative as JAX's
``jacfwd``).

Deltas vs COLMAP: single shared camera, intrinsics fixed (the caller
supplies them, e.g. f = 1.2 * max(w, h) as pycolmap's prior), exhaustive
pairs (no vocabulary-tree retrieval).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve, true_f32
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.geometry.rotation import so3_hat
from pixtrack_tpu_torch.sfm import colmap_io
from pixtrack_tpu_torch.sfm.scene import SceneModel


def _draw_indices(generator: torch.Generator, n_hyp: int, k: int, n: int, device) -> torch.Tensor:
    """(n_hyp, k) hypothesis indices, uniform in [0, n), drawn on the
    generator's device (the CPU) and moved to ``device``."""
    return torch.randint(0, n, (n_hyp, k), generator=generator).to(device)


def _repeats(*rows: torch.Tensor) -> torch.Tensor:
    """(B,) True where a minimal sample draws one correspondence twice:
    rows (B, k, d) per side, equal on every side. Such a sample leaves the
    minimal solver a null space of two or more dimensions, and the model
    it returns is whichever vector of that space the SVD library builds:
    LAPACK's and cuSOLVER's differ, and so do two LAPACK builds. The
    cyclic power-of-two padding of the verification makes these samples
    common (23-53 % of 2048 draws on the 6-view arc), and the JAX package
    scores them as any other; the RANSACs here never choose them, so the
    chosen hypothesis does not depend on the SVD library."""
    k = rows[0].shape[1]
    same = torch.ones(rows[0].shape[0], k, k, dtype=torch.bool, device=rows[0].device)
    for r in rows:
        same = same & (r[:, :, None, :] == r[:, None, :, :]).all(-1)
    off = ~torch.eye(k, dtype=torch.bool, device=same.device)
    return (same & off).flatten(1).any(1)


def _best(scores: torch.Tensor, repeats: torch.Tensor) -> torch.Tensor:
    """The first hypothesis of the highest score (``jnp.argmax``'s tie
    rule), samples with a repeated correspondence scored -1."""
    return torch.argmax(torch.where(repeats, -1, scores))


def _svd(A: torch.Tensor, full_matrices: bool = True):
    """``torch.linalg.svd`` of A taken in f64, the factors rounded back to
    A's dtype. The JAX package's SVDs run in f32 through LAPACK; on the card
    f32 takes cuSOLVER's Jacobi SVD, and the essential RANSACs of
    chip_smoke phase 30 then kept 2.6 % of their inlier flags apart from the
    CPU's on the same draws (NVIDIA H100 80GB HBM3, 700 W); in f64, 1.4 %
    (what is left comes from refits on near-planar inlier sets)."""
    u, s, vt = torch.linalg.svd(A.double(), full_matrices=full_matrices)
    return u.to(A.dtype), s.to(A.dtype), vt.to(A.dtype)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


# ---------------------------------------------------------------------------
# Essential matrix: batched 8-point + Sampson RANSAC
# ---------------------------------------------------------------------------

def _epipolar_rows(p0, p1):
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)], dim=-1)


def _to_essential(E: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto the essential manifold: singular values (1, 1, 0)."""
    u, _, vt = _svd(E)
    sv = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return u @ (sv[:, None] * vt)


def _eight_point(p0, p1):
    """(B, 8, 2) normalised correspondences -> (B, 3, 3) essential candidates."""
    _, _, vt = _svd(_epipolar_rows(p0, p1), full_matrices=True)
    return _to_essential(vt[..., -1, :].reshape(-1, 3, 3))


def _sampson(E, p0, p1, eps=1e-12):
    """Squared Sampson distance. E (B, 3, 3), p0/p1 (N, 2) -> (B, N)."""
    x0, x1 = _homogeneous(p0), _homogeneous(p1)
    Ex0 = torch.einsum("bij,nj->bni", E, x0)
    Etx1 = torch.einsum("bji,nj->bni", E, x1)
    x1Ex0 = torch.einsum("ni,bni->bn", x1, Ex0)
    denom = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return x1Ex0**2 / (denom + eps)


def _eight_point_weighted(p0, p1, w):
    """Least-squares E from ALL weighted correspondences (N >= 8)."""
    _, _, vt = _svd(_epipolar_rows(p0, p1) * w[:, None], full_matrices=False)
    return _to_essential(vt[-1].reshape(3, 3))


def _essential_ransac(p0, p1, generator, n_hyp: int = 4096, thresh: float = 1e-5, lo_iters: int = 3):
    """Hypothesis-batched 8-point RANSAC + local-optimisation refits: each
    LO iteration refits E by weighted least squares on the current inlier
    set and re-scores. Samples that repeat a correspondence are not chosen
    (``_repeats``). Returns (E, inlier mask, inlier count) on p0's device,
    with no host sync."""
    idx = _draw_indices(generator, n_hyp, 8, p0.shape[0], p0.device)
    with true_f32():
        E = _eight_point(p0[idx], p1[idx])
        inl = _sampson(E, p0, p1) < thresh
        best = _best(inl.sum(dim=1), _repeats(p0[idx], p1[idx]))
        E_best, inl_best = E[best], inl[best]
        for _ in range(lo_iters):
            E_best = _eight_point_weighted(p0, p1, inl_best.float())
            inl_best = _sampson(E_best[None], p0, p1)[0] < thresh
    return E_best, inl_best, inl_best.sum()


def _homography_rows(p0, p1):
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    one, zero = torch.ones_like(x0), torch.zeros_like(x0)
    r1 = torch.stack([x0, y0, one, zero, zero, zero, -x1 * x0, -x1 * y0, -x1], dim=-1)
    r2 = torch.stack([zero, zero, zero, x0, y0, one, -y1 * x0, -y1 * y0, -y1], dim=-1)
    return r1, r2


def _four_point_h(p0, p1):
    """(B, 4, 2) correspondences -> (B, 3, 3) homographies (DLT)."""
    r1, r2 = _homography_rows(p0, p1)
    _, _, vt = _svd(torch.cat([r1, r2], dim=1), full_matrices=True)  # (B, 8, 9)
    return vt[..., -1, :].reshape(-1, 3, 3)


def _h_transfer(H, p0, p1, eps=1e-9):
    """Forward transfer error |H p0 - p1|^2, (B, N)."""
    Hx = torch.einsum("bij,nj->bni", H, _homogeneous(p0))
    z = Hx[..., 2:]
    uv = Hx[..., :2] / torch.where(z.abs() < eps, torch.full_like(z, eps), z)
    return ((uv - p1[None]) ** 2).sum(-1)


def _homography_ransac(p0, p1, generator, n_hyp: int = 2048, thresh: float = 1e-5, lo_iters: int = 2):
    idx = _draw_indices(generator, n_hyp, 4, p0.shape[0], p0.device)
    with true_f32():
        H = _four_point_h(p0[idx], p1[idx])
        inl = _h_transfer(H, p0, p1) < thresh
        best = _best(inl.sum(dim=1), _repeats(p0[idx], p1[idx]))
        H_best, inl_best = H[best], inl[best]
        for _ in range(lo_iters):
            # weighted least-squares refit on the inliers
            w = inl_best.float()[:, None]
            r1, r2 = _homography_rows(p0, p1)
            _, _, vt = _svd(torch.cat([r1 * w, r2 * w], dim=0), full_matrices=False)
            H_best = vt[-1].reshape(3, 3)
            inl_best = _h_transfer(H_best[None], p0, p1)[0] < thresh
    return H_best, inl_best, inl_best.sum()


def decompose_homography(H: np.ndarray):
    """Calibrated homography -> up to 8 (R, t, n) (Faugeras/Malis SVD method).

    H maps normalised coordinates cam0 -> cam1 for a plane n^T x = d (cam0
    frame): H ~ R + t n^T / d. Returns candidate rigid motions with |t|
    unnormalised by d (scale-free, like the essential path). numpy, f64."""
    H = np.asarray(H, np.float64)
    U, S, Vt = np.linalg.svd(H)
    d1, d2, d3 = S
    if d2 < 1e-12:
        return []
    H = H / d2
    d1, d3 = d1 / d2, d3 / d2
    s = np.linalg.det(U) * np.linalg.det(Vt)
    out = []
    if abs(d1 - d3) < 1e-9:  # pure rotation (degenerate plane at infinity)
        R = s * U @ Vt
        return [(R, np.zeros(3), np.array([0.0, 0.0, 1.0]))]
    x1 = np.sqrt(max((d1**2 - 1.0) / (d1**2 - d3**2), 0.0))
    x3 = np.sqrt(max((1.0 - d3**2) / (d1**2 - d3**2), 0.0))
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            n_p = np.array([e1 * x1, 0.0, e3 * x3])
            # d' > 0 family
            sin_t = (d1 - d3) * e1 * x1 * e3 * x3
            cos_t = d1 * x3**2 + d3 * x1**2
            Rp = np.array([[cos_t, 0, -sin_t], [0, 1, 0], [sin_t, 0, cos_t]])
            tp = (d1 - d3) * np.array([e1 * x1, 0.0, -e3 * x3])
            R = s * U @ Rp @ Vt
            t = U @ tp
            n = Vt.T @ n_p
            if n[2] < 0:  # plane normal faces the camera
                n, t = -n, -t
            out.append((R, t, n))
            # d' < 0 family
            sin_t2 = (d1 + d3) * e1 * x1 * e3 * x3
            cos_t2 = d3 * x1**2 - d1 * x3**2
            Rp2 = np.array([[cos_t2, 0, sin_t2], [0, -1, 0], [sin_t2, 0, -cos_t2]])
            tp2 = (d1 + d3) * np.array([e1 * x1, 0.0, e3 * x3])
            R2 = s * U @ Rp2 @ Vt
            t2 = U @ tp2
            n2 = Vt.T @ n_p
            if n2[2] < 0:
                n2, t2 = -n2, -t2
            out.append((R2, t2, n2))
    return out


def _triangulate_pair(R, t, p0, p1):
    """Two-view DLT in normalised coordinates, one batched 4x4 SVD. R (..., 3,
    3) and t (..., 3) may carry leading batch dims (several motions at once);
    p0, p1 (N, 2). Returns the points (..., N, 3) in the cam0 frame and their
    depths in both cameras (..., N)."""
    P1 = torch.cat([R, t[..., None]], dim=-1)                        # (..., 3, 4)
    P0 = torch.eye(3, 4, dtype=R.dtype, device=R.device)
    lead = R.shape[:-2]
    P0 = P0.expand(*lead, 3, 4)
    u0 = p0.expand(*lead, *p0.shape)[..., None]                       # (..., N, 2, 1)
    u1 = p1.expand(*lead, *p1.shape)[..., None]
    A = torch.cat([u0 * P0[..., None, 2:3, :] - P0[..., None, 0:2, :],
                   u1 * P1[..., None, 2:3, :] - P1[..., None, 0:2, :]], dim=-2)   # (..., N, 4, 4)
    _, _, vt = _svd(A)
    X = vt[..., -1, :]
    w = X[..., 3:]
    X = X[..., :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    with true_f32():
        x1 = X @ R.transpose(-1, -2) + t[..., None, :]
    return X, X[..., 2], x1[..., 2]


def estimate_relative_pose(p0n, p1n, generator, n_hyp: int = 4096, thresh_px: float = 2.0, focal: float = 1.0,
                           return_candidates: bool = False, device=None):
    """Two-view relative pose (cam0 -> cam1, unit baseline) from normalised
    correspondences, via essential RANSAC + a cheirality vote over the four
    (R, t) decompositions and the homography's. Returns (T_0to1, inlier
    mask), or with ``return_candidates`` every near-best, rotationally
    distinct polished candidate as [(score, T, inlier mask)].

    ``thresh_px`` is the inlier gate in pixels, converted to the squared
    Sampson units of the scoring through ``focal``. ``device`` None is the
    CUDA card."""
    dev = resolve(device)
    p0 = torch.as_tensor(np.asarray(p0n), dtype=torch.float32).to(dev)
    p1 = torch.as_tensor(np.asarray(p1n), dtype=torch.float32).to(dev)
    thresh = (thresh_px / focal) ** 2

    # model A: essential matrix (general scenes)
    E, inlE, _ = _essential_ransac(p0, p1, generator, n_hyp=n_hyp, thresh=thresh)
    u, _, vt = _svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=dev)
    with true_f32():
        Rs = torch.stack([u @ W @ vt, u @ W.T @ vt])
    Rs = (Rs * torch.sign(torch.linalg.det(Rs))[:, None, None]).cpu().numpy().astype(np.float64)
    u3 = u[:, 2].cpu().numpy().astype(np.float64)
    candidates = [(R, s * u3, inlE) for R in Rs for s in (1.0, -1.0)]

    # model B: homography (shallow / near-planar objects, the 8-point's
    # degenerate case); both translation signs, since the decomposition
    # carries a (t, n) <-> (-t, -n) ambiguity
    Hm, inlH, _ = _homography_ransac(p0, p1, generator, thresh=thresh)
    for (R, t, _) in decompose_homography(Hm.cpu().numpy()):
        if np.linalg.norm(t) > 1e-6:
            candidates.append((R, t, inlH))
            candidates.append((R, -t, inlH))

    # cheirality + reprojection vote, every candidate in one batch: inliers
    # in front of both cameras that reproject within the gate into image 1
    tns = [t / max(np.linalg.norm(t), 1e-12) for _, t, _ in candidates]
    Rc = torch.as_tensor(np.stack([R for R, _, _ in candidates]), dtype=torch.float32).to(dev)
    tc = torch.as_tensor(np.stack(tns), dtype=torch.float32).to(dev)
    X, z0, _ = _triangulate_pair(Rc, tc, p0, p1)
    with true_f32():
        x1 = X @ Rc.transpose(-1, -2) + tc[:, None, :]
    z = x1[..., 2:]
    uv1 = x1[..., :2] / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    reproj_ok = ((uv1 - p1) ** 2).sum(-1) < thresh
    inl_c = torch.stack([inl for _, _, inl in candidates])
    scores = ((z0 > 0) & (x1[..., 2] > 0) & reproj_ok & inl_c).sum(-1).tolist()
    scored = [(s, R, tn, inl) for s, (R, _, inl), tn in zip(scores, candidates, tns)]
    scored.sort(key=lambda s: -s[0])
    best_score = scored[0][0]

    def polish(R, tn, inl):
        # maximum-likelihood polish: Gauss-Newton on the Sampson error over
        # (R, t), 5 true DOF, no structure in the loop
        T = Pose.from_Rt(torch.as_tensor(R, dtype=torch.float32), torch.as_tensor(tn, dtype=torch.float32), dev)
        return refine_relative_pose_sampson(T, p0, p1, inl.float())

    if not return_candidates:
        _, R, tn, inl = scored[0]
        return polish(R, tn, inl), inl.cpu().numpy()

    # near-planar pairs: the homography decomposition is two-fold ambiguous;
    # return every near-best, rotationally distinct candidate (polished) and
    # let the caller disambiguate by graph (triangle) consistency
    out = []
    for (score, R, tn, inl) in scored:
        if score < 0.7 * max(best_score, 1):
            continue
        dup = False
        for (_, T_prev, _) in out:
            c = (np.trace(T_prev.R.cpu().numpy() @ R.T) - 1) / 2
            if np.degrees(np.arccos(np.clip(c, -1, 1))) < 3.0:
                dup = True
                break
        if not dup:
            out.append((score, polish(R, tn, inl), inl.cpu().numpy()))
        if len(out) == 4:
            break
    return out


def refine_relative_pose_sampson(T01: Pose, p0, p1, w, iters: int = 30, damping: float = 1e-4) -> Pose:
    """GN on sum w * sampson^2 over a left se(3) delta of T01; the
    translation renormalised to the unit-baseline gauge each step (the 6th
    DOF is pure gauge and the damping absorbs it); ``iters`` steps, no host
    sync.

    The Jacobian is analytic, the JAX package's ``jacfwd`` at delta = 0
    written out: a left delta (w, v) moves E = [t]x R by
    dE = [w x t + v]x R + [t]x [w]x R, and each residual num / den (num =
    x1^T E x0, den the norm of the first two entries of E x0 and E^T x1)
    by (dnum den - num dden) / den^2. (``torch.func.jacfwd`` gives the same
    numbers but dispatches its batched forward mode through Python
    decompositions: most of a polish's host time.)"""
    x0, x1 = _homogeneous(p0), _homogeneous(p1)
    eye3 = torch.eye(3, dtype=p0.dtype, device=p0.device)
    eye6 = torch.eye(6, dtype=p0.dtype, device=p0.device)
    R, t = T01.R, T01.t
    with true_f32():
        for _ in range(iters):
            E = so3_hat(t) @ R
            Ex0, Etx1 = x0 @ E.T, x1 @ E
            num = (x1 * Ex0).sum(1)
            den = torch.sqrt(Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2 + 1e-12)
            K = so3_hat(eye3)                                               # [e_k]x, (3, 3, 3)
            dE = torch.cat([so3_hat(torch.linalg.cross(eye3, t.expand(3, 3))) @ R + so3_hat(t) @ K @ R,
                            K @ R])                                         # (6, 3, 3)
            dEx0 = torch.einsum("kij,nj->kni", dE, x0)
            dEtx1 = torch.einsum("kji,nj->kni", dE, x1)
            dnum = (x1 * dEx0).sum(-1)                                      # (6, N)
            dden = (Ex0[:, 0] * dEx0[..., 0] + Ex0[:, 1] * dEx0[..., 1] + Etx1[:, 0] * dEtx1[..., 0]
                    + Etx1[:, 1] * dEtx1[..., 1]) / den
            J = ((dnum * den - num * dden) / (den * den) * w).T             # (N, 6)
            r = num / den * w
            delta, info = torch.linalg.solve_ex(J.T @ J + damping * eye6, -(J.T @ r))
            delta = torch.where(torch.isfinite(delta) & (info == 0), delta, 0.0)
            Tn = Pose(R, t).retract(delta)
            R, t = Tn.R, Tn.t / torch.linalg.norm(Tn.t).clamp(min=1e-9)
    return Pose(R, t)


# ---------------------------------------------------------------------------
# PnP: batched DLT-6pt RANSAC + Gauss-Newton polish
# ---------------------------------------------------------------------------

def _proper_scale(P: torch.Tensor) -> torch.Tensor:
    """Fix a DLT projection's sign and scale: the rotation part proper, |det| 1."""
    det = torch.linalg.det(P[..., :3])
    P = P * torch.sign(det)[..., None, None]
    norm = det.abs().pow(1.0 / 3.0)
    return P / torch.where(norm < 1e-12, torch.full_like(norm, 1e-12), norm)[..., None, None]


def _pnp_rows(p3d, p2dn):
    X = _homogeneous(p3d)
    zero = torch.zeros_like(X)
    u, v = p2dn[..., 0:1], p2dn[..., 1:2]
    return torch.cat([X, zero, -u * X], dim=-1), torch.cat([zero, X, -v * X], dim=-1)


def _dlt_pnp(p3d, p2dn):
    """(B, 6, 3) points, (B, 6, 2) normalised observations -> (B, 3, 4) projections."""
    r1, r2 = _pnp_rows(p3d, p2dn)
    _, _, vt = _svd(torch.cat([r1, r2], dim=1))       # (B, 12, 12)
    return _proper_scale(vt[..., -1, :].reshape(-1, 3, 4))


def _score_P(P, p3d, p2dn, thresh):
    proj = torch.einsum("...ij,nj->...ni", P, _homogeneous(p3d))
    z = proj[..., 2:]
    uv = proj[..., :2] / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    err = torch.linalg.norm(uv - p2dn, dim=-1)
    return (err < thresh) & (z[..., 0] > 0)


def _dlt_pnp_weighted(p3d, p2dn, w):
    """Least-squares P from ALL weighted 2D-3D correspondences."""
    r1, r2 = _pnp_rows(p3d, p2dn)
    rows = torch.cat([r1, r2], dim=0) * torch.cat([w, w])[:, None]
    _, _, vt = _svd(rows, full_matrices=False)
    return _proper_scale(vt[-1].reshape(3, 4))


def _pnp_ransac(p3d, p2dn, generator, n_hyp: int = 1024, thresh: float = 2e-3, lo_iters: int = 2):
    idx = _draw_indices(generator, n_hyp, 6, p3d.shape[0], p3d.device)
    with true_f32():
        P = _dlt_pnp(p3d[idx], p2dn[idx])
        inl = _score_P(P, p3d, p2dn[None], thresh)
        best = _best(inl.sum(dim=1), _repeats(p3d[idx], p2dn[idx]))
        P_best, inl_best = P[best], inl[best]
        for _ in range(lo_iters):
            P_best = _dlt_pnp_weighted(p3d, p2dn, inl_best.float())
            inl_best = _score_P(P_best, p3d, p2dn, thresh)
    return P_best, inl_best, inl_best.sum()


def _orthogonalize(P) -> Tuple[np.ndarray, np.ndarray]:
    """Projective (3, 4) -> nearest rigid (R, t), numpy f64."""
    P = _np(P)
    M = np.asarray(P[:, :3], np.float64)
    u, s, vt = np.linalg.svd(M)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R, s = -R, -s
    scale = s.mean()
    t = np.asarray(P[:, 3], np.float64) / max(scale, 1e-12)
    return R, t


def refine_pose_reprojection(T: Pose, p3d, p2d_ic, weights, camera: Camera, iters: int = 15,
                             damping: float = 1e-3, robust_c_px: float = 0.0) -> Pose:
    """Gauss-Newton polish of a w2c pose on pixel reprojection residuals,
    ``iters`` steps on the tensors' device, no host sync.

    With ``robust_c_px`` > 0 the residuals get Cauchy IRLS weights: a
    hypothesis-free robust PnP when initialised from a neighbouring pose
    (DLT-based minimal solvers are degenerate for coplanar points, which
    single-face views of objects produce constantly)."""
    camera = camera.to(p3d.device)
    eye3 = torch.eye(3, dtype=p3d.dtype, device=p3d.device).expand(p3d.shape[0], 3, 3)
    eye6 = torch.eye(6, dtype=p3d.dtype, device=p3d.device)
    with true_f32():
        for _ in range(iters):
            p_cam = T.transform(p3d)
            uv, visible = camera.project(p_cam)
            r = (uv - p2d_ic) * weights[:, None]
            w = visible.to(p3d.dtype) * weights
            if robust_c_px > 0:
                e2 = ((uv - p2d_ic) ** 2).sum(-1)
                w = w / (1.0 + e2 / (robust_c_px**2))
            J = torch.einsum("nij,njk->nik", camera.project_jacobian(p_cam), torch.cat([-so3_hat(p_cam), eye3], -1))
            Jw = J * w[:, None, None]
            g = torch.einsum("nik,ni->k", Jw, r)
            H = torch.einsum("nik,nil->kl", Jw, J) + damping * eye6
            delta, info = torch.linalg.solve_ex(H, -g)
            delta = torch.where(torch.isfinite(delta) & (info == 0), delta, 0.0)
            T = T.retract(delta)
    return T


# ---------------------------------------------------------------------------
# The incremental mapper
# ---------------------------------------------------------------------------

def _normalize(camera: Camera, p2d_ic: np.ndarray) -> np.ndarray:
    return (p2d_ic - camera.c.cpu().numpy()) / camera.f.cpu().numpy()


def _chain_initialize(ids, matches, kp_n, f_mean, generator, verbose=False, device=None) -> Dict[int, Pose]:
    """Sequential chain initialisation for ordered captures (rings, videos):
    relative pose per strongest-neighbour pair, scales chained through shared
    tracks' depths. A complete, drifty but topologically correct pose set
    for global averaging and BA to polish."""
    dev = resolve(device)
    order = [ids[0]]
    left = set(ids[1:])
    while left:
        cur = order[-1]
        best, bn = None, -1
        for j in left:
            a, b = (cur, j) if cur < j else (j, cur)
            n = int((matches.get((a, b), np.asarray([-1])) >= 0).sum())
            if n > bn:
                bn, best = n, j
        if bn < 8:
            break
        order.append(best)
        left.discard(best)

    poses: Dict[int, Pose] = {order[0]: Pose.identity(device=dev)}
    prev_pts: Optional[Dict[int, float]] = None  # keypoint of the previous view -> depth
    scale = 1.0
    for a_i in range(len(order) - 1):
        i, j = order[a_i], order[a_i + 1]
        a, b = (i, j) if i < j else (j, i)
        m = matches[(a, b)]
        k0 = np.nonzero(m >= 0)[0]
        k1 = m[k0]
        if i > j:  # matches stored low -> high; flip to the i -> j direction
            k0, k1 = k1, k0
        T_ij, inl = estimate_relative_pose(kp_n[i][k0], kp_n[j][k1], generator, focal=f_mean, device=dev)
        _, z0, z1 = _triangulate_pair(T_ij.R, T_ij.t, torch.as_tensor(kp_n[i][k0], dtype=torch.float32).to(dev),
                                      torch.as_tensor(kp_n[j][k1], dtype=torch.float32).to(dev))
        z0, z1 = z0.cpu().numpy(), z1.cpu().numpy()
        ok = inl & (z0 > 0) & (z1 > 0)
        depth_i = {int(k): float(z) for k, z, o in zip(k0, z0, ok) if o}
        if prev_pts is not None:
            shared = [k for k in depth_i if k in prev_pts]
            if len(shared) >= 3:
                # global-scale depths of the same points in camera i over
                # this link's unit-baseline ones: the link's baseline scale
                scale = float(np.median([prev_pts[k] / depth_i[k] for k in shared]))
        T_scaled = Pose(T_ij.R, T_ij.t * torch.tensor(scale, dtype=torch.float32, device=dev))
        poses[j] = T_scaled @ poses[i]
        prev_pts = {int(kk): float(zz) * scale for kk, zz, o in zip(k1, z1, ok) if o}
        if verbose:
            print(f"chain {i}->{j}: {int(inl.sum())}/{len(k0)} inl, scale {scale:.3f}")
    return poses


def _verify_pairs(ids, images, kps, kp_n, descs, f_mean, generator, matcher=None, match_kw=None,
                  min_pair_inliers: int = 10, device=None) -> Dict[Tuple[int, int], np.ndarray]:
    """Match every pair and keep the matches consistent with the pair's
    essential matrix or homography (COLMAP's verification stage): {(i, j):
    j-keypoint per i-keypoint, -1 unmatched}. The correspondences are
    repeated cyclically up to a power of two, as the JAX package pads them;
    the draws index the padded arrays and the repeats count in the scores."""
    from pixtrack_tpu_torch.mapping.matcher import match_descriptors

    dev = resolve(device)
    matches = {}
    for a in range(len(ids)):
        for b in range(a + 1, len(ids)):
            i0, i1 = ids[a], ids[b]
            if matcher is not None:
                m0, _ = matcher(descs[i0], kps[i0], images[i0].shape[:2], descs[i1], kps[i1], images[i1].shape[:2])
            else:
                m0, _ = match_descriptors(descs[i0], descs[i1], **(match_kw or {}))
            m0 = _np(m0).copy()
            k0 = np.nonzero(m0 >= 0)[0]
            if len(k0) < min_pair_inliers:
                matches[(i0, i1)] = np.full_like(m0, -1)
                continue
            Nv = len(k0)
            Npad = 1 << int(np.ceil(np.log2(max(Nv, 32))))
            sel = np.resize(np.arange(Nv), Npad)
            pa = torch.as_tensor(np.asarray(kp_n[i0][k0][sel], np.float32)).to(dev)
            pb = torch.as_tensor(np.asarray(kp_n[i1][m0[k0]][sel], np.float32)).to(dev)
            # the union of epipolar- and homography-consistent matches: the
            # 8-point E is biased on shallow pairs; H catches the dominant plane
            _, inlE, _ = _essential_ransac(pa, pb, generator, n_hyp=2048, thresh=(3.0 / f_mean) ** 2)
            _, inlH, _ = _homography_ransac(pa, pb, generator, thresh=(3.0 / f_mean) ** 2)
            inl = (inlE | inlH)[:Nv].cpu().numpy()
            if inl.sum() < min_pair_inliers:
                m0[:] = -1
            else:
                m0[k0[~inl]] = -1
            matches[(i0, i1)] = m0
    return matches


def _structure_guided_matches(
    poses: Dict[int, Pose],
    camera: Camera,
    kps: Dict[int, np.ndarray],
    kp_ic: Dict[int, np.ndarray],
    descs: Dict[int, np.ndarray],
    tracks: List[List[Tuple[int, int]]],
    xyz_of_track: Dict[int, np.ndarray],
    radius_px: float = 6.0,
    min_desc_score: float = 0.75,
    vis_cone_deg: float = 55.0,
) -> Optional[Dict[Tuple[int, int], np.ndarray]]:
    """Pair matches synthesised from reconstructed structure (COLMAP's guided
    matching role): every triangulated track is projected into every
    registered view and snapped to a nearby detected keypoint, gated by
    descriptor similarity and a visibility cone around the views that
    observed the track; a match that would merge two tracks seen in one
    image is refused (a union-find simulated here). numpy on the host, the
    projections on the poses' device.

    Returns {(i, j): match array} over all registered pairs i < j, or None
    if there is no structure to guide with."""
    tids = sorted(xyz_of_track)
    if not tids:
        return None
    X = np.stack([xyz_of_track[t] for t in tids])  # (P, 3)
    trow = {t: r for r, t in enumerate(tids)}
    P = len(tids)
    reg = sorted(poses)
    dev = poses[reg[0]].R.device

    centers = {i: -(poses[i].R.cpu().numpy().T @ poses[i].t.cpu().numpy()) for i in reg}
    # per-track observing directions (unit vectors point -> camera centre)
    obs_dirs: List[List[np.ndarray]] = [[] for _ in range(P)]
    kp_of: Dict[int, Dict[int, int]] = {i: {} for i in reg}  # view -> row -> keypoint
    for t in tids:
        r = trow[t]
        for (im, k) in tracks[t]:
            if im in poses:
                d = centers[im] - X[r]
                obs_dirs[r].append(d / (np.linalg.norm(d) + 1e-12))
                kp_of[im][r] = k

    proj, vis = {}, {}
    Xt = torch.as_tensor(X, dtype=torch.float32).to(dev)
    for i in reg:
        uv, v = camera.to(dev).world2image(poses[i], Xt)
        proj[i] = uv.cpu().numpy()
        vis[i] = v.cpu().numpy()

    # union-find guard over (tracks + loose keypoints): guided matches merge
    # tracks downstream, and a merge of two tracks that share an image drops
    # the whole merged track
    parent: Dict[Tuple[str, int, int], Tuple[str, int, int]] = {}
    imgset: Dict[Tuple[str, int, int], set] = {}
    track_lookup: Dict[Tuple[int, int], int] = {}
    for t, tr in enumerate(tracks):  # all tracks, untriangulated ones too
        for obs in tr:
            track_lookup[obs] = t

    def node_of(im: int, k: int) -> Tuple[str, int, int]:
        t = track_lookup.get((im, k))
        return ("t", t, 0) if t is not None else ("k", im, k)

    def find(n):
        while parent.get(n, n) != n:
            parent[n] = parent.get(parent[n], parent[n])
            n = parent[n]
        return n

    def images_of(n):
        if n not in imgset:
            imgset[n] = {im for (im, _) in tracks[n[1]]} if n[0] == "t" else {n[1]}
        return imgset[n]

    def try_union(na, nb) -> bool:
        ra, rb = find(na), find(nb)
        if ra == rb:
            return True
        A, B = images_of(ra), images_of(rb)
        if A & B:
            return False
        parent[rb] = ra
        imgset[ra] = A | B
        imgset.pop(rb, None)
        return True

    cos_gate = np.cos(np.deg2rad(vis_cone_deg))
    # cone visibility of every track in every view (front-facing proxy: the
    # viewing direction close to some observing one)
    cone = {}
    for j in reg:
        dirs_j = centers[j][None, :] - X
        dirs_j /= np.linalg.norm(dirs_j, axis=-1, keepdims=True) + 1e-12
        ok = np.zeros(P, bool)
        for r in range(P):
            if obs_dirs[r]:
                ok[r] = (np.stack(obs_dirs[r]) @ dirs_j[r]).max() > cos_gate
        cone[j] = ok

    out: Dict[Tuple[int, int], np.ndarray] = {}
    for ai in range(len(reg)):
        for bi in range(ai + 1, len(reg)):
            i, j = reg[ai], reg[bi]
            rows = sorted(set(kp_of[i]) & set(np.nonzero(cone[j] & vis[j])[0]))
            m = np.full(len(kps[i]), -1, np.int64)
            if not rows:
                out[(i, j)] = m
                continue
            rows = np.asarray(rows)
            pj = proj[j][rows]
            d2 = ((pj[:, None, :] - kp_ic[j][None, :, :]) ** 2).sum(-1)  # (R, Kj)
            within = d2 <= radius_px * radius_px
            ki = np.asarray([kp_of[i][r] for r in rows])
            if descs.get(i) is not None and descs.get(j) is not None and len(descs[i]):
                score = descs[i][ki] @ descs[j].T  # (R, Kj) cosine
                score = np.where(within, score, -np.inf)
                best = np.argmax(score, axis=1)
                best_s = score[np.arange(len(rows)), best]
                keep = best_s > min_desc_score
            else:
                # no descriptors (bring-your-own keypoints): nearest within a
                # tighter radius
                d2g = np.where(within, d2, np.inf)
                best = np.argmin(d2g, axis=1)
                best_s = -d2g[np.arange(len(rows)), best]
                keep = best_s > -(radius_px / 2) ** 2
            # collisions (two tracks snapping to one j-keypoint): the highest
            # score wins; conflict-creating track merges are refused
            order = np.argsort(-best_s)
            taken: Dict[int, None] = {}
            for o in order:
                if not keep[o]:
                    continue
                kj = int(best[o])
                if kj in taken:
                    continue
                if not try_union(node_of(i, int(ki[o])), node_of(j, kj)):
                    continue
                taken[kj] = None
                m[ki[o]] = kj
            out[(i, j)] = m
    return out


def incremental_sfm(
    images: Dict[int, np.ndarray],
    camera_rec: colmap_io.CameraRecord,
    names: Optional[Dict[int, str]] = None,
    max_keypoints: int = 1024,
    seed: int = 0,
    min_pnp_points: int = 6,
    refine_every: int = 3,
    verbose: bool = False,
    match_kw: Optional[dict] = None,
    strategy: str = "chain",
    featuremetric_ka: bool = False,
    featuremetric_ba_rounds: int = 0,
    ka_extractor=None,
    keypoints: Optional[Dict[int, np.ndarray]] = None,
    pair_matches: Optional[Dict[Tuple[int, int], np.ndarray]] = None,
    descriptors: Optional[Dict[int, np.ndarray]] = None,
    init_poses: Optional[Dict[int, Pose]] = None,
    guided_rounds: int = 0,
    matcher=None,
    detector=None,
    device=None,
    **detect_kw,
) -> SceneModel:
    """Full unposed reconstruction -> SceneModel (arbitrary global scale, as
    any monocular SfM), on ``device`` (None is the CUDA card).

    ``strategy``: "chain" (default) initialises the poses through the
    strongest-neighbour chain, closes the loop by global rotation and
    translation averaging, and polishes with global BA; "pnp" is the
    classical init-pair + PnP-growing mapper (COLMAP-style), which needs
    deeper scenes.

    ``keypoints`` / ``pair_matches``: bring-your-own features (corner-
    convention keypoints per image, one match array per (i, j) pair with
    i < j, as hloc feeds COLMAP); detection, matching and verification are
    then skipped. ``descriptors`` optionally supplies per-image descriptors
    for guided re-matching. ``init_poses``: bring-your-own poses, kept (no
    chain or averaging).

    ``matcher``: a pair matcher ``(desc0, kp0, shape0, desc1, kp1, shape1) ->
    (matches0, scores0)``; mutual-NN + ratio by default. ``detector``: a
    ``detect(image, max_keypoints=..., **kw) -> (kp, scores, desc)``; the
    multi-scale Harris + patch descriptor by default.

    ``guided_rounds``: after the model converges, re-match every registered
    pair by projecting the structure (``_structure_guided_matches``),
    enrich the pair graph, rebuild the tracks and refine from the converged
    poses (a recursive call with ``seed + 1``)."""
    from pixtrack_tpu_torch.mapping.detector import detect_and_describe
    from pixtrack_tpu_torch.mapping.triangulate import build_tracks, triangulate_scene

    dev = resolve(device)
    camera = Camera.from_colmap(camera_rec.model, camera_rec.params, camera_rec.width, camera_rec.height, dev)
    f_mean = float(camera.f.cpu().numpy().mean())
    names = names or {iid: f"view_{iid:04d}.png" for iid in images}
    generator = torch.Generator().manual_seed(seed)

    # 1. features (corner-convention keypoints, as the COLMAP h5 layout)
    # descriptors stay where they were made (the detector's on the device)
    kps: Dict[int, np.ndarray] = {}
    descs: Dict[int, object] = {}
    if keypoints is not None:
        kps = {iid: np.asarray(kp, np.float64) for iid, kp in keypoints.items()}
        if descriptors is not None:
            descs = dict(descriptors)
    else:
        for iid, img in images.items():
            if detector is None:
                kp, _, desc = detect_and_describe(img, max_keypoints=max_keypoints, device=dev, **detect_kw)
            else:
                kp, _, desc = detector(img, max_keypoints=max_keypoints, **detect_kw)
            kps[iid] = _np(kp)
            descs[iid] = desc
    ids = sorted(images)
    kp_ic = {iid: kps[iid] - 0.5 for iid in kps}  # index-centred
    kp_n = {iid: _normalize(camera, kp_ic[iid]) for iid in kps}

    # 1b. two-view geometric verification of every pair
    if pair_matches is not None:
        matches = {(min(p), max(p)): np.asarray(m).copy() for p, m in pair_matches.items()}
    else:
        pair_descs = ({iid: _np(d) for iid, d in descs.items()} if matcher is not None
                      else {iid: torch.as_tensor(d).to(dev) for iid, d in descs.items()})
        matches = _verify_pairs(ids, images, kps, kp_n, pair_descs, f_mean, generator, matcher=matcher,
                                match_kw=match_kw, device=dev)

    # 1c. featuremetric keypoint adjustment (the pixsfm KA role): the
    # verified tracks made to agree in dense feature space before any
    # geometry is estimated
    if featuremetric_ka:
        from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
        from pixtrack_tpu_torch.mapping.featuremetric import keypoint_adjustment

        ka_tracks = build_tracks(kps, matches)
        if ka_tracks:
            if verbose:
                print(f"featuremetric KA over {len(ka_tracks)} tracks")
            extractor = ka_extractor or FeatureExtractor(HandcraftedExtractor(device=dev), resize=1024)
            kps = keypoint_adjustment(images, kps, ka_tracks, extractor)
            kp_ic = {iid: kps[iid] - 0.5 for iid in kps}
            kp_n = {iid: _normalize(camera, kp_ic[iid]) for iid in kps}

    # 2. initial poses
    pair_counts = {p: int((m >= 0).sum()) for p, m in matches.items()}
    (i0, i1) = max(pair_counts, key=pair_counts.get)
    if init_poses is not None:
        poses = dict(init_poses)
        i0 = next(iter(poses))
    elif strategy == "chain":
        poses = _chain_initialize(ids, matches, kp_n, f_mean, generator, verbose=verbose, device=dev)
        i0 = next(iter(poses))
        # loop closure by global averaging over the triangle-consistent pair
        # graph; None (a sparse graph) keeps the chain
        from pixtrack_tpu_torch.mapping.global_init import global_initialize

        g_poses = global_initialize(ids, matches, kp_n, f_mean, generator, chain_init=poses, verbose=verbose,
                                    device=dev)
        if g_poses is not None:
            poses = g_poses
            i0 = next(iter(poses))  # averaging may have peeled the anchor
            if verbose:
                print(f"global init: averaged {len(poses)} poses")
    else:
        m01 = matches[(i0, i1)]
        k0 = np.nonzero(m01 >= 0)[0]
        k1 = m01[k0]
        T01, inl = estimate_relative_pose(kp_n[i0][k0], kp_n[i1][k1], generator, focal=f_mean, device=dev)
        poses = {i0: Pose.identity(device=dev), i1: T01}
        if verbose:
            print(f"init pair ({i0},{i1}): {int(inl.sum())}/{len(k0)} inliers")

    # 3-5. register the remaining images against the growing point set
    tracks = build_tracks(kps, matches, min_track_length=2)
    track_of_obs: Dict[Tuple[int, int], int] = {}
    for ti, tr in enumerate(tracks):
        for obs in tr:
            track_of_obs[obs] = ti
    xyz_of_track: Dict[int, np.ndarray] = {}

    def triangulate_ready(registered: List[int]) -> None:
        """(Re-)triangulate every track with >= 2 registered observations,
        in one padded batch, behind a fixed 6 px reprojection gate."""
        from pixtrack_tpu_torch.mapping.triangulate import triangulate_tracks

        cand, cand_ids = [], []
        reg = set(registered)
        for ti, tr in enumerate(tracks):
            obs = [o for o in tr if o[0] in reg]
            if len(obs) >= 2:
                cand.append(obs)
                cand_ids.append(ti)
        if not cand:
            return
        xyz, kept, _ = triangulate_tracks(cand, kp_ic, {i: poses[i] for i in reg}, {1: camera}, {i: 1 for i in reg},
                                          max_reproj_error=6.0, device=dev)
        # kept tracks back to track ids by their first observation
        first_to_tid = {tuple(c[0]): tid for c, tid in zip(cand, cand_ids)}
        for t, p in zip(kept, xyz):
            tid = first_to_tid.get(tuple(t[0]))
            if tid is not None:
                xyz_of_track[tid] = p

    # seed triangulation from the init pair, or from every posed image when
    # the chain or the averaging dropped one of the pair
    seed_ids = [i for i in (i0, i1) if i in poses]
    triangulate_ready(seed_ids if len(seed_ids) == 2 else list(poses))

    def global_ba(ba_iters: int = 15) -> None:
        """Joint pose + structure BA over the current model (bundle.py); the
        observations padded with zero weight to a power of two, as the JAX
        package pads them."""
        from pixtrack_tpu_torch.mapping.bundle import bundle_adjust

        reg = [i0] + [i for i in poses if i != i0]  # gauge: i0 first
        row_of = {iid: k for k, iid in enumerate(reg)}
        tids = sorted(xyz_of_track)
        trow = {t: k for k, t in enumerate(tids)}
        if len(tids) < 8:
            return
        ci, pi, uvs = [], [], []
        for t in tids:
            for (im, k) in tracks[t]:
                if im in row_of:
                    ci.append(row_of[im])
                    pi.append(trow[t])
                    uvs.append(kp_ic[im][k])
        M = len(ci)
        Mp = 1 << int(np.ceil(np.log2(max(M, 64))))
        pad = Mp - M
        ci = np.asarray(ci + [0] * pad, np.int64)
        pi = np.asarray(pi + [0] * pad, np.int64)
        uvs = np.concatenate([np.stack(uvs), np.zeros((pad, 2))]).astype(np.float32)
        w = np.concatenate([np.ones(M), np.zeros(pad)]).astype(np.float32)
        pb = Pose(R=torch.stack([poses[i].R for i in reg]), t=torch.stack([poses[i].t for i in reg]))
        Xb = torch.as_tensor(np.stack([xyz_of_track[t] for t in tids]).astype(np.float32)).to(dev)
        pb2, Xb2 = bundle_adjust(pb, Xb, *(torch.as_tensor(a).to(dev) for a in (ci, pi, uvs, w)), camera,
                                 iters=ba_iters, robust_c_px=3.0)
        Xb2 = Xb2.cpu().numpy()
        for k, iid in enumerate(reg):
            poses[iid] = Pose(pb2.R[k], pb2.t[k])
        for t in tids:
            xyz_of_track[t] = Xb2[trow[t]]

    remaining = [i for i in ids if i not in poses]
    if init_poses is not None and len(poses) > 2:
        # bring-your-own poses only: iterate structure into the given poses
        for _ in range(2):
            triangulate_ready(list(poses))
            global_ba()
        triangulate_ready(list(poses))
        if verbose:
            print(f"init convergence: {len(xyz_of_track)} tracks triangulated over {len(poses)} init poses")
    rejected: Dict[int, int] = {}
    _EMPTY = np.asarray([-1])
    while remaining:
        # most 2D-3D correspondences first, recounted every round
        def support(iid):
            return sum(1 for k in range(len(kps[iid])) if track_of_obs.get((iid, k)) in xyz_of_track)

        remaining.sort(key=support, reverse=True)
        iid = remaining[0]
        obs3d, obs2dn, obs2dic = [], [], []
        for k in range(len(kps[iid])):
            tid = track_of_obs.get((iid, k))
            if tid in xyz_of_track:
                obs3d.append(xyz_of_track[tid])
                obs2dn.append(kp_n[iid][k])
                obs2dic.append(kp_ic[iid][k])
        if len(obs3d) < min_pnp_points:
            if verbose:
                print(f"stop: best remaining image {iid} has only {len(obs3d)} 2D-3D ({len(remaining)} unregistered)")
            break
        remaining.remove(iid)
        X = torch.as_tensor(np.stack(obs3d).astype(np.float32)).to(dev)
        uv_ic = torch.as_tensor(np.stack(obs2dic).astype(np.float32)).to(dev)
        ones = torch.ones(len(obs3d), device=dev)

        # registration A: robust GN from the most-connected registered
        # neighbour's pose (well-posed for coplanar point sets, where DLT-PnP
        # is degenerate)
        def shared(rid):
            a, b = (rid, iid) if rid < iid else (iid, rid)
            return int((matches.get((a, b), _EMPTY) >= 0).sum())

        neighbor = max(poses, key=shared)
        candidates_T = []
        if shared(neighbor) > 0:
            candidates_T.append(refine_pose_reprojection(poses[neighbor], X, uv_ic, ones, camera, iters=30,
                                                         robust_c_px=4.0))
        # registration B: DLT-6pt RANSAC (general-position sets)
        P, _, _ = _pnp_ransac(X, torch.as_tensor(np.stack(obs2dn).astype(np.float32)).to(dev), generator,
                              thresh=4.0 / f_mean)
        R, t = _orthogonalize(P)
        T_dlt = Pose.from_Rt(R.astype(np.float32), t.astype(np.float32), dev)
        candidates_T.append(refine_pose_reprojection(T_dlt, X, uv_ic, ones, camera, iters=15, robust_c_px=4.0))

        def inlier_count(T):
            uv, vis = camera.world2image(T, X)
            return int((vis & (torch.linalg.norm(uv - uv_ic, dim=-1) < 4.0)).sum())

        scores = [inlier_count(T) for T in candidates_T]
        bi = int(np.argmax(scores))
        T, score = candidates_T[bi], scores[bi]
        # acceptance gate: a registration the data does not support poisons
        # the model downstream
        if score < max(min_pnp_points, int(0.25 * len(obs3d))):
            if verbose:
                print(f"reject image {iid}: {score}/{len(obs3d)} inliers")
            rejected[iid] = rejected.get(iid, 0) + 1
            if rejected[iid] < 3:
                remaining.append(iid)  # retry once more structure exists
            continue
        poses[iid] = T
        if verbose:
            print(f"registered {iid}: {score}/{len(obs3d)} inliers "
                  f"({'GN' if bi == 0 and len(candidates_T) == 2 else 'DLT'})")
        triangulate_ready(list(poses))
        # periodic global BA (poses and structure jointly)
        if len(poses) % refine_every == 0:
            global_ba()
            triangulate_ready(list(poses))

    # final polish: BA, re-register every pose against the converged
    # structure, BA again
    global_ba(ba_iters=25)
    triangulate_ready(list(poses))

    def cull_observations() -> int:
        """Hard per-observation outlier culling (COLMAP's filter step): drop
        observations whose reprojection error exceeds max(3 x median, 1 px,
        the 80th percentile), dissolve tracks left with < 2 observations;
        the caller re-triangulates and re-runs BA. Returns the number of
        culled observations."""
        by_img: Dict[int, list] = {}
        for tid, Xp in xyz_of_track.items():
            for (im, k) in tracks[tid]:
                if im in poses:
                    by_img.setdefault(im, []).append((tid, k, Xp))
        errs_l, locs = [], []
        for im, obs in by_img.items():
            Xo = torch.as_tensor(np.stack([o[2] for o in obs]).astype(np.float32)).to(dev)
            uv, vis = camera.world2image(poses[im], Xo)
            p2 = np.stack([kp_ic[im][o[1]] for o in obs])
            e = np.linalg.norm(uv.cpu().numpy() - p2, axis=1)
            errs_l.append(np.where(vis.cpu().numpy(), e, 1e6))
            locs += [(tid, (im, k)) for (tid, k, _) in obs]
        if not errs_l:
            return 0
        errs = np.concatenate(errs_l)
        finite = errs[errs < 1e5]
        if finite.size == 0:  # every posed observation flagged invisible
            return 0
        # more than 30 % invisible: the model is globally broken (flipped
        # poses); leave it to the caller's quality gates
        if errs.size - finite.size > 0.3 * errs.size:
            if verbose:
                print(f"cull: skipped ({errs.size - finite.size}/{errs.size} invisible — model inconsistent)",
                      flush=True)
            return 0
        gate = max(3.0 * float(np.median(finite)), 1.0)
        # never cull more than the worst 20 % in one round
        gate = max(gate, float(np.quantile(finite, 0.8)))
        if verbose:
            print(f"cull: {errs.size} obs ({errs.size - finite.size} invisible), median "
                  f"{float(np.median(finite)):.2f} px, gate {gate:.2f} px", flush=True)
        n_cull = 0
        for e, (tid, obs) in zip(errs, locs):
            if e > gate and obs in tracks[tid]:
                tracks[tid] = [o for o in tracks[tid] if o != obs]
                track_of_obs.pop(obs, None)
                n_cull += 1
        for tid in list(xyz_of_track):
            if len([o for o in tracks[tid] if o[0] in poses]) < 2:
                xyz_of_track.pop(tid, None)
        return n_cull

    for _ in range(2):
        n = cull_observations()
        if n == 0:
            break
        triangulate_ready(list(poses))
        global_ba(ba_iters=15)
        if verbose:
            print(f"culled {n} observations; {len(xyz_of_track)} tracks live")
    n_snapped = 0
    for rid in list(poses):
        o3, o2 = [], []
        for k in range(len(kps[rid])):
            tid = track_of_obs.get((rid, k))
            if tid in xyz_of_track:
                o3.append(xyz_of_track[tid])
                o2.append(kp_ic[rid][k])
        if len(o3) >= min_pnp_points and rid != i0:
            Xr = torch.as_tensor(np.stack(o3).astype(np.float32)).to(dev)
            uv_obs = np.stack(o2)
            T_new = refine_pose_reprojection(poses[rid], Xr, torch.as_tensor(uv_obs.astype(np.float32)).to(dev),
                                             torch.ones(len(o3), device=dev), camera, iters=30, robust_c_px=3.0)

            # verified re-registration: robust GN against near-planar
            # structure has a two-fold (reflection) ambiguity; accept the
            # refined pose only if it does not worsen this image's median
            # reprojection error
            def med_err(T):
                uv, vis = camera.world2image(T, Xr)
                e = np.linalg.norm(uv.cpu().numpy() - uv_obs, axis=1)
                return float(np.median(np.where(vis.cpu().numpy(), e, 1e6)))

            if med_err(T_new) <= max(med_err(poses[rid]), 1e-6) * 1.5:
                poses[rid] = T_new
            else:
                n_snapped += 1
    if verbose:
        print(f"post-PnP-refine: {len(xyz_of_track)} tracks ({n_snapped} refinements rejected)", flush=True)
    triangulate_ready(list(poses))
    if verbose:
        print(f"post-retriangulate: {len(xyz_of_track)} tracks", flush=True)
    global_ba(ba_iters=25)
    triangulate_ready(list(poses))
    if verbose:
        print(f"post-BA25: {len(xyz_of_track)} tracks", flush=True)
    # one more cull round against the re-registered poses
    if cull_observations() > 0:
        triangulate_ready(list(poses))
        global_ba(ba_iters=15)
    if verbose:
        print(f"final polish: {len(xyz_of_track)} tracks with 3D points")

    # 5b. structure-guided re-matching: rebuild the model from the pair
    # graph the converged structure implies
    if guided_rounds > 0 and len(poses) >= 3 and xyz_of_track:
        gm = _structure_guided_matches(poses, camera, kps, kp_ic, {iid: _np(d) for iid, d in descs.items()}, tracks,
                                       xyz_of_track)
        if gm is not None:
            # enrich the appearance matches with the guided ones (guided wins
            # conflicts: it is structure-verified)
            n_old = sum(int((m >= 0).sum()) for m in matches.values())
            for p in set(matches) | set(gm):
                mo, mg = matches.get(p), gm.get(p)
                if mo is None or mg is None:
                    gm[p] = mg if mo is None else mo.copy()
                    continue
                m = mo.copy()
                taken = {int(v) for v in mg[mg >= 0]}
                old_idx = np.nonzero(m >= 0)[0]
                drop = [k for k in old_idx if int(m[k]) in taken]
                m[drop] = -1
                sel = mg >= 0
                m[sel] = mg[sel]
                gm[p] = m
            if verbose:
                n_new = sum(int((m >= 0).sum()) for m in gm.values())
                print(f"guided re-matching: {n_old} -> {n_new} matches over {len(gm)} pairs; rebuilding")
            return incremental_sfm(
                images, camera_rec, names=names, seed=seed + 1, min_pnp_points=min_pnp_points,
                refine_every=refine_every, verbose=verbose, strategy=strategy, featuremetric_ka=featuremetric_ka,
                featuremetric_ba_rounds=featuremetric_ba_rounds, ka_extractor=ka_extractor, keypoints=kps,
                pair_matches=gm, descriptors=descs if descs else None, init_poses=poses,
                guided_rounds=guided_rounds - 1, device=dev,
            )

    # 6. final assembly through the shared triangulator
    image_meta = {}
    for iid, T in poses.items():
        q, t = T.to_quat_t()
        image_meta[iid] = {"name": names[iid], "qvec": q.cpu().numpy(), "tvec": t.cpu().numpy(),
                           "camera_id": camera_rec.camera_id}
    reg_matches = {p: m for p, m in matches.items() if p[0] in poses and p[1] in poses}
    rec = triangulate_scene(image_meta, kps, reg_matches, {camera_rec.camera_id: camera_rec}, device=dev)
    if featuremetric_ba_rounds > 0 and len(rec.images) >= 3:
        # final featuremetric polish (the pixsfm featuremetric-BA role)
        from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
        from pixtrack_tpu_torch.mapping.featuremetric import featuremetric_ba

        extractor = ka_extractor or FeatureExtractor(HandcraftedExtractor(device=dev), resize=1024)
        if verbose:
            print(f"featuremetric BA: {featuremetric_ba_rounds} round(s)")
        rec = featuremetric_ba(rec, images, extractor, rounds=featuremetric_ba_rounds)
    return rec
