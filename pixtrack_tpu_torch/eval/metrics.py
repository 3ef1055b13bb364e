"""Pose-tracking evaluation metrics.

A copy of ``pixtrack_tpu/eval/metrics.py`` (numpy): ADD-style mean per-vertex
error, symmetric ADD-S, Umeyama similarity alignment of a trajectory,
translation/rotation errors, threshold accuracies (5cm/5deg, 3cm/3deg), the
YCB per-frame success gate (t < 10 cm AND r < 10 deg), and ADD/ADD-S AUC as
used in the YCB-Video literature.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


# ------------------------------------------------------------------ ADD ----
def add_error(R_est, t_est, R_gt, t_gt, points: np.ndarray) -> float:
    """ADD: mean L2 distance between model points under the two poses."""
    p_est = points @ np.asarray(R_est).T + np.asarray(t_est)
    p_gt = points @ np.asarray(R_gt).T + np.asarray(t_gt)
    return float(np.linalg.norm(p_est - p_gt, axis=1).mean())


def add_s_error(R_est, t_est, R_gt, t_gt, points: np.ndarray) -> float:
    """ADD-S: symmetric variant — nearest-neighbor distance (for objects
    with symmetries). O(N^2) pairwise; use a subsample for large models."""
    p_est = points @ np.asarray(R_est).T + np.asarray(t_est)
    p_gt = points @ np.asarray(R_gt).T + np.asarray(t_gt)
    # chunked nearest-neighbor to bound memory
    dists = np.empty(len(p_gt))
    chunk = 2048
    for i in range(0, len(p_gt), chunk):
        d = np.linalg.norm(
            p_gt[i : i + chunk, None, :] - p_est[None, :, :], axis=-1
        )
        dists[i : i + chunk] = d.min(axis=1)
    return float(dists.mean())


# ------------------------------------------------------ pose-pair errors ----
def pose_errors(R_est, t_est, R_gt, t_gt) -> Tuple[float, float]:
    """(rotation error degrees, translation error) between two poses."""
    Rd = np.asarray(R_est) @ np.asarray(R_gt).T
    cos = np.clip((np.trace(Rd) - 1.0) / 2.0, -1.0, 1.0)
    r_err = float(np.degrees(np.arccos(cos)))
    t_err = float(np.linalg.norm(np.asarray(t_est) - np.asarray(t_gt)))
    return r_err, t_err


# ------------------------------------------------------------- alignment ----
def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity aligning src -> dst: returns (s, R, t) with
    dst ~ s * R @ src + t. Standard Umeyama closed form (the trajectory
    alignment GetMetrics applies before computing ADD)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


# -------------------------------------------------------------- summaries ----
def threshold_accuracy(
    errors_t: Sequence[float],
    errors_r: Sequence[float],
    t_thresh: float,
    r_thresh_deg: float,
) -> float:
    """Fraction of frames with t error < t_thresh AND r error < r_thresh."""
    et = np.asarray(errors_t)
    er = np.asarray(errors_r)
    return float(((et < t_thresh) & (er < r_thresh_deg)).mean())


def auc_of_threshold_curve(errors: Sequence[float], max_threshold: float) -> float:
    """Area under the accuracy-vs-threshold curve, normalized to [0, 1]
    (the ADD/ADD-S AUC convention: errors above max count as max)."""
    e = np.sort(np.minimum(np.asarray(errors, np.float64), max_threshold))
    n = len(e)
    if n == 0:
        return 0.0
    # accuracy(t) = #(e < t)/n; integrate over [0, max]
    acc = np.arange(1, n + 1) / n
    # rectangle integration between successive error values
    widths = np.diff(np.concatenate([e, [max_threshold]]))
    area = float(np.sum(acc * widths))
    return area / max_threshold


def evaluate_trajectory(
    est_poses: Sequence[Tuple[np.ndarray, np.ndarray]],
    gt_poses: Sequence[Tuple[np.ndarray, np.ndarray]],
    model_points: Optional[np.ndarray] = None,
    align: bool = False,
    add_auc_threshold: Optional[float] = None,
) -> Dict[str, float]:
    """Full trajectory evaluation.

    est_poses / gt_poses: sequences of (R world-to-camera, t).
    Returns mean/median errors, 5cm5deg + 3cm3deg accuracies, the YCB
    10cm/10deg success rate, and (with model_points) mean ADD / ADD-S and
    their AUCs.
    """
    assert len(est_poses) == len(gt_poses)
    if align and len(est_poses) >= 3:
        # align estimated camera centers onto GT centers
        c_est = np.stack([-np.asarray(R).T @ np.asarray(t) for R, t in est_poses])
        c_gt = np.stack([-np.asarray(R).T @ np.asarray(t) for R, t in gt_poses])
        s, Ra, ta = umeyama_alignment(c_est, c_gt)
        aligned = []
        for R, t in est_poses:
            Rw = np.asarray(R) @ Ra.T
            c = s * Ra @ (-np.asarray(R).T @ np.asarray(t)) + ta
            aligned.append((Rw, -Rw @ c))
        est_poses = aligned

    errs_r, errs_t, adds, add_ss = [], [], [], []
    for (Re, te), (Rg, tg) in zip(est_poses, gt_poses):
        r, t = pose_errors(Re, te, Rg, tg)
        errs_r.append(r)
        errs_t.append(t)
        if model_points is not None:
            adds.append(add_error(Re, te, Rg, tg, model_points))
            add_ss.append(add_s_error(Re, te, Rg, tg, model_points))

    out = {
        "mean_r_deg": float(np.mean(errs_r)),
        "median_r_deg": float(np.median(errs_r)),
        "mean_t": float(np.mean(errs_t)),
        "median_t": float(np.median(errs_t)),
        "acc_5cm5deg": threshold_accuracy(errs_t, errs_r, 0.05, 5.0),
        "acc_3cm3deg": threshold_accuracy(errs_t, errs_r, 0.03, 3.0),
        "success_10cm10deg": threshold_accuracy(errs_t, errs_r, 0.10, 10.0),
        "n_frames": len(errs_r),
    }
    if model_points is not None:
        out["mean_add"] = float(np.mean(adds))
        out["mean_add_s"] = float(np.mean(add_ss))
        if add_auc_threshold:
            out["add_auc"] = auc_of_threshold_curve(adds, add_auc_threshold)
            out["add_s_auc"] = auc_of_threshold_curve(add_ss, add_auc_threshold)
    return out
