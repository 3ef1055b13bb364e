"""Pose-tracking evaluation metrics.

The ADD / ADD-S errors and their threshold-curve AUC, copied from
``pixtrack_tpu/eval/metrics.py`` (the parts the port uses).
"""

from __future__ import annotations

from typing import Sequence

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


# -------------------------------------------------------------- summaries ----
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
