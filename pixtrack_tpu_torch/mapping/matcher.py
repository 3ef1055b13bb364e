"""Descriptor matching: mutual nearest neighbours with a ratio test.

Port of ``pixtrack_tpu/mapping/matcher.py``. The similarity and its argmax
run on the descriptors' device in true f32 (the JAX package's
``Precision.HIGHEST``); only the four match vectors come back to the host,
where the ratio test runs in numpy as in the JAX package. ``argmax`` ties
resolve to the first index in both packages.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch._device import true_f32


def _match(desc0: torch.Tensor, desc1: torch.Tensor):
    with true_f32():
        sim = desc0 @ desc1.T  # cosine similarity (descriptors are L2-normalised)
    best1 = sim.argmax(dim=1)
    best0 = sim.argmax(dim=0)
    s_best = sim.amax(dim=1)
    rows = torch.arange(sim.shape[0], device=sim.device)
    masked = sim.index_put((rows, best1), torch.tensor(-torch.inf, device=sim.device))  # out of place
    s_second = masked.amax(dim=1)
    mutual = best0[best1] == rows
    return (t.cpu().numpy() for t in (best1, s_best, s_second, mutual))


def _ratio_test(best1, s_best, s_second, mutual, min_score: float, ratio: float):
    # ratio in distance space: d^2 = 2 - 2 s  ->  require d_best < r * d_second
    d_best = np.sqrt(np.maximum(2.0 - 2.0 * s_best, 0.0))
    d_second = np.sqrt(np.maximum(2.0 - 2.0 * s_second, 1e-12))
    ok = mutual & (s_best >= min_score) & (d_best < ratio * d_second)
    return np.where(ok, best1, -1).astype(np.int32), np.where(ok, s_best, 0.0).astype(np.float32)


def match_descriptors(desc0, desc1, min_score: float = 0.6, ratio: float = 0.95) -> Tuple[np.ndarray, np.ndarray]:
    """Match desc0 -> desc1 (tensors on one device, or arrays: the CPU).

    Returns (matches0 (N0,) int32 with -1 for unmatched, scores0 (N0,)):
    kept iff mutual nearest neighbours, similarity >= min_score, and the
    distance ratio to the second best passes."""
    if len(desc0) == 0 or len(desc1) == 0:
        return np.full(len(desc0), -1, np.int32), np.zeros(len(desc0), np.float32)
    d0 = torch.as_tensor(desc0, dtype=torch.float32)
    d1 = torch.as_tensor(desc1, dtype=torch.float32)
    return _ratio_test(*_match(d0, d1), min_score, ratio)


def match_descriptors_gated(desc0, desc1, gate0, gate1, gate_threshold: float = 0.5, min_score: float = 0.6,
                            ratio: float = 0.95) -> Tuple[np.ndarray, np.ndarray]:
    """Two-stage matching (numpy, as in the JAX package): candidates whose
    coarse (gate) similarity is under ``gate_threshold`` are vetoed, then
    mutual NN + ratio on the fine descriptor among the survivors."""
    if len(desc0) == 0 or len(desc1) == 0:
        return np.full(len(desc0), -1, np.int32), np.zeros(len(desc0), np.float32)
    sim_g = np.asarray(gate0, np.float32) @ np.asarray(gate1, np.float32).T
    sim_p = np.asarray(desc0, np.float32) @ np.asarray(desc1, np.float32).T
    sim = np.where(sim_g >= gate_threshold, sim_p, -1.0)
    best1 = sim.argmax(1)
    masked = sim.copy()
    masked[np.arange(len(sim)), best1] = -np.inf
    mutual = sim.argmax(0)[best1] == np.arange(len(desc0))
    return _ratio_test(best1, sim.max(1), masked.max(1), mutual, min_score, ratio)


def exhaustive_pairs(names: Sequence[str]) -> List[Tuple[str, str]]:
    """All unordered pairs (hloc pairs_from_exhaustive role)."""
    return list(itertools.combinations(names, 2))


def epipolar_filter(kp0: np.ndarray, kp1: np.ndarray, matches0: np.ndarray, K0: np.ndarray, K1: np.ndarray,
                    R01: np.ndarray, t01: np.ndarray, threshold_px: float = 3.0) -> np.ndarray:
    """Geometric verification against a known relative pose (numpy, f64).

    R01, t01: pose of cam1 relative to cam0 (x1 = R01 x0 + t01). Returns
    matches0 with the matches whose symmetric epipolar distance is not under
    ``threshold_px`` set to -1."""
    idx0 = np.nonzero(matches0 >= 0)[0]
    if len(idx0) == 0:
        return matches0
    idx1 = matches0[idx0]
    tx = np.array([[0, -t01[2], t01[1]], [t01[2], 0, -t01[0]], [-t01[1], t01[0], 0]])
    E = tx @ R01
    F = np.linalg.inv(K1).T @ E @ np.linalg.inv(K0)
    x0 = np.concatenate([kp0[idx0], np.ones((len(idx0), 1))], axis=1)
    x1 = np.concatenate([kp1[idx1], np.ones((len(idx1), 1))], axis=1)
    Fx0 = x0 @ F.T  # lines in image 1
    Ftx1 = x1 @ F  # lines in image 0
    num = np.abs(np.sum(x1 * Fx0, axis=1))
    d1 = num / np.linalg.norm(Fx0[:, :2], axis=1).clip(1e-9)
    d0 = num / np.linalg.norm(Ftx1[:, :2], axis=1).clip(1e-9)
    ok = np.maximum(d0, d1) < threshold_px
    out = matches0.copy()
    out[idx0[~ok]] = -1
    return out
