"""Per-3D-point reference descriptors from a reference view.

Port of ``observe_points``, ``aggregate_observations`` and
``build_level_data`` from ``pixtrack_tpu/align/observations.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from pixtrack_tpu_torch._device import true_f32
from pixtrack_tpu_torch.align.interpolate import interpolate_features, interpolate_scalar
from pixtrack_tpu_torch.features.pyramid import FeaturePyramid
from pixtrack_tpu_torch.geometry import Camera, Pose


def _scale_tensor(sxy, device) -> torch.Tensor:
    """A level's (sx, sy) as an f32 tensor made on ``device`` (fill kernels:
    no copy from the host, so a CUDA graph can capture it)."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device) for v in sxy])


def observe_points(
    pyramid: FeaturePyramid, T_w2c: Pose, camera: Camera, p3d: torch.Tensor,
    mask: Optional[torch.Tensor] = None, conf_floor: float = 0.2,
):
    """Per-level (features (N, C_l), weights (N,), valids (N,)) of world
    points seen in one view; confidences are floored at ``conf_floor``.
    Batched views: a pyramid of (B, H, W, C) maps, poses (B,), points (B,
    N, 3) give (B, N, ...)."""
    p2d_img, visible = camera.project(T_w2c.transform(p3d))
    if mask is not None:
        visible = visible & mask
    feats, weights, valids = [], [], []
    for lvl in range(pyramid.num_levels):
        scale = _scale_tensor(pyramid.scales[lvl], p3d.device)
        p2d = p2d_img * scale
        f, _, inmap = interpolate_features(pyramid.levels[lvl], p2d, compute_grad=False)
        valid = visible & inmap
        if pyramid.confidences is not None:
            w, _ = interpolate_scalar(pyramid.confidences[lvl], p2d)
            w = conf_floor + (1.0 - conf_floor) * w.clamp(0.0, 1.0)
        else:
            w = torch.ones_like(valid, dtype=torch.float32)
        feats.append(torch.where(valid[..., None], f, 0.0))
        weights.append(torch.where(valid, w, 0.0))
        valids.append(valid)
    return tuple(feats), tuple(weights), tuple(valids)


def aggregate_observations(feats_views: torch.Tensor, weights_views: torch.Tensor, valids_views: torch.Tensor):
    """Weighted mean of multi-view observations per point. Args are stacked
    over a leading views axis: (V, N, C), (V, N), (V, N). Returns
    (f (N, C), w (N,), valid (N,))."""
    wv = torch.where(valids_views, weights_views, 0.0)
    den = wv.sum(0).clamp_min(1e-8)
    with true_f32():
        f = torch.einsum("vn,vnc->nc", wv, feats_views) / den[:, None]
    valid = valids_views.any(0)
    w = den / valids_views.sum(0).clamp_min(1)
    return f, w, valid


def build_level_data(pyramid_query: FeaturePyramid, f_ref, w_ref, valid_ref, p3d, mask):
    """Per-level ``LevelData`` for ``align_pyramid``, fine -> coarse."""
    from pixtrack_tpu_torch.align.lm import LevelData

    levels = []
    for lvl in range(pyramid_query.num_levels):
        conf = pyramid_query.confidences[lvl] if pyramid_query.confidences is not None else None
        levels.append(
            LevelData(
                p3d=p3d, f_ref=f_ref[lvl], w_ref=w_ref[lvl], mask=mask & valid_ref[lvl],
                fmap=pyramid_query.levels[lvl], conf=conf,
                scale=_scale_tensor(pyramid_query.scales[lvl], p3d.device),
            )
        )
    return tuple(levels)
