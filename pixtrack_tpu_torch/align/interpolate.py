"""Bilinear feature interpolation with analytic spatial gradients.

Port of ``pixtrack_tpu/align/interpolate.py``. Coordinates are index-centred
(x = column, y = row). The corner-packed pair (``pack_fmap``,
``interpolate_packed``) fetches one wide row per point where
``interpolate_features`` fetches four narrow ones; both give the same
numbers, and the LM uses the four-gather form.
"""

from __future__ import annotations

from typing import Tuple

import torch


def interpolate_features(
    fmap: torch.Tensor, pts: torch.Tensor, compute_grad: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample ``fmap`` (H, W, C) at ``pts`` (..., N, 2) xy.

    Returns values (..., N, C), grads (..., N, C, 2) (zeros without
    compute_grad) and valid (..., N): all four neighbours inside the map.
    A batch of maps (B, H, W, C) is sampled at pts (B, ..., N, 2), each map
    at its own points."""
    *batch, H, W, C = fmap.shape
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    base, valid = _corner_index(x0, y0, H, W)
    if batch:
        (B,) = batch
        base = base + (torch.arange(B, device=base.device) * (H * W)).reshape(B, *[1] * (base.ndim - 1))
    flat = fmap.reshape(-1, C)
    f00, f01 = flat[base], flat[base + 1]
    f10, f11 = flat[base + W], flat[base + W + 1]
    return (*_blend(f00, f01, f10, f11, fx, fy, compute_grad), valid)


def _corner_index(x0, y0, H: int, W: int):
    """Flat index of the top-left texel (clamped into the map) and whether
    all four neighbours lie inside it."""
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    valid = (x0i >= 0) & (x0i + 1 <= W - 1) & (y0i >= 0) & (y0i + 1 <= H - 1)
    return y0i.clamp(0, H - 2) * W + x0i.clamp(0, W - 2), valid


def _blend(f00, f01, f10, f11, fx, fy, compute_grad: bool):
    """Bilinear values (N, C) and gradients (N, C, 2) from the four corners."""
    wx0, wx1 = (1.0 - fx)[..., None], fx[..., None]
    wy0, wy1 = (1.0 - fy)[..., None], fy[..., None]
    values = (f00 * wx0 + f01 * wx1) * wy0 + (f10 * wx0 + f11 * wx1) * wy1
    if compute_grad:
        gx = (f01 - f00) * wy0 + (f11 - f10) * wy1
        gy = (f10 - f00) * wx0 + (f11 - f01) * wx1
        grads = torch.stack([gx, gy], dim=-1)
    else:
        grads = torch.zeros((*values.shape, 2), dtype=values.dtype, device=values.device)
    return values, grads


def interpolate_scalar(fmap: torch.Tensor, pts: torch.Tensor):
    """Sample a scalar map (H, W), or a batch (B, H, W), at pts as
    :func:`interpolate_features`; returns (values, valid)."""
    v, _, valid = interpolate_features(fmap[..., None], pts, compute_grad=False)
    return v[..., 0], valid


def pack_fmap(fmap: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> corner-packed (H, W, 4C): the channel blocks are the four
    bilinear corners [f(y,x), f(y,x+1), f(y+1,x), f(y+1,x+1)]; edge rows and
    columns repeat (corners outside the map are masked by ``valid`` anyway)."""
    f01 = torch.cat([fmap[:, 1:], fmap[:, -1:]], dim=1)
    f10 = torch.cat([fmap[1:], fmap[-1:]], dim=0)
    f11 = torch.cat([f10[:, 1:], f10[:, -1:]], dim=1)
    return torch.cat([fmap, f01, f10, f11], dim=-1)


def interpolate_packed(
    packed: torch.Tensor, pts: torch.Tensor, compute_grad: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bilinear sampling from a ``pack_fmap`` result, one gather per point.
    Same returns as :func:`interpolate_features`."""
    H, W, C4 = packed.shape
    C = C4 // 4
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    base, valid = _corner_index(x0, y0, H, W)
    rows = packed.reshape(H * W, C4)[base]
    f00, f01, f10, f11 = (rows[..., k * C : (k + 1) * C] for k in range(4))
    return (*_blend(f00, f01, f10, f11, x - x0, y - y0, compute_grad), valid)
