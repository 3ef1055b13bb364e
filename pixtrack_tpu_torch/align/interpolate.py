"""Bilinear feature interpolation with analytic spatial gradients.

Port of ``interpolate_features`` and ``interpolate_scalar`` from
``pixtrack_tpu/align/interpolate.py``. Coordinates are index-centred
(x = column, y = row). The JAX package's corner-packed maps exist to cut
TPU gathers; the four-gather form here gives the same numbers.
"""

from __future__ import annotations

from typing import Tuple

import torch


def interpolate_features(
    fmap: torch.Tensor, pts: torch.Tensor, compute_grad: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample ``fmap`` (H, W, C) at ``pts`` (N, 2) xy.

    Returns values (N, C), grads (N, C, 2) (zeros without compute_grad) and
    valid (N,): all four neighbours inside the map."""
    H, W, C = fmap.shape
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    valid = (x0i >= 0) & (x0i + 1 <= W - 1) & (y0i >= 0) & (y0i + 1 <= H - 1)
    base = y0i.clamp(0, H - 2) * W + x0i.clamp(0, W - 2)
    flat = fmap.reshape(H * W, C)
    f00, f01 = flat[base], flat[base + 1]
    f10, f11 = flat[base + W], flat[base + W + 1]
    wx0, wx1 = (1.0 - fx)[..., None], fx[..., None]
    wy0, wy1 = (1.0 - fy)[..., None], fy[..., None]
    values = (f00 * wx0 + f01 * wx1) * wy0 + (f10 * wx0 + f11 * wx1) * wy1
    if compute_grad:
        gx = (f01 - f00) * wy0 + (f11 - f10) * wy1
        gy = (f10 - f00) * wx0 + (f11 - f01) * wx1
        grads = torch.stack([gx, gy], dim=-1)
    else:
        grads = torch.zeros((*values.shape, 2), dtype=values.dtype, device=values.device)
    return values, grads, valid


def interpolate_scalar(fmap: torch.Tensor, pts: torch.Tensor):
    """Sample a scalar map (H, W) at pts (N, 2); returns (values, valid)."""
    v, _, valid = interpolate_features(fmap[..., None], pts, compute_grad=False)
    return v[..., 0], valid
