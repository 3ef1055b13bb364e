"""Binary mask morphology and the point-splat object mask on device.

Port of ``erode``, ``dilate``, ``depth_to_object_mask`` and
``splat_object_mask`` from ``pixtrack_tpu/tracking/mask.py``. Like ``reduce_window`` with SAME
padding, erosion pads with 1 and dilation with 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pool(mask: torch.Tensor, size: int, pad_value: float, sign: float) -> torch.Tensor:
    """Max (sign 1) or min (sign -1) over a size x size window of (..., H, W)."""
    lo = (size - 1) // 2
    x = F.pad(mask.reshape(-1, 1, *mask.shape[-2:]), (lo, size - 1 - lo, lo, size - 1 - lo), value=pad_value)
    return (sign * F.max_pool2d(sign * x, size, stride=1)).reshape(mask.shape)


def erode(mask: torch.Tensor, size: int = 5, iterations: int = 1) -> torch.Tensor:
    for _ in range(iterations):
        mask = _pool(mask, size, 1.0, -1.0)
    return mask


def dilate(mask: torch.Tensor, size: int = 5, iterations: int = 1) -> torch.Tensor:
    for _ in range(iterations):
        mask = _pool(mask, size, 0.0, 1.0)
    return mask


def depth_to_object_mask(depth: torch.Tensor, size: int = 5, erode_iters: int = 1,
                         dilate_iters: int = 5) -> torch.Tensor:
    """(H, W) depth -> float32 {0, 1} object mask: depth != 0, eroded,
    then dilated (the reference tracker's get_mask)."""
    m = (depth != 0).float()
    m = erode(m, size, erode_iters)
    return dilate(m, size, dilate_iters)


def splat_object_mask(
    T_w2c, camera, p3d: torch.Tensor, shape, close_size: int = 7,
    dilate_iters: int = 2, down: int = 4,
) -> torch.Tensor:
    """Object mask from the SfM cloud: project the points, scatter-max them
    into a ``down``-scaled buffer, close (dilate then erode), dilate, and
    upsample by repetition. Returns float32 {0, 1} of ``shape``; for a batch
    of poses (B,) one mask per pose, (B, H, W), each scattered into its own
    block of one flat buffer."""
    H, W = shape
    h, w = H // down, W // down
    p2d, visible = camera.world2image(T_w2c, p3d)
    ij = torch.round(p2d / down).to(torch.int64)
    inb = visible & (ij[..., 0] >= 0) & (ij[..., 0] < w) & (ij[..., 1] >= 0) & (ij[..., 1] < h)
    ij = torch.where(inb[..., None], ij, 0)
    lead = tuple(inb.shape[:-1])
    idx = ij[..., 1] * w + ij[..., 0]
    if lead:
        idx = idx + torch.arange(idx.shape[0], device=idx.device)[:, None] * (h * w)
    flat = torch.zeros(idx.shape[0] * h * w if lead else h * w, dtype=torch.float32, device=p3d.device)
    flat = flat.scatter_reduce(0, idx.reshape(-1), inb.float().reshape(-1), reduce="amax")
    m = flat.reshape(*lead, h, w)
    m = dilate(m, close_size, 1)
    m = erode(m, close_size, 1)
    m = dilate(m, close_size, dilate_iters)
    m = m.repeat_interleave(down, dim=-2).repeat_interleave(down, dim=-1)
    return m[..., :H, :W]
