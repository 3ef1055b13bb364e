"""Keypoint detection and description on tensors, on the device.

Port of ``pixtrack_tpu/mapping/detector.py``: a weight-free Harris detector
(per colour channel, combined by max), max-pool non-maximum suppression,
border kill, the ``max_keypoints`` best responses, a 3x3 quadratic
sub-pixel step on the raw response and a relative threshold; and a
13 x 13 x (colour + gradient) patch descriptor sampled bilinearly,
mean-centred and L2-normalised.

Everything runs on the image's device in true f32 (``_device.true_f32``:
cuDNN would otherwise run the blurs' convolutions in TF32 on the card). The
best responses are taken by a stable descending sort, so equal scores come
lowest index first, as ``lax.top_k`` gives them; the keypoint order fixes
the match indices, the tracks and the point ids downstream.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve, true_f32
from pixtrack_tpu_torch.align.interpolate import interpolate_features
from pixtrack_tpu_torch.features.handcrafted import _gradient, gaussian_blur


def _as_image(image, device) -> torch.Tensor:
    """uint8 or float (H, W[, C]) -> f32 in [0, 1] on ``device``."""
    img = torch.as_tensor(np.asarray(image) if not isinstance(image, torch.Tensor) else image).to(device)
    if img.dtype == torch.uint8:
        # a true division, as the JAX package's (outside jit); a Python
        # divisor would be a reciprocal multiply on the card
        return img.float() / torch.tensor(255.0, device=device)
    return img.float()


def _to_gray(image: torch.Tensor) -> torch.Tensor:
    if image.ndim == 3:
        return image @ torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype, device=image.device)
    return image


def harris_response(gray: torch.Tensor, sigma: float = 1.5, k: float = 0.04) -> torch.Tensor:
    """Harris corner response of an (H, W) image."""
    g = gaussian_blur(gray, 1.0)
    ix, iy = _gradient(g, 1), _gradient(g, 0)
    ixx = gaussian_blur(ix * ix, sigma)
    iyy = gaussian_blur(iy * iy, sigma)
    ixy = gaussian_blur(ix * iy, sigma)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def _nms(resp: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep local maxima: the response equals its max-pool (-inf padding)."""
    pooled = F.max_pool2d(resp[None, None], 2 * radius + 1, stride=1, padding=radius)[0, 0]
    return torch.where(resp >= pooled, resp, torch.full_like(resp, -torch.inf))


def _detect(img: torch.Tensor, max_keypoints: int, nms_radius: int, border: int):
    if img.ndim == 3:
        resp = torch.stack([harris_response(img[..., c]) for c in range(img.shape[-1])]).amax(dim=0)
    else:
        resp = harris_response(img)
    H, W = resp.shape
    resp_raw = resp
    resp = _nms(resp, nms_radius)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inside = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    resp = torch.where(inside, resp, torch.full_like(resp, -torch.inf))
    # top-k with ties broken lowest index first (lax.top_k's order)
    scores, idx = torch.sort(resp.reshape(-1), descending=True, stable=True)
    scores, idx = scores[:max_keypoints], idx[:max_keypoints]
    px, py = idx % W, idx // W
    kp = torch.stack([px, py], dim=-1).float()  # (x, y)

    # sub-pixel step: quadratic fit of the raw response over the 3x3
    # neighbourhood of each peak
    raw = resp_raw.reshape(-1)

    def at(dy, dx):
        return raw[(idx + dy * W + dx).clamp(0, H * W - 1)]

    gx = 0.5 * (at(0, 1) - at(0, -1))
    gy = 0.5 * (at(1, 0) - at(-1, 0))
    hxx = at(0, 1) - 2.0 * at(0, 0) + at(0, -1)
    hyy = at(1, 0) - 2.0 * at(0, 0) + at(-1, 0)
    hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
    det = hxx * hyy - hxy * hxy
    safe = det.abs() > 1e-18
    det = torch.where(safe, det, torch.ones_like(det))
    dx = -(hyy * gx - hxy * gy) / det
    dy = -(hxx * gy - hxy * gx) / det
    # flat-index clipping wraps the dx = +-1 reads of border peaks into the
    # next row: no refinement there
    interior = (px > 0) & (px < W - 1) & (py > 0) & (py < H - 1)
    ok = safe & interior & (dx.abs() < 1.0) & (dy.abs() < 1.0)
    zero = torch.zeros_like(dx)
    off = torch.stack([torch.where(ok, dx, zero), torch.where(ok, dy, zero)], dim=-1)
    kp = kp + off.clamp(-0.6, 0.6)

    # relative threshold: corners within 7 orders of magnitude of the best
    best = torch.clamp(scores[0], min=1e-12)
    valid = torch.isfinite(scores) & (scores > 1e-7 * best)
    return kp, scores, valid


def detect_keypoints(image, max_keypoints: int = 1024, nms_radius: int = 4, border: int = 12,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corners of an image (uint8, or float in [0, 1]; (H, W) or (H, W, C)),
    on ``device`` (None is the CUDA card): keypoints (N, 2) f32 xy,
    index-centred, and scores (N,), best first."""
    dev = resolve(device)
    with true_f32():
        kp, scores, valid = _detect(_as_image(image, dev), max_keypoints, nms_radius, border)
    return kp[valid], scores[valid]


def _describe(img: torch.Tensor, kp: torch.Tensor, patch: int, spacing: float) -> torch.Tensor:
    gray = _to_gray(img)
    g = gaussian_blur(gray, 1.2)
    chans = [_gradient(g, 1) * 4.0, _gradient(g, 0) * 4.0]
    if img.ndim == 3:
        blurred = gaussian_blur(img, 1.2)
        chans = [blurred[..., c] for c in range(img.shape[-1])] + chans
    else:
        chans = [g] + chans
    fmap = torch.stack(chans, dim=-1)  # (H, W, C)
    C = fmap.shape[-1]
    offs = (torch.arange(patch, dtype=torch.float32, device=img.device) - (patch - 1) / 2.0) * spacing
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    grid = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)  # (patch^2, 2)
    pts = kp[:, None, :] + grid[None]
    N, P2, _ = pts.shape
    vals, _, valid = interpolate_features(fmap, pts.reshape(-1, 2), compute_grad=False)
    # zero the samples off the image, then mean-centre and L2-normalise
    desc = (vals.reshape(N, P2, C) * valid.reshape(N, P2, 1)).reshape(N, P2 * C)
    # the mean as XLA compiles it: the sum times the reciprocal of the count
    desc = desc - desc.sum(dim=1, keepdim=True) * (1.0 / (P2 * C))
    return desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-6)


def describe_keypoints(image, keypoints, patch: int = 13, spacing: float = 2.0, device=None) -> torch.Tensor:
    """Descriptors (N, patch^2 * C) f32, L2-normalised, on ``device``."""
    dev = resolve(device)
    kp = torch.as_tensor(keypoints, dtype=torch.float32).to(dev)
    with true_f32():
        return _describe(_as_image(image, dev), kp, patch, spacing)


def detect_and_describe(image, max_keypoints: int = 1024, device=None, **kw):
    """(keypoints, scores, descriptors), all on ``device``."""
    kp, scores = detect_keypoints(image, max_keypoints=max_keypoints, device=device, **kw)
    return kp, scores, describe_keypoints(image, kp, device=device)
