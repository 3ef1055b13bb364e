"""Weight-free multiscale gradient-feature extractor.

Port of ``pixtrack_tpu/features/handcrafted.py``: stands in for the learned
UNet when no trained weights exist. Per level, a Gaussian-smoothed intensity
channel plus x/y gradients at two blur widths, a difference-of-Gaussians
band-pass channel, the gradient magnitude and the blurred colour. The LM
aligner linearizes the feature field, so the features need a usable basin of
attraction: hence the heavy blur at the coarse levels (the role of the
UNet's receptive field).

Images and feature maps are channel-last (H, W, C), as the pyramid contract
of ``features/pyramid.py`` has them; the blur transposes to channel-first
around its two depthwise convolutions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.features.pyramid import FeaturePyramid


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur on (H, W), (H, W, C) or a batch (B, H, W, C):
    the edge is repeated, then two depthwise convolutions without padding
    (rows, then columns)."""
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel1d(sigma, radius, img.device)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    batched = img.ndim == 4
    C = img.shape[-1]
    # one image keeps its (1, C, H, W) view: the convolutions' results depend
    # on the input's strides in the last bits
    x = img.permute(0, 3, 1, 2) if batched else img.permute(2, 0, 1)[None]
    x = F.pad(x, (radius, radius, radius, radius), mode="replicate")
    x = F.conv2d(x, k[None, None, :, None].expand(C, 1, -1, 1), groups=C)
    x = F.conv2d(x, k[None, None, None, :].expand(C, 1, 1, -1), groups=C)
    out = x.permute(0, 2, 3, 1) if batched else x[0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def _gradient(img: torch.Tensor, axis: int) -> torch.Tensor:
    """numpy's ``gradient`` along one axis of (..., H, W): central
    differences inside, one-sided differences at the two borders."""
    a = img.movedim(axis, 0)
    inner = (a[2:] - a[:-2]) * 0.5
    return torch.cat([a[1:2] - a[0:1], inner, a[-1:] - a[-2:-1]], dim=0).movedim(0, axis)


def _level_features_from(s1: torch.Tensor, s2: torch.Tensor, c1: Optional[torch.Tensor]) -> torch.Tensor:
    """Feature map from the narrow and wide gray blurs and the blurred colour."""
    g1x, g1y = _gradient(s1, -1), _gradient(s1, -2)
    g2x, g2y = _gradient(s2, -1), _gradient(s2, -2)
    dog = s1 - s2
    chans = [s1, s2, g1x * 4.0, g1y * 4.0, g2x * 8.0, g2y * 8.0, dog * 4.0,
             torch.sqrt(g1x**2 + g1y**2 + 1e-8) * 4.0]
    feats = torch.stack(chans, dim=-1)
    if c1 is not None:
        feats = torch.cat([feats, c1 * 2.0], dim=-1)
    return feats.float()


def _level_features(gray: torch.Tensor, color: Optional[torch.Tensor]) -> torch.Tensor:
    """One level on its own (arbitrary strides): blur here, then build."""
    s1 = gaussian_blur(gray, 1.0)
    s2 = gaussian_blur(gray, 3.0)
    c1 = gaussian_blur(color, 1.0) if color is not None else None
    return _level_features_from(s1, s2, c1)


def _downsample(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Anti-aliased downsample of (H, W), (H, W, C) or (B, H, W, C) by an
    integer factor."""
    out = gaussian_blur(img, factor * 0.6)
    return out[::factor, ::factor] if img.ndim == 2 else out[..., ::factor, ::factor, :]


class HandcraftedExtractor:
    """Callable with the pyramid contract of the UNet (strides 1, 4, 16).
    ``device`` None is the CUDA card; images are moved there."""

    scales = (1, 4, 16)

    def __init__(self, strides=(1, 4, 16), device=None):
        self.scales = tuple(strides)
        self.device = resolve(device)

    def __call__(self, image: torch.Tensor) -> FeaturePyramid:
        """image: (H, W, 3) or (H, W), float in [0, 1]; a batch (B, H, W, 3)
        gives (B, ...) levels and confidences."""
        image = image.to(self.device)
        if image.ndim == 4:
            return self._batch(image)
        if image.ndim == 3:
            gray = image @ torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype, device=self.device)
            color = image.float()
        else:
            gray, color = image, None
        gray = gray.float()
        if self.scales == (1, 4, 16):
            levels = self._cascade_pyramid(gray, color)
        else:
            levels = []
            for s in self.scales:
                g = gray if s == 1 else _downsample(gray, s)
                c = None
                if color is not None:
                    c = color if s == 1 else _downsample(color, s)
                levels.append(_level_features(g, c))
        # confidence: the gradient magnitude (texture-ness), squashed
        confs = [torch.tanh(f[..., 7] * 2.0) for f in levels]
        return FeaturePyramid(
            levels=tuple(levels),
            scales=tuple((1.0 / s, 1.0 / s) for s in self.scales),
            confidences=tuple(confs),
        )

    def _batch(self, images: torch.Tensor) -> FeaturePyramid:
        """The pyramid of (B, H, W, 3) images in one pass of batched ops."""
        gray = (images @ torch.tensor([0.299, 0.587, 0.114], dtype=images.dtype, device=self.device)).float()
        color = images.float()
        if self.scales == (1, 4, 16):
            levels = self._cascade_pyramid(gray, color)
        else:
            levels = []
            for s in self.scales:
                g = gray[..., None] if s == 1 else _downsample(gray[..., None], s)
                c = color if s == 1 else _downsample(color, s)
                levels.append(_level_features_from(gaussian_blur(g, 1.0)[..., 0], gaussian_blur(g, 3.0)[..., 0],
                                                   gaussian_blur(c, 1.0)))
        return FeaturePyramid(
            levels=tuple(levels),
            scales=tuple((1.0 / s, 1.0 / s) for s in self.scales),
            confidences=tuple(torch.tanh(f[..., 7] * 2.0) for f in levels),
        )

    @staticmethod
    def _cascade_pyramid(gray: torch.Tensor, color: Optional[torch.Tensor]):
        """Cascaded pyramid for the production strides (1, 4, 16).

        The per-level path blurs at full resolution for every level (the
        stride-16 anti-alias blur alone is a radius-29 kernel); the cascade
        blurs a little, decimates by 4 and repeats, which needs two
        full-resolution separable passes in all and gives near-identical
        Gaussian scales (the stride-4 input carries sigma 3/4 = 0.75 level
        pixels from the stage before, topped up to 1.0 with a
        sqrt(1 - 0.75^2) blur)."""
        chans = [gray[..., None]]
        if color is not None:
            chans.append(color)
        cur = torch.cat(chans, dim=-1)  # (..., H, W, 1 or 4)
        levels = []
        for li in range(3):
            s1 = gaussian_blur(cur, 1.0 if li == 0 else 0.66)
            s2 = gaussian_blur(s1, 2.828)  # total sigma ~3 at this level
            c1 = s1[..., 1:] if color is not None else None
            levels.append(_level_features_from(s1[..., 0], s2[..., 0], c1))
            # s2 (sigma ~3) is enough of an anti-alias filter for a /4
            # decimation (which needs ~2.4); the carried sigma becomes 0.75
            cur = s2[..., ::4, ::4, :]
        return levels
