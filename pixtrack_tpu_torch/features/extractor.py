"""Feature extractor with the reference's resize policy.

Port of ``pixtrack_tpu/features/extractor.py``: resize so the max edge is at
most ``resize // image_scale`` (rounded to multiples of 16), run the model
(the UNet, or a callable such as ``HandcraftedExtractor``), L2-normalise, and return per-level (sx, sy) scales from original image
pixels. The downsample is ``F.interpolate(bilinear, antialias=True)``, which
matches ``jax.image.resize(method="linear")`` (it antialiases too).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pixtrack_tpu_torch.features.pyramid import FeaturePyramid
from pixtrack_tpu_torch.features.unet import normalize_features


def _round16(x: float) -> int:
    return max(16, int(round(x / 16)) * 16)


class FeatureExtractor:
    """A pyramid model behind one call. ``model`` is a ``UNetExtractor`` or a
    callable ``(H, W, 3) -> FeaturePyramid`` with ``.scales`` and ``.device``."""

    def __init__(self, model, resize: Optional[int] = 1024, resize_by: str = "max",
                 normalize: bool = True):
        assert resize_by in ("max", "max_force")
        self.model = model
        self.resize = resize
        self.resize_by = resize_by
        self.normalize = normalize

    @property
    def scales(self):
        return self.model.scales

    @property
    def device(self) -> torch.device:
        if isinstance(self.model, torch.nn.Module):
            return next(self.model.parameters()).device
        return self.model.device

    def _target_hw(self, H: int, W: int, image_scale: int):
        if self.resize is None:
            return H, W, 1.0
        target = self.resize // image_scale
        m = max(H, W)
        if m > target or self.resize_by == "max_force":
            r = target / m
            return _round16(H * r), _round16(W * r), r
        return H, W, 1.0

    def _run(self, img: torch.Tensor, out_h: int, out_w: int):
        """Levels and confidences of one (H, W, 3) image, or of a batch (B,
        H, W, 3) in one call of the model."""
        img = img.float()
        if img.ndim == 2:
            img = img[..., None].expand(*img.shape, 3)
        batched = img.ndim == 4
        if tuple(img.shape[-3:-1]) != (out_h, out_w):
            # one image keeps its (1, C, H, W) view: the resize's result, and so
            # the model's, depends on the input's strides in the last bits
            img = F.interpolate(
                img.permute(0, 3, 1, 2) if batched else img.permute(2, 0, 1)[None], size=(out_h, out_w),
                mode="bilinear", antialias=True, align_corners=False,
            )
            img = img.permute(0, 2, 3, 1) if batched else img[0].permute(1, 2, 0)
        x = img if batched else img[None]
        with torch.no_grad():
            if isinstance(self.model, torch.nn.Module):
                pred = self.model(x)
                feats, confs = tuple(pred["feature_maps"]), tuple(pred["confidences"])
                if not batched:
                    feats, confs = tuple(f[0] for f in feats), tuple(c[0] for c in confs)
            else:
                pyr = self.model(x if batched else x[0])
                feats, confs = pyr.levels, pyr.confidences
        if self.normalize:
            feats = tuple(normalize_features(f) for f in feats)
        return feats, confs

    def traced(self, image: torch.Tensor, image_scale: int = 1) -> FeaturePyramid:
        """Pyramid of a float (H, W, 3) image in [0, 1] already on the device,
        or of a batch (B, H, W, 3): (B, ...) levels, the scales shared."""
        H, W = (int(v) for v in (image.shape[1:3] if image.ndim == 4 else image.shape[:2]))
        out_h, out_w, _ = self._target_hw(H, W, image_scale)
        feats, confs = self._run(image, out_h, out_w)
        ry, rx = out_h / H, out_w / W
        scales = tuple((rx / s, ry / s) for s in self.scales)
        return FeaturePyramid(levels=feats, scales=scales, confidences=confs)

    def __call__(self, image, image_scale: int = 1) -> FeaturePyramid:
        """image: (H, W, 3) or (H, W), uint8 [0, 255] or float [0, 1]."""
        if not isinstance(image, torch.Tensor):
            image = torch.as_tensor(np.asarray(image))
        if image.dtype == torch.uint8:
            image = image.float() / 255.0
        return self.traced(image.to(self.device), image_scale)
