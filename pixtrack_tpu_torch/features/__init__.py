"""Feature extraction: feature pyramids (the UNet's, or the weight-free
handcrafted one) for feature-metric alignment. The UNet's training and
evaluation live in ``features.train`` (warp-consistency InfoNCE, the npz
weight format), ``features.train_basin`` (training through the unrolled
aligner) and ``features.evaluate`` (the held-out alignment benchmark)."""

import os
from pathlib import Path
from typing import Optional

import torch

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.features.extractor import FeatureExtractor
from pixtrack_tpu_torch.features.handcrafted import HandcraftedExtractor
from pixtrack_tpu_torch.features.pyramid import FeaturePyramid
from pixtrack_tpu_torch.features.unet import UNetExtractor, init_unet, load_unet_weights


def default_unet_weights_path() -> Path:
    """The shipped basin-trained UNet (assets/unet_basin.npz), overridable
    through PIXTRACK_UNET_WEIGHTS."""
    env = os.environ.get("PIXTRACK_UNET_WEIGHTS")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "assets" / "unet_basin.npz"


def default_extractor(
    resize: Optional[int] = 1024, device=None, dtype: torch.dtype = torch.bfloat16
) -> FeatureExtractor:
    """The production extractor: the shipped UNet where its checkpoint is
    present, else the handcrafted pyramid. ``device`` None is the CUDA card."""
    device = resolve(device)
    path = default_unet_weights_path()
    if path.exists():
        return FeatureExtractor(load_unet_weights(path, device=device, dtype=dtype), resize=resize)
    return FeatureExtractor(HandcraftedExtractor(device=device), resize=resize)


__all__ = [
    "FeaturePyramid",
    "UNetExtractor",
    "HandcraftedExtractor",
    "FeatureExtractor",
    "default_extractor",
    "default_unet_weights_path",
    "init_unet",
    "load_unet_weights",
]
