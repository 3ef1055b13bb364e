"""Feature pyramid container shared by the extractor and the aligner."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class FeaturePyramid:
    """Levels fine -> coarse.

    levels:      tuple of (H_l, W_l, C_l) tensors.
    scales:      tuple of (sx, sy) from original image pixels to level pixels.
    confidences: optional tuple of (H_l, W_l) maps in [0, 1].
    """

    levels: Tuple[torch.Tensor, ...]
    scales: Tuple[Tuple[float, float], ...]
    confidences: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)
