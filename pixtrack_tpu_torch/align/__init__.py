"""Feature-metric alignment: interpolation, observations and the LM."""

from pixtrack_tpu_torch.align.interpolate import (
    interpolate_features,
    interpolate_packed,
    interpolate_scalar,
    pack_fmap,
)
from pixtrack_tpu_torch.align.lm import AlignConfig, LevelData, align_level, align_level_traced, align_pyramid
from pixtrack_tpu_torch.align.observations import aggregate_observations, build_level_data, observe_points

__all__ = [
    "interpolate_features",
    "interpolate_scalar",
    "pack_fmap",
    "interpolate_packed",
    "AlignConfig",
    "LevelData",
    "align_level",
    "align_level_traced",
    "align_pyramid",
    "aggregate_observations",
    "build_level_data",
    "observe_points",
]
