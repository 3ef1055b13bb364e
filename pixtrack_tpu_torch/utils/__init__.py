"""Utilities: typed configuration and frame IO."""

from pixtrack_tpu_torch.utils.config import ObjectConfig, RunConfig, load_config

__all__ = ["ObjectConfig", "RunConfig", "load_config"]
