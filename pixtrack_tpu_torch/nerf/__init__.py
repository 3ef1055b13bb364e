"""Rendering of the distilled field, with K1 (the fused march) and K2 (the per-sample field)."""

from pixtrack_tpu_torch.nerf.distill import DistilledField, distilled_from_arrays, load_distilled
from pixtrack_tpu_torch.nerf.fused_mlp import (
    distilled_eval_reference,
    fused_distilled_eval,
    fused_march_render,
    march_render_reference,
)
from pixtrack_tpu_torch.nerf.render import RenderConfig, render_image, render_rays
from pixtrack_tpu_torch.nerf.testbed import RenderMode, Testbed

__all__ = [
    "DistilledField",
    "distilled_from_arrays",
    "load_distilled",
    "distilled_eval_reference",
    "fused_distilled_eval",
    "fused_march_render",
    "march_render_reference",
    "RenderConfig",
    "render_image",
    "render_rays",
    "RenderMode",
    "Testbed",
]
