"""The NeRF side of the port: the hash-grid field, its training, snapshots and
bake, distillation into the render field, and rendering through K1 (the
fused march) and K2 (the per-sample field). The functions ``train.train``
and ``distill.distill`` are not re-exported here: their names are their
modules'."""

from pixtrack_tpu_torch.nerf.baked import BakedField, bake, main_component, occupancy_grid
from pixtrack_tpu_torch.nerf.dataset import NerfDataset, make_synthetic_dataset
from pixtrack_tpu_torch.nerf.distill import (
    DistillConfig,
    DistilledField,
    distilled_from_arrays,
    finetune_photometric,
    init_distilled,
    load_distilled,
    save_distilled,
)
from pixtrack_tpu_torch.nerf.field import NGPField, init_field, ngp_from_flax_params, ngp_to_flax_params
from pixtrack_tpu_torch.nerf.fused_mlp import (
    distilled_eval_reference,
    fused_distilled_eval,
    fused_march_render,
    march_render_reference,
)
from pixtrack_tpu_torch.nerf.render import RenderConfig, render_image, render_rays
from pixtrack_tpu_torch.nerf.snapshot import load_snapshot, save_snapshot
from pixtrack_tpu_torch.nerf.testbed import RenderMode, Testbed, initialize_testbed
from pixtrack_tpu_torch.nerf.train import TrainConfig

__all__ = [
    "BakedField",
    "bake",
    "main_component",
    "occupancy_grid",
    "NerfDataset",
    "make_synthetic_dataset",
    "DistillConfig",
    "DistilledField",
    "distilled_from_arrays",
    "finetune_photometric",
    "init_distilled",
    "load_distilled",
    "save_distilled",
    "NGPField",
    "init_field",
    "ngp_from_flax_params",
    "ngp_to_flax_params",
    "distilled_eval_reference",
    "fused_distilled_eval",
    "fused_march_render",
    "march_render_reference",
    "RenderConfig",
    "render_image",
    "render_rays",
    "load_snapshot",
    "save_snapshot",
    "RenderMode",
    "Testbed",
    "initialize_testbed",
    "TrainConfig",
]
