"""Typed configuration system (host code).

Port of ``pixtrack_tpu/utils/config.py``: dataclasses loaded from YAML, with
a converter for shell-style ``config/*.sh`` files (``export KEY=VALUE``) so
existing object configs carry over. ``RunConfig.tracker_config``,
``align_config`` and ``make_extractor`` build this package's objects.
``yaml`` is imported inside the functions that read or write a file.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from pathlib import Path
from typing import List, Optional, Tuple

@dataclasses.dataclass
class ObjectConfig:
    """Per-object asset configuration (the role of a ``config/<object>.sh``)."""

    name: str = "object"
    object_path: str = ""
    dataset_path: str = ""          # PIXTRACK_OUTPUTS root equivalent
    aabb: Optional[List[List[float]]] = None   # grid-space OBJ_AABB
    upright_ref_img: Optional[str] = None      # UPRIGHT_REF_IMG
    object_center: Optional[List[float]] = None  # OBJ_CENTER
    object_id: Optional[int] = None            # YCB OBJECT_ID
    snapshot: str = "pixtrack/instant-ngp/snapshots/weights.msgpack"
    nerf2sfm: str = "pixtrack/pixsfm/dataset/nerf2sfm.pkl"
    reference_sfm: str = "pixtrack/aug_nerf_sfm/aug_sfm"

    @classmethod
    def from_shell_config(cls, path) -> "ObjectConfig":
        """Parse a shell-style ``config/<object>.sh`` (export KEY=VALUE)."""
        text = Path(path).read_text()
        env = {}
        for m in re.finditer(r"^\s*export\s+([A-Z_]+)=(.*)$", text, re.M):
            key, val = m.group(1), m.group(2).strip().strip("'\"")
            env[key] = val
        aabb = None
        if "OBJ_AABB" in env:
            aabb = ast.literal_eval(env["OBJ_AABB"])
        center = None
        if "OBJ_CENTER" in env:
            center = list(ast.literal_eval(env["OBJ_CENTER"]))
        return cls(
            name=env.get("OBJECT", Path(path).stem),
            object_path=env.get("OBJECT_PATH", ""),
            dataset_path=env.get("PIXTRACK_OUTPUTS", env.get("DATASET_PATH", "")),
            aabb=aabb,
            upright_ref_img=env.get("UPRIGHT_REF_IMG"),
            object_center=center,
            object_id=int(env["OBJECT_ID"]) if "OBJECT_ID" in env else None,
        )


@dataclasses.dataclass
class RunConfig:
    """Per-run configuration: tracker + aligner + pipeline knobs."""

    # tracker (TrackerConfig mirror)
    reference_scale: float = 0.5
    covis_threshold: int = 50
    num_refs: int = 1
    cache_thresh_rad: float = 0.0
    cost_threshold_factor: float = 1.1
    cost_threshold_min: float = 0.0
    cold_multiscale: Tuple[int, ...] = (4, 1)
    steady_multiscale: Tuple[int, ...] = (1,)
    use_mask: bool = True
    refine_rounds: int = 1
    render_spp: int = 1
    # aligner (AlignConfig mirror)
    num_iters: int = 150
    robust_c: float = 0.5
    grad_stop_criteria: float = 1e-4
    dt_stop_criteria: float = 5e-3
    dR_stop_criteria: float = 5e-4
    # extractor
    resize: int = 1024
    extractor: str = "auto"  # auto | handcrafted | unet
    unet_weights: Optional[str] = None
    # nerf training
    nerf_steps: int = 10000
    nerf_batch_rays: int = 16384
    aabb_scale: int = 4

    def tracker_config(self, object_cfg: Optional[ObjectConfig] = None):
        from pixtrack_tpu_torch.tracking.tracker import TrackerConfig

        return TrackerConfig(
            upright_ref_img=object_cfg.upright_ref_img if object_cfg else None,
            reference_scale=self.reference_scale,
            covis_threshold=self.covis_threshold,
            num_refs=self.num_refs,
            cache_thresh_rad=self.cache_thresh_rad,
            cost_threshold_factor=self.cost_threshold_factor,
            cost_threshold_min=self.cost_threshold_min,
            cold_multiscale=tuple(self.cold_multiscale),
            steady_multiscale=tuple(self.steady_multiscale),
            use_mask=self.use_mask,
            refine_rounds=self.refine_rounds,
            render_spp=self.render_spp,
        )

    def align_config(self):
        from pixtrack_tpu_torch.align.lm import AlignConfig

        return AlignConfig(
            num_iters=self.num_iters,
            robust_c=self.robust_c,
            grad_stop_criteria=self.grad_stop_criteria,
            dt_stop_criteria=self.dt_stop_criteria,
            dR_stop_criteria=self.dR_stop_criteria,
        )

    def make_extractor(self, device=None):
        """The run's extractor on ``device`` (None is the CUDA card)."""
        import torch

        from pixtrack_tpu_torch._device import resolve
        from pixtrack_tpu_torch.features import (
            FeatureExtractor,
            HandcraftedExtractor,
            default_extractor,
            init_unet,
            load_unet_weights,
        )

        device = resolve(device)
        if self.extractor == "auto":
            # the basin-trained UNet when its checkpoint is present, else handcrafted
            return default_extractor(resize=self.resize, device=device)
        if self.extractor == "unet":
            if self.unet_weights and os.path.exists(self.unet_weights):
                model = load_unet_weights(self.unet_weights, device=device)
            else:  # flax's initialisation from a fixed seed, as init_unet(PRNGKey(0))
                model = init_unet(torch.Generator().manual_seed(0), device=device).eval()
            return FeatureExtractor(model, resize=self.resize)
        return FeatureExtractor(HandcraftedExtractor(device=device), resize=self.resize)


def _from_dict(cls, d: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in fields})


def load_config(path) -> Tuple[ObjectConfig, RunConfig]:
    """Load a YAML config with optional ``object:`` and ``run:`` sections."""
    path = Path(path)
    if path.suffix == ".sh":
        return ObjectConfig.from_shell_config(path), RunConfig()
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    obj = _from_dict(ObjectConfig, data.get("object", {}))
    run = _from_dict(RunConfig, data.get("run", {}))
    return obj, run


def save_config(obj: ObjectConfig, run: RunConfig, path) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(
            {
                "object": dataclasses.asdict(obj),
                "run": dataclasses.asdict(run),
            },
            f,
        )
