"""Testbed facade: the instant-ngp-shaped rendering interface.

Port of ``pixtrack_tpu/nerf/testbed.py``: load a hash-grid snapshot
(``load_snapshot``, baked by default) or install a field (``set_field``,
``set_baked_field``), bake it, distill it into the render field
(``distill``, optionally fine-tuned on the capture), the render crop
(``render_aabb``), exact intrinsics (``override_intrinsics``),
occupied-bounds tightening and a Shade/Depth ``render`` at the defaults of
64 coarse and 32 importance samples per ray. The render field is the
installed baked or distilled field, else the vertex field. A distilled
field renders through K2, or K1 when ``n_fine`` is 0; the hash-grid fields
through the staged render's plain field evaluation. ``spp > 1`` is the
mean of ``spp`` jittered renders (never K1).
"""

from __future__ import annotations

import enum
from types import SimpleNamespace

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.nerf.render import RenderConfig, occupied_bounds, render_image
from pixtrack_tpu_torch.nerf.snapshot import load_snapshot


class RenderMode(enum.Enum):
    Shade = 0
    Depth = 1


class _AABB:
    def __init__(self):
        self.min = [0.0, 0.0, 0.0]
        self.max = [1.0, 1.0, 1.0]


class Testbed:
    """The pyngp Testbed surface pixtrack drives, over a distilled field."""

    __test__ = False  # not a pytest class

    def __init__(self, device=None):
        self.device = resolve(device)  # None: the CUDA card
        self.background_color = [1.0, 1.0, 1.0, 0.0]
        self.fov_axis = 0
        self.exposure = 0.0
        self.render_mode = RenderMode.Shade
        self.render_aabb = _AABB()
        self.nerf = SimpleNamespace(rendering_min_transmittance=1e-7)
        self._fov_deg = 50.0
        # exact (fx, fy, cx, cy); None derives them from the field of view
        self.override_intrinsics = None
        self._camera = np.eye(4)
        self.field = None  # the vertex (hash-grid) field
        self._baked = None  # the render field: baked or distilled
        self.n_coarse = 64
        self.n_fine = 32
        self._sphere = None

    def load_snapshot(self, path, bake: bool = True) -> None:
        """Load a hash-grid snapshot (either package's) onto the Testbed's
        device, take its crop box from the snapshot's ``aabb``, and bake it."""
        field, extra = load_snapshot(path, device=self.device)
        if "aabb" in extra:
            self.render_aabb.min = list(extra["aabb"][0])
            self.render_aabb.max = list(extra["aabb"][1])
        self.set_field(field, bake=bake)

    def set_field(self, field, bake: bool = False) -> None:
        """Install a vertex field (``NGPField``); drops any render field."""
        self.field = field
        self._baked = None
        if bake:
            self.bake()

    def set_baked_field(self, field) -> None:
        """Install a baked or distilled render field (``nerf.distill.load_distilled``)."""
        self._baked = field

    def bake(self) -> None:
        """Pack the vertex field into the cell-packed render field
        (``nerf.baked.bake``); the vertex field is kept."""
        from pixtrack_tpu_torch.nerf.baked import bake

        self._baked = bake(self.field)

    def _render_field(self):
        fld = self._baked if self._baked is not None else self.field
        if fld is None:
            raise RuntimeError("no field loaded")
        return fld

    def distill(self, config=None, seed: int = 0, clean_floaters: bool = True, finetune_dataset=None,
                finetune_steps: int = 3000) -> None:
        """Replace the render field with a distilled MLP fitted to the
        current one (the baked field if installed, else the vertex field).

        ``clean_floaters``: clamp the teacher's density to zero outside the
        largest connected component of its occupancy, so that floaters of a
        short training are erased from the student. ``finetune_dataset``: a
        NerfDataset (the training capture) to fine-tune the student on
        through the renderer (``finetune_photometric``, ``finetune_steps``
        steps, seed ``seed + 1``)."""
        from pixtrack_tpu_torch.nerf.baked import main_component, occupancy_grid
        from pixtrack_tpu_torch.nerf.distill import DistillConfig, distill, finetune_photometric

        teacher = self._render_field()
        occ = occupancy_grid(teacher)
        mask = None
        if clean_floaters and occ.any():
            mask = main_component(occ)
            occ = occ & mask
        aabb = np.asarray([self.render_aabb.min, self.render_aabb.max], np.float32)
        self._baked = distill(teacher, aabb, occ=occ, config=config or DistillConfig(), seed=seed,
                              density_mask=mask)
        if finetune_dataset is not None:
            self._baked = finetune_photometric(self._baked, finetune_dataset, aabb, steps=finetune_steps,
                                               seed=seed + 1)

    def tighten_render_bounds(self, res: int = 96, sigma_threshold: float = 0.01) -> None:
        """Shrink render_aabb to the render field's occupied box and install
        the occupied bounding ball for per-ray interval tightening. The
        sweep trusts the current render_aabb as the field's domain."""
        aabb = np.asarray([self.render_aabb.min, self.render_aabb.max], np.float32)
        tight, sphere = occupied_bounds(self._render_field(), aabb, res=res, sigma_threshold=sigma_threshold)
        self.render_aabb.min = [float(v) for v in tight[0]]
        self.render_aabb.max = [float(v) for v in tight[1]]
        self._sphere = sphere

    @property
    def fov(self) -> float:
        return self._fov_deg

    @fov.setter
    def fov(self, deg: float) -> None:
        self._fov_deg = float(deg)

    def set_nerf_camera_matrix(self, m) -> None:
        cam = np.eye(4)
        cam[:3, :4] = np.asarray(m, np.float64)[:3, :4]
        self._camera = cam

    def _intrinsics(self, width: int, height: int):
        if self.override_intrinsics is not None:
            return tuple(float(v) for v in self.override_intrinsics)
        half_angle = np.deg2rad(self._fov_deg) / 2.0
        f = ((width if self.fov_axis == 0 else height) / 2.0) / np.tan(half_angle)
        return f, f, (width - 1) / 2.0, (height - 1) / 2.0

    def render(self, width: int, height: int, spp: int = 1, linear: bool = True, seed: int = 0) -> np.ndarray:
        """(H, W, 4) float32; Depth mode puts NeRF-unit depth in the RGB
        channels. ``spp == 1`` is one deterministic sample per pixel;
        ``spp > 1`` is the mean of ``spp`` jittered renders, each drawing
        from its own device generator split from ``seed``."""
        field = self._render_field()
        dev = self.device
        cfg = RenderConfig(n_coarse=self.n_coarse, n_fine=self.n_fine,
                           min_transmittance=float(self.nerf.rendering_min_transmittance), perturb=spp > 1)
        aabb = torch.as_tensor([self.render_aabb.min, self.render_aabb.max], dtype=torch.float32, device=dev)
        sphere = None if self._sphere is None else torch.as_tensor(self._sphere, dtype=torch.float32, device=dev)
        c2w = torch.as_tensor(self._camera, dtype=torch.float32, device=dev)

        def one(generator):
            return render_image(field, c2w, *self._intrinsics(width, height), width, height, aabb, cfg,
                                background=tuple(self.background_color[:3]), sphere=sphere, generator=generator)

        with torch.no_grad():
            if spp > 1:
                seeds = torch.randint(2**62, (spp,), generator=torch.Generator().manual_seed(int(seed)))
                outs = [one(torch.Generator(device=dev).manual_seed(int(s))) for s in seeds]
                out = {k: torch.stack([o[k] for o in outs]).mean(dim=0) for k in outs[0]}
            else:
                out = one(None)
        rgba = out["rgba"].cpu().numpy()
        if self.render_mode == RenderMode.Depth:
            depth = out["depth"].cpu().numpy()
            rgba = np.concatenate([np.repeat(depth[..., None], 3, axis=-1), rgba[..., 3:]], axis=-1)
        if not linear:
            rgba = rgba.copy()
            rgba[..., :3] = np.clip(rgba[..., :3], 0, 1) ** (1 / 2.2)
        if self.exposure:
            rgba[..., :3] = rgba[..., :3] * (2.0 ** self.exposure)
        return rgba.astype(np.float32)


def initialize_testbed(snapshot_path, aabb=None, background=None, tighten: bool = False, device=None) -> Testbed:
    """The reference's ``initialize_ingp`` defaults over a baked snapshot, on
    ``device`` (None is the CUDA card); ``tighten`` runs the occupied-bounds
    sweep."""
    if background is None:
        background = [255, 255, 255, 0.0]
    tb = Testbed(device=device)
    tb.load_snapshot(snapshot_path)
    tb.background_color = [c / 255.0 if c > 1 else c for c in background]
    tb.nerf.rendering_min_transmittance = 1e-7
    tb.fov_axis = 0
    if aabb is not None:
        tb.render_aabb.min = list(aabb[0])
        tb.render_aabb.max = list(aabb[1])
    tb.exposure = 0.0
    if tighten:
        tb.tighten_render_bounds()
    return tb
