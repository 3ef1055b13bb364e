"""Testbed facade: the instant-ngp-shaped rendering interface, distilled-field subset.

Port of the parts of ``pixtrack_tpu/nerf/testbed.py`` the tracker uses:
install a distilled field (``set_baked_field``), the render crop
(``render_aabb``), exact intrinsics (``override_intrinsics``), occupied-bounds
tightening and a Shade/Depth ``render`` at the defaults of 64 coarse and 32
importance samples per ray (K2), or coarse only (K1) when ``n_fine`` is 0;
``spp > 1`` is the mean of ``spp`` jittered renders (always K2). Hash-grid
snapshots and baking are not ported.
"""

from __future__ import annotations

import enum
from types import SimpleNamespace

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.nerf.render import RenderConfig, occupied_bounds, render_image


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
        self._baked = None
        self.n_coarse = 64
        self.n_fine = 32
        self._sphere = None

    def load_snapshot(self, path, bake: bool = True) -> None:
        raise NotImplementedError("hash-grid snapshots are not ported yet")

    def bake(self) -> None:
        raise NotImplementedError("hash-grid baking is not ported yet")

    def set_baked_field(self, field) -> None:
        """Install a distilled render field (``nerf.distill.load_distilled``)."""
        self._baked = field

    def tighten_render_bounds(self, res: int = 96, sigma_threshold: float = 0.01) -> None:
        """Shrink render_aabb to the field's occupied box and install the
        occupied bounding ball for per-ray interval tightening."""
        if self._baked is None:
            raise RuntimeError("no field loaded")
        aabb = np.asarray([self.render_aabb.min, self.render_aabb.max], np.float32)
        tight, sphere = occupied_bounds(self._baked, aabb, res=res, sigma_threshold=sigma_threshold)
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
        if self._baked is None:
            raise RuntimeError("no field loaded")
        dev = self.device
        cfg = RenderConfig(n_coarse=self.n_coarse, n_fine=self.n_fine,
                           min_transmittance=float(self.nerf.rendering_min_transmittance), perturb=spp > 1)
        aabb = torch.as_tensor([self.render_aabb.min, self.render_aabb.max], dtype=torch.float32, device=dev)
        sphere = None if self._sphere is None else torch.as_tensor(self._sphere, dtype=torch.float32, device=dev)
        c2w = torch.as_tensor(self._camera, dtype=torch.float32, device=dev)

        def one(generator):
            return render_image(self._baked, c2w, *self._intrinsics(width, height), width, height, aabb, cfg,
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
