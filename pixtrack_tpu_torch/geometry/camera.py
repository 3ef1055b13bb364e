"""Pinhole / radial cameras as a dataclass of tensors with analytic Jacobians.

Port of ``pixtrack_tpu/geometry/camera.py``. Projections return
index-centred pixel coordinates: ``(0, 0)`` is the centre of the top-left
pixel, so ``from_colmap`` subtracts 0.5 from COLMAP's principal point.
"""

from __future__ import annotations

import dataclasses

import torch

from pixtrack_tpu_torch.geometry.pose import Pose

CAMERA_MODEL_IDS = {
    "SIMPLE_PINHOLE": 0,
    "PINHOLE": 1,
    "SIMPLE_RADIAL": 2,
    "RADIAL": 3,
    "OPENCV": 4,
}
CAMERA_MODEL_NAMES = {v: k for k, v in CAMERA_MODEL_IDS.items()}
# number of params per COLMAP model
CAMERA_MODEL_NUM_PARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8}


def _vec(values, device) -> torch.Tensor:
    return torch.as_tensor([float(v) for v in values], dtype=torch.float32, device=device)


@dataclasses.dataclass
class Camera:
    """Intrinsics: size (width, height), f (fx, fy), c (cx, cy), k (k1, k2)."""

    size: torch.Tensor
    f: torch.Tensor
    c: torch.Tensor
    k: torch.Tensor

    @classmethod
    def pinhole(cls, fx, fy, cx, cy, width, height, device=None) -> "Camera":
        return cls(
            size=_vec([width, height], device), f=_vec([fx, fy], device),
            c=_vec([cx, cy], device), k=_vec([0.0, 0.0], device),
        )

    @classmethod
    def from_colmap(cls, model, params, width, height, device=None) -> "Camera":
        """From a COLMAP camera row (model name or id, params)."""
        if isinstance(model, int):
            model = CAMERA_MODEL_NAMES[model]
        p = [float(v) for v in params]
        if model == "SIMPLE_PINHOLE":
            f, c, k = [p[0], p[0]], p[1:3], [0.0, 0.0]
        elif model == "PINHOLE":
            f, c, k = p[0:2], p[2:4], [0.0, 0.0]
        elif model == "SIMPLE_RADIAL":
            f, c, k = [p[0], p[0]], p[1:3], [p[3], 0.0]
        elif model == "RADIAL":
            f, c, k = [p[0], p[0]], p[1:3], p[3:5]
        elif model == "OPENCV":
            # tangential terms dropped, as in the JAX package
            f, c, k = p[0:2], p[2:4], p[4:6]
        else:
            raise ValueError(f"unsupported COLMAP camera model {model!r}")
        return cls(
            size=_vec([width, height], device), f=_vec(f, device),
            c=_vec(c, device) - 0.5, k=_vec(k, device),
        )

    def to(self, device) -> "Camera":
        if self.f.device == torch.device(device):
            return self
        return Camera(*(getattr(self, n).to(device) for n in ("size", "f", "c", "k")))

    @property
    def width(self) -> torch.Tensor:
        return self.size[..., 0]

    @property
    def height(self) -> torch.Tensor:
        return self.size[..., 1]

    def scale(self, s) -> "Camera":
        """Rescale the image by ``s``; index-centred c maps as (c + 0.5) s - 0.5."""
        s = torch.as_tensor(s, dtype=self.f.dtype, device=self.f.device).expand(self.f.shape)
        return Camera(size=self.size * s, f=self.f * s, c=(self.c + 0.5) * s - 0.5, k=self.k)

    def crop(self, left_top, size) -> "Camera":
        lt = torch.as_tensor(left_top, dtype=self.c.dtype, device=self.c.device)
        size = torch.as_tensor(size, dtype=self.size.dtype, device=self.size.device)
        return Camera(size=size, f=self.f, c=self.c - lt, k=self.k)

    def K(self) -> torch.Tensor:
        """3x3 intrinsic matrix (index-centred convention)."""
        fx, fy = (self.f[0], self.f[1]) if self.f.ndim == 1 else (self.f[..., 0], self.f[..., 1])
        cx, cy = self.c[..., 0], self.c[..., 1]
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([torch.stack([fx, z, cx], -1), torch.stack([z, fy, cy], -1),
                            torch.stack([z, z, o], -1)], dim=-2)

    def fov_deg(self, axis: int = 0) -> torch.Tensor:
        """Field of view in degrees along ``axis`` (0 = width, 1 = height)."""
        return torch.atan2(self.size[..., axis] / 2.0, self.f[..., axis]) * 2.0 * 180.0 / torch.pi

    # -- projection -----------------------------------------------------------
    def project(self, p_cam: torch.Tensor, eps: float = 1e-4):
        """Camera-frame points (N, 3) -> (pixels (N, 2), valid (N,))."""
        z = p_cam[..., 2:3]
        in_front = z[..., 0] > eps
        z_safe = torch.where(z.abs() < eps, torch.full_like(z, eps), z)
        uv = p_cam[..., 0:2] / z_safe
        r2 = (uv * uv).sum(-1, keepdim=True)
        k1, k2 = (self.k[0], self.k[1]) if self.k.ndim == 1 else (self.k[..., 0:1], self.k[..., 1:2])
        uv_d = uv * (1.0 + r2 * (k1 + r2 * k2))
        p2d = uv_d * self.f + self.c
        return p2d, in_front & self.in_image(p2d)

    def in_image(self, p2d: torch.Tensor, pad: float = 0.0) -> torch.Tensor:
        ok = (p2d >= pad) & (p2d <= self.size - 1.0 - pad)
        return ok[..., 0] & ok[..., 1]

    def project_jacobian(self, p_cam: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
        """d p2d / d p_cam, analytic: (N, 2, 3), radial term included."""
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        z_safe = torch.where(z.abs() < eps, torch.full_like(z, eps), z)
        iz = 1.0 / z_safe
        u, v = x * iz, y * iz
        r2 = u * u + v * v
        k1, k2 = (self.k[0], self.k[1]) if self.k.ndim == 1 else (self.k[..., 0], self.k[..., 1])
        g = 1.0 + r2 * (k1 + r2 * k2)
        dg_dr2 = k1 + 2.0 * k2 * r2
        duu = g + 2.0 * dg_dr2 * u * u
        duv = 2.0 * dg_dr2 * u * v
        dvv = g + 2.0 * dg_dr2 * v * v
        fx, fy = (self.f[0], self.f[1]) if self.f.ndim == 1 else (self.f[..., 0], self.f[..., 1])
        row0 = torch.stack([fx * duu * iz, fx * duv * iz, fx * (-(duu * u + duv * v) * iz)], -1)
        row1 = torch.stack([fy * duv * iz, fy * dvv * iz, fy * (-(duv * u + dvv * v) * iz)], -1)
        return torch.stack([row0, row1], dim=-2)

    def world2image(self, T_w2c: Pose, p3d_world: torch.Tensor):
        """World points -> (pixels, valid) under a world-to-camera pose."""
        return self.project(T_w2c.transform(p3d_world))
