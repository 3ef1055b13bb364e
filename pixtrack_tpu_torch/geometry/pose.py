"""SE(3) rigid transforms as a small dataclass of tensors.

Port of ``pixtrack_tpu/geometry/pose.py``. A ``Pose`` maps points from frame
A to frame B: ``x_b = R @ x_a + t``; a camera's world-to-camera pose follows
COLMAP.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pixtrack_tpu_torch.geometry import rotation as rot


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


@dataclasses.dataclass
class Pose:
    """Rigid transform with rotation ``R`` (..., 3, 3) and translation ``t`` (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None) -> "Pose":
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
        return cls(R=R, t=torch.zeros((*batch_shape, 3), dtype=dtype, device=device))

    @classmethod
    def from_Rt(cls, R, t, device=None) -> "Pose":
        return cls(R=_as_tensor(R, device), t=_as_tensor(t, device))

    @classmethod
    def from_quat_t(cls, qvec, tvec, device=None) -> "Pose":
        """From a COLMAP (w, x, y, z) quaternion and a translation."""
        return cls(R=rot.quat_to_rotmat(_as_tensor(qvec, device)), t=_as_tensor(tvec, device))

    @classmethod
    def from_4x4(cls, T, device=None) -> "Pose":
        T = _as_tensor(T, device)
        return cls(R=T[..., :3, :3], t=T[..., :3, 3])

    @classmethod
    def from_aa_t(cls, w, t, device=None) -> "Pose":
        """From an axis-angle rotation vector and a translation."""
        return cls(R=rot.so3_exp(_as_tensor(w, device)), t=_as_tensor(t, device))

    @classmethod
    def exp(cls, delta: torch.Tensor) -> "Pose":
        """First-order se(3) retraction ``R = exp(w), t = v`` of ``(w, v)``."""
        return cls(R=rot.so3_exp(delta[..., :3]), t=delta[..., 3:])

    def compose(self, other: "Pose") -> "Pose":
        """``self * other``: apply ``other`` first, then ``self``."""
        return Pose(R=self.R @ other.R, t=(self.R @ other.t[..., None])[..., 0] + self.t)

    def __matmul__(self, other):
        if isinstance(other, Pose):
            return self.compose(other)
        return self.transform(other)

    def inv(self) -> "Pose":
        Rt = self.R.transpose(-1, -2)
        return Pose(R=Rt, t=-(Rt @ self.t[..., None])[..., 0])

    def transform(self, points: torch.Tensor) -> torch.Tensor:
        """Apply to points (N, 3) or (3,). A batched pose (..., 3, 3) maps
        point sets (..., N, 3), broadcast over N as in the JAX package."""
        if self.R.ndim > 2 and points.ndim >= 2:
            return torch.einsum("...ij,...nj->...ni", self.R, points) + self.t[..., None, :]
        return points @ self.R.transpose(-1, -2) + self.t

    def retract(self, delta: torch.Tensor) -> "Pose":
        """Left-multiplicative update ``exp(delta) * self`` (the LM step)."""
        return Pose.exp(delta) @ self

    def to_4x4(self) -> torch.Tensor:
        top = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros_like(top[..., :1, :])
        bottom[..., 0, 3] = 1.0
        return torch.cat([top, bottom], dim=-2)

    def to_quat_t(self):
        """(COLMAP quaternion (w, x, y, z) with w >= 0, translation)."""
        return rot.rotmat_to_quat(self.R), self.t

    @property
    def center(self) -> torch.Tensor:
        """The camera center in world, if self is world-to-camera."""
        return -(self.R.transpose(-1, -2) @ self.t[..., None])[..., 0]

    def magnitude(self):
        """(rotation degrees, translation norm) of this transform."""
        dr = torch.linalg.norm(rot.so3_log(self.R), dim=-1) * (180.0 / torch.pi)
        return dr, torch.linalg.norm(self.t, dim=-1)

    def geodesic_to(self, other: "Pose") -> torch.Tensor:
        return rot.geodesic_distance(self.R, other.R)

    def where(self, cond: torch.Tensor, other: "Pose") -> "Pose":
        """``self`` where ``cond`` holds, else ``other``: a bool scalar tensor,
        or one per pose over the leading batch axes (B,)."""
        c = cond.reshape(*cond.shape, *[1] * (self.t.ndim - cond.ndim))
        return Pose(R=torch.where(c[..., None], self.R, other.R), t=torch.where(c, self.t, other.t))
