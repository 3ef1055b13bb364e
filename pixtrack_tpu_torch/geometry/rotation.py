"""SO(3) utilities on torch tensors (batched over leading axes).

Port of ``pixtrack_tpu/geometry/rotation.py``. Quaternions use the
COLMAP/Hamilton ``(w, x, y, z)`` order.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``w`` (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with series expansions near the identity."""
    theta2 = (w * w).sum(-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    K = so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    scale = torch.where(
        theta < 1e-4,
        0.5 + theta * theta / 12.0,
        theta / torch.clamp(2.0 * torch.sin(theta), min=_EPS),
    )
    return v * scale[..., None]


def geodesic_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle (radians) between two rotations, batched."""
    Rd = R1 @ R2.transpose(-1, -2)
    trace = Rd[..., 0, 0] + Rd[..., 1, 1] + Rd[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """COLMAP quaternion (w, x, y, z) (..., 4) -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> COLMAP quaternion (w, x, y, z) (..., 4).

    Shepperd's method: of the four candidate solutions the one whose own
    component is largest is taken; the sign is the one with w >= 0.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    traces = torch.stack(
        [1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1
    )
    sw, sx, sy, sz = (torch.sqrt(torch.clamp(traces, min=_EPS)) * 0.5).unbind(-1)
    # candidate k holds (w, x, y, z) computed from component k
    cands = torch.stack(
        [
            torch.stack([sw, (m21 - m12) / (4 * sw), (m02 - m20) / (4 * sw), (m10 - m01) / (4 * sw)], -1),
            torch.stack([(m21 - m12) / (4 * sx), sx, (m01 + m10) / (4 * sx), (m02 + m20) / (4 * sx)], -1),
            torch.stack([(m02 - m20) / (4 * sy), (m01 + m10) / (4 * sy), sy, (m12 + m21) / (4 * sy)], -1),
            torch.stack([(m10 - m01) / (4 * sz), (m02 + m20) / (4 * sz), (m12 + m21) / (4 * sz), sz], -1),
        ],
        dim=-2,
    )
    choice = traces.argmax(dim=-1)
    q = torch.gather(cands, -2, choice[..., None, None].expand(*choice.shape, 1, 4))[..., 0, :]
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def euler_rotation(rz: float = 0.0, ry: float = 0.0, rx: float = 0.0, degrees: bool = True,
                   device=None) -> torch.Tensor:
    """``Rz @ Ry @ Rx`` (3, 3), the order in which camera-in-world poses are post-rotated."""
    f = torch.pi / 180.0 if degrees else 1.0
    a = torch.tensor([rz * f, ry * f, rx * f], dtype=torch.float32, device=device)
    (cz, cy, cx), (sz, sy, sx) = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(cz), torch.zeros_like(cz)
    Rz = torch.stack([cz, -sz, z, sz, cz, z, z, z, o]).reshape(3, 3)
    Ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy]).reshape(3, 3)
    Rx = torch.stack([o, z, z, z, cx, -sx, z, sx, cx]).reshape(3, 3)
    return Rz @ Ry @ Rx
