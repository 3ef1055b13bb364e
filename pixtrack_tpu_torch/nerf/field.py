"""View-direction encoding shared by the distilled field and kernel K1.

Port of ``sh_encoding_deg4_T`` from ``pixtrack_tpu/nerf/field.py``; the hash
grid field there is not ported yet.
"""

from __future__ import annotations

import torch


def sh_encoding_deg4_T(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to degree 4, feature-major: (3, N) -> (16, N)."""
    x, y, z = d[0], d[1], d[2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    return torch.stack(
        [
            0.28209479177387814 * one,
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ],
        dim=0,
    )
