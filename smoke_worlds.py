"""Geometry of the two tracking worlds that ``chip_smoke.py`` drives, in numpy.

The blob world's SfM-space surface points and the look-at poses that both
worlds' ground-truth orbits are built from (the same definitions as
``tests/synthetic_world.py``, which needs JAX). The mesh world's points come
from ``pixtrack_tpu_torch.mapping.mesh_render.sample_mesh_surface``. Test
fixtures, not part of the package: ``chip_smoke.py`` and the port's tests
import this file from the repository root.
"""

from __future__ import annotations

import numpy as np

from pixtrack_tpu_torch.geometry import nerf_transform
from pixtrack_tpu_torch.geometry import Pose

# the blob object in grid space (nerf.dataset.blob_scene of the JAX package)
BLOB_CENTERS_GRID = np.array([[0.5, 0.5, 0.5], [0.58, 0.54, 0.46], [0.45, 0.44, 0.56]])
BLOB_RADII_GRID = np.array([0.10, 0.07, 0.06])


def look_at_w2c(center, target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]), device=None) -> Pose:
    """OpenCV-convention world-to-camera pose looking from center at target."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0).astype(np.float32)
    return Pose.from_Rt(R, (-R @ center).astype(np.float32), device=device)


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    phi = np.arccos(1 - 2 * (i + 0.5) / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=1)


def grid_to_sfm(x_grid: np.ndarray) -> np.ndarray:
    """Grid [0, 1]^3 -> SfM coordinates under the identity NerfTransform."""
    x_nerf = nerf_transform.ngp_to_nerf_points(x_grid)
    return (x_nerf @ nerf_transform.P_W).astype(np.float32)


def sphere_surface_points(n: int = 400) -> np.ndarray:
    """Points on the blob's visible outer shell, in SfM space."""
    per = n // len(BLOB_RADII_GRID)
    pts = []
    for c, r in zip(BLOB_CENTERS_GRID, BLOB_RADII_GRID):
        cand = c + _fibonacci_sphere(per * 2) * r
        d = np.linalg.norm(cand[:, None, :] - BLOB_CENTERS_GRID, axis=-1)
        outside = (d >= BLOB_RADII_GRID * 0.995).sum(1) >= 2
        pts.append(cand[outside][:per])
    return grid_to_sfm(np.concatenate(pts))
