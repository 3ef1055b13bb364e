"""The world of the ``demo`` subcommand: everything the tracker needs, with
no data and no trained field.

The JAX package's ``demo`` builds it from ``tests/synthetic_world.py``; the
port keeps its own copy of what that needs: an analytic object (three
overlapping balls, ``nerf.dataset.blob_scene_T``) served through the
Testbed, a consistent synthetic SfM model of its surface points seen from a
ring of 12 references, a smooth ground-truth query orbit, and query frames
rendered from it. Geometry: with the identity NerfTransform, SfM space is
NeRF space under the axis swap (x, y, z) -> (y, x, -z), and grid space a
further x3 scale, so the object sits near the SfM origin, ~0.3 units across.
"""

from __future__ import annotations

import numpy as np
import torch

from pixtrack_tpu_torch.geometry import Camera, Pose, nerf_transform
from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
from pixtrack_tpu_torch.nerf.dataset import blob_scene_T
from pixtrack_tpu_torch.nerf.testbed import Testbed
from pixtrack_tpu_torch.sfm import colmap_io
from pixtrack_tpu_torch.sfm.scene import SceneModel

# the blob in grid space (nerf.dataset.blob_scene_T)
BLOB_CENTERS_GRID = np.array([[0.5, 0.5, 0.5], [0.58, 0.54, 0.46], [0.45, 0.44, 0.56]])
BLOB_RADII_GRID = np.array([0.10, 0.07, 0.06])


class AnalyticBlobField:
    """The analytic blob as a render field: the staged render calls ``field_T``."""

    def field_T(self, xT: torch.Tensor, dT: torch.Tensor = None):
        return blob_scene_T(xT)


def make_testbed(device, n_coarse: int = 96) -> Testbed:
    tb = Testbed(device=device)
    tb.set_field(AnalyticBlobField())
    tb.render_aabb.min = [0.3, 0.3, 0.3]
    tb.render_aabb.max = [0.7, 0.7, 0.7]
    tb.n_coarse = n_coarse
    tb.n_fine = 0
    return tb


def look_at_w2c(center: np.ndarray, target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]), device=None) -> Pose:
    """OpenCV-convention world-to-camera pose looking from center at target."""
    z = target - center
    z = z / np.linalg.norm(z)  # camera z: forward
    x = np.cross(z, up)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0).astype(np.float32)  # rows: world->cam
    return Pose.from_Rt(R, (-R @ center).astype(np.float32), device=device)


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    phi = np.arccos(1 - 2 * (i + 0.5) / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=1)


def grid_to_sfm(x_grid: np.ndarray) -> np.ndarray:
    """Grid [0, 1]^3 -> SfM coordinates under the identity NerfTransform."""
    x_nerf = nerf_transform.ngp_to_nerf_points(x_grid)
    return (x_nerf @ nerf_transform.P_W).astype(np.float32)  # P_W symmetric orthogonal


def sphere_surface_points(n: int = 400) -> np.ndarray:
    """Points on the blob's visible outer shell, in SfM space."""
    per = n // len(BLOB_RADII_GRID)
    pts = []
    for c, r in zip(BLOB_CENTERS_GRID, BLOB_RADII_GRID):
        cand = c + _fibonacci_sphere(per * 2) * r
        # keep the points inside no OTHER sphere (the visible shell)
        d = np.linalg.norm(cand[:, None, :] - BLOB_CENTERS_GRID, axis=-1)
        outside = (d >= BLOB_RADII_GRID * 0.995).sum(1) >= 2
        pts.append(cand[outside][:per])
    return grid_to_sfm(np.concatenate(pts))


def make_scene(camera: Camera, n_refs: int = 12, n_points: int = 400, dist: float = 1.6) -> SceneModel:
    """Synthetic SfM model: a ring of reference views observing surface points."""
    p3d = sphere_surface_points(n_points)
    cameras = {1: colmap_io.CameraRecord(1, "PINHOLE", int(float(camera.width)), int(float(camera.height)),
                                         np.array([float(camera.f[0]), float(camera.f[1]),
                                                   float(camera.c[0]) + 0.5, float(camera.c[1]) + 0.5]))}
    centers_sfm = grid_to_sfm(BLOB_CENTERS_GRID)
    d2c = np.linalg.norm(p3d[:, None, :] - centers_sfm[None], axis=-1)
    normals = p3d - centers_sfm[np.argmin(d2c, axis=1)]
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-9)
    images, tracks = {}, {k: ([], []) for k in range(n_points)}
    for i in range(n_refs):
        ang = 2 * np.pi * i / n_refs
        el = 0.25 * np.sin(3 * ang)
        center = dist * np.array([np.cos(el) * np.sin(ang), np.sin(el), np.cos(el) * np.cos(ang)])
        T = look_at_w2c(center, device=camera.f.device)
        p2d, valid = camera.world2image(T, torch.as_tensor(p3d, device=camera.f.device))
        p2d, valid = p2d.cpu().numpy(), valid.cpu().numpy()
        # visibility: the points whose outward normal faces the camera
        towards = (center[None, :] - p3d) / np.linalg.norm(center[None, :] - p3d, axis=1, keepdims=True)
        obs = np.nonzero(valid & ((normals * towards).sum(1) > 0.1))[0]
        q, t = T.to_quat_t()
        for row, pid in enumerate(obs):
            tracks[int(pid)][0].append(i + 1)
            tracks[int(pid)][1].append(row)
        images[i + 1] = colmap_io.ImageRecord(i + 1, np.asarray(q.cpu(), np.float64), np.asarray(t.cpu(), np.float64),
                                              1, f"ref_{i:04d}.png", p2d[obs], obs.astype(np.int64))
    points = {pid: colmap_io.Point3DRecord(pid, p3d[pid].astype(np.float64), np.array([128, 128, 128], np.uint8), 0.1,
                                           np.array(iids, np.int32), np.array(idxs, np.int32))
              for pid, (iids, idxs) in tracks.items() if iids}
    return SceneModel(cameras, images, points)


def gt_trajectory(n_frames: int = 10, dist: float = 1.6, device=None):
    """Smooth ground-truth w2c query trajectory around the object."""
    poses = []
    for i in range(n_frames):
        ang = 0.04 * i
        el = 0.08 * np.sin(0.5 * i)
        center = dist * np.array([np.cos(el) * np.sin(ang), np.sin(el), np.cos(el) * np.cos(ang)])
        poses.append(look_at_w2c(center, device=device))
    return poses


def build_world(res: int = 128, n_frames: int = 8, device=None):
    """(scene, testbed, nerf2sfm, camera, gt_poses, frames) on ``device``
    (None is the CUDA card); frames are (name, uint8 image) renders of the
    ground-truth poses."""
    from pixtrack_tpu_torch.tracking.render_bridge import render_nerf_view

    testbed = make_testbed(device)
    dev = testbed.device
    camera = Camera.pinhole(res * 1.1, res * 1.1, (res - 1) / 2, (res - 1) / 2, res, res, device=dev)
    nerf2sfm = NerfTransform.identity()
    scene = make_scene(camera)
    gt = gt_trajectory(n_frames, device=dev)
    frames = [(f"frame_{i:04d}.png", render_nerf_view(testbed, nerf2sfm, T, camera, spp=1)) for i, T in enumerate(gt)]
    return scene, testbed, nerf2sfm, camera, gt, frames
