"""NeRF dataset creation from an SfM scene (the colmap2ingp role), host side.

Port of ``pixtrack_tpu/mapping/nerf_dataset.py``: the SfM -> NeRF
normalisation (up vector onto +z, cameras centred and scaled to an average
distance of 3, shifted by the least-squares point closest to every optical
axis), ``transforms.json`` in instant-ngp's layout, the scene-point crop box
in grid space, and the YAML-described rig of synthetic scenes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.geometry.nerf_transform import C_CAM, P_W, NerfTransform, nerf_to_ngp_points
from pixtrack_tpu_torch.geometry.rotation import rotmat_to_quat
from pixtrack_tpu_torch.sfm import colmap_io
from pixtrack_tpu_torch.sfm.scene import SceneModel

_CPU = torch.device("cpu")


def _rotation_aligning(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))


def closest_point_to_rays(origins: np.ndarray, dirs: np.ndarray, weights: Optional[np.ndarray] = None) -> np.ndarray:
    """The point minimising the weighted squared distance to a set of rays."""
    d = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    if weights is None:
        weights = np.ones(len(d))
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for o, dd, w in zip(origins, d, weights):
        M = np.eye(3) - np.outer(dd, dd)
        A += w * M
        b += w * M @ o
    return np.linalg.solve(A + 1e-12 * np.eye(3), b)


def _c2w_sfm(scene: SceneModel, image_id: int) -> np.ndarray:
    return scene.pose_w2c(image_id, device=_CPU).inv().to_4x4().numpy().astype(np.float64)


def compute_nerf_transform(scene: SceneModel) -> NerfTransform:
    """The similarity normalisation derived from the scene's camera rig."""
    poses = []
    for iid in scene.image_ids:
        c2w = _c2w_sfm(scene, int(iid))
        poses.append((P_W @ c2w[:3, :3] @ C_CAM, P_W @ c2w[:3, 3]))  # the axis-fixed frame
    up = np.sum([Rf[:, 1] for Rf, _ in poses], axis=0)
    up = up / np.linalg.norm(up)
    centroid = np.mean([p for _, p in poses], axis=0)
    avglen = float(np.mean([np.linalg.norm(p - centroid) for _, p in poses]))
    R3 = _rotation_aligning(up, np.array([0.0, 0.0, 1.0]))
    R4 = np.eye(4)
    R4[:3, :3] = R3
    scale = 3.0 / avglen
    origins = np.stack([R3 @ ((p - centroid) * scale) for _, p in poses])
    axes = np.stack([R3 @ (-Rf[:, 2]) for Rf, _ in poses])  # the OpenGL optical axis is -z
    totp = closest_point_to_rays(origins, axes)
    return NerfTransform(centroid=centroid, avglen=avglen, R=R4, totp=totp, up=up)


def write_transforms_json(scene: SceneModel, nerf_tf: NerfTransform, out_path, image_dir_rel: str = "mapping",
                          aabb_scale: int = 4) -> dict:
    """Write an instant-ngp-layout transforms.json for the scene's images
    (principal point in the corner convention)."""
    cam = scene.cameras[next(iter(scene.cameras))]
    c = Camera.from_colmap(cam.model, cam.params, cam.width, cam.height, device=_CPU)
    fx, fy = float(c.f[0]), float(c.f[1])
    cx, cy = float(c.c[0]) + 0.5, float(c.c[1]) + 0.5
    frames = []
    for iid in scene.image_ids:
        c2w_nerf = nerf_tf.pose_sfm_to_nerf(_c2w_sfm(scene, int(iid)))
        frames.append({"file_path": f"{image_dir_rel}/{scene.images[int(iid)].name}", "sharpness": 100.0,
                       "transform_matrix": c2w_nerf.tolist()})
    meta = {
        "camera_angle_x": float(2.0 * np.arctan2(cam.width / 2.0, fx)),
        "camera_angle_y": float(2.0 * np.arctan2(cam.height / 2.0, fy)),
        "fl_x": fx,
        "fl_y": fy,
        "k1": float(cam.params[3]) if len(cam.params) > 3 else 0.0,
        "k2": 0.0,
        "p1": 0.0,
        "p2": 0.0,
        "cx": cx,
        "cy": cy,
        "w": int(cam.width),
        "h": int(cam.height),
        "aabb_scale": int(aabb_scale),
        "frames": frames,
    }
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(meta, indent=2))
    return meta


def transforms_from_yaml(yaml_path, out_path, aabb_scale: int = 4) -> dict:
    """transforms.json (and nerf2sfm.pkl beside it) from a YAML rig (the
    pyrender2ingp role)::

        camera: {width: W, height: H, fx: _, fy: _, cx: _, cy: _}
        frames:
          - {file_path: mapping/0001.png, c2w: [[...4x4...]]}   # SfM space
    """
    import yaml

    info = yaml.safe_load(Path(yaml_path).read_text())
    cam = info["camera"]
    cameras = {1: colmap_io.CameraRecord(1, "PINHOLE", int(cam["width"]), int(cam["height"]),
                                         np.array([cam["fx"], cam["fy"], cam["cx"], cam["cy"]], np.float64))}
    images = {}
    for i, fr in enumerate(info["frames"]):
        T = Pose.from_4x4(np.linalg.inv(np.asarray(fr["c2w"], np.float64)).astype(np.float32), device=_CPU)
        images[i + 1] = colmap_io.ImageRecord(
            i + 1, rotmat_to_quat(T.R).numpy().astype(np.float64), T.t.numpy().astype(np.float64), 1,
            fr["file_path"].split("/")[-1], np.zeros((0, 2)), np.zeros(0, np.int64))
    scene = SceneModel(cameras, images, {})
    nerf_tf = compute_nerf_transform(scene)
    rel = str(Path(info["frames"][0]["file_path"]).parent)
    meta = write_transforms_json(scene, nerf_tf, out_path, image_dir_rel=rel, aabb_scale=aabb_scale)
    nerf_tf.save(Path(out_path).parent / "nerf2sfm.pkl")
    return meta


def estimate_aabb_from_scene(scene: SceneModel, nerf_tf: NerfTransform, quantile: float = 0.01,
                             margin: float = 0.05):
    """Grid-space crop box (render_aabb convention) of the scene's 3D points,
    trimmed at the ``quantile`` and grown by ``margin``."""
    pts_grid = nerf_to_ngp_points(nerf_tf.points_sfm_to_nerf(scene.xyz))
    lo = np.quantile(pts_grid, quantile, axis=0) - margin
    hi = np.quantile(pts_grid, 1 - quantile, axis=0) + margin
    return [lo.tolist(), hi.tolist()]
