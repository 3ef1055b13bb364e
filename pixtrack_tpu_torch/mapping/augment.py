"""In-plane rotation augmentation of an SfM scene.

Port of ``pixtrack_tpu/mapping/augment.py``: every image is duplicated at
each roll angle with its keypoints rotated about the image centre by
``cv2.getRotationMatrix2D``'s affine, its pose rolled about the optical
axis, and every 3D point's track extended with the rolled observations.
The poses are rolled in f32 on ``device`` (None is the CUDA card), as the
JAX package rolls them (``rotate_pose_in_plane``) on its default device; the
keypoints in f64 numpy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve, true_f32
from pixtrack_tpu_torch.geometry import Pose
from pixtrack_tpu_torch.geometry.rotation import euler_rotation
from pixtrack_tpu_torch.sfm import colmap_io
from pixtrack_tpu_torch.sfm.scene import SceneModel


def rotation_affine(angle_deg: float, width: float, height: float) -> np.ndarray:
    """2x3 affine rotating image points by ``angle_deg`` about the centre
    (cv2.getRotationMatrix2D's convention: counter-clockwise with y down)."""
    cx, cy = width / 2.0, height / 2.0
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, s, (1 - c) * cx - s * cy], [-s, c, s * cx + (1 - c) * cy]])


def rotate_pose_in_plane(T_w2c: Pose, angle_deg: float) -> Pose:
    """World-to-camera pose of the camera rolled by ``angle_deg`` about its
    optical axis (the camera-in-world pose post-rotated by Rz), in f32."""
    Rz = euler_rotation(rz=angle_deg, device=T_w2c.R.device)
    c2w = T_w2c.inv()
    return Pose(R=c2w.R @ Rz, t=c2w.t).inv()


def augmented_name(name: str, angle: int) -> str:
    stem, dot, ext = name.rpartition(".")
    return f"{stem}_rot{angle:03d}.{ext}" if dot else f"{name}_rot{angle:03d}"


def augment_scene(scene: SceneModel, angles=tuple(range(30, 360, 30)), device=None) -> SceneModel:
    """A new SceneModel with every image duplicated at each roll angle:
    rotated keypoints, rolled poses (on ``device``, in true f32), and the 3D
    points' tracks extended with the augmented observations. Original image
    ids are kept; augmented ids continue after max(id)."""
    dev = resolve(device)
    cameras = dict(scene.cameras)
    images: Dict[int, colmap_io.ImageRecord] = dict(scene.images)
    next_id = int(max(scene.images.keys())) + 1
    extra_tracks: Dict[int, List[Tuple[int, int]]] = {int(pid): [] for pid in scene.point_ids}

    for iid, rec in scene.images.items():
        cam = scene.cameras[rec.camera_id]
        T = scene.pose_w2c(iid, device=dev)
        for angle in angles:
            M = rotation_affine(angle, cam.width, cam.height)
            xys_rot = np.concatenate([rec.xys, np.ones((len(rec.xys), 1))], axis=1) @ M.T
            with true_f32():
                q, t = (v.cpu() for v in rotate_pose_in_plane(T, angle).to_quat_t())
            aug_id = next_id
            next_id += 1
            images[aug_id] = colmap_io.ImageRecord(
                aug_id, q.numpy().astype(np.float64), t.numpy().astype(np.float64), rec.camera_id,
                augmented_name(rec.name, angle), xys_rot, rec.point3D_ids.copy())
            for row, pid in enumerate(rec.point3D_ids):
                if pid >= 0 and int(pid) in extra_tracks:
                    extra_tracks[int(pid)].append((aug_id, row))

    points: Dict[int, colmap_io.Point3DRecord] = {}
    for pid_key, p in scene.points3D.items():
        extra = extra_tracks.get(int(pid_key), [])
        if extra:
            image_ids = np.concatenate([p.image_ids, np.array([e[0] for e in extra], np.int32)])
            p2d_idxs = np.concatenate([p.point2D_idxs, np.array([e[1] for e in extra], np.int32)])
        else:
            image_ids, p2d_idxs = p.image_ids, p.point2D_idxs
        points[pid_key] = colmap_io.Point3DRecord(p.id, p.xyz, p.rgb, p.error, image_ids, p2d_idxs)
    return SceneModel(cameras, images, points)


def verify_augmentation_consistency(scene: SceneModel, aug: SceneModel, sample: int = 50, device=None) -> float:
    """The mean distance (pixels) between the augmented images' stored
    keypoints and their 3D points reprojected with the rolled poses (on
    ``device``), over a sample; the stored keypoints are in the corner
    convention."""
    dev = resolve(device)
    errs = []
    for iid in list(aug.images.keys()):
        rec = aug.images[iid]
        if "_rot" not in rec.name:
            continue
        cam = aug.camera(rec.camera_id, device=dev)
        T = aug.pose_w2c(iid, device=dev)
        obs = np.nonzero(rec.point3D_ids >= 0)[0][:sample]
        if len(obs) == 0:
            continue
        idxs = [aug._ptidx[int(p)] for p in rec.point3D_ids[obs] if int(p) in aug._ptidx]
        if not idxs:
            continue
        with true_f32():
            p2d, valid = cam.world2image(T, torch.as_tensor(aug.xyz[idxs], dtype=torch.float32, device=dev))
        p2d = p2d.cpu().numpy() + 0.5
        kp = rec.xys[obs[: len(idxs)]]
        v = valid.cpu().numpy()
        if v.any():
            errs.append(np.linalg.norm(p2d[v] - kp[v], axis=1).mean())
        if len(errs) > 20:
            break
    return float(np.mean(errs)) if errs else float("nan")
