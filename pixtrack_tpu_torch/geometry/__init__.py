"""Geometry core: rotations, SE(3) poses and cameras on torch tensors."""

from pixtrack_tpu_torch.geometry.rotation import (
    geodesic_distance,
    euler_rotation,
    quat_to_rotmat,
    rotmat_to_quat,
    so3_exp,
    so3_hat,
    so3_log,
)
from pixtrack_tpu_torch.geometry.pose import Pose
from pixtrack_tpu_torch.geometry.camera import CAMERA_MODEL_IDS, CAMERA_MODEL_NUM_PARAMS, Camera

__all__ = [
    "so3_hat",
    "so3_exp",
    "so3_log",
    "quat_to_rotmat",
    "rotmat_to_quat",
    "euler_rotation",
    "geodesic_distance",
    "Pose",
    "Camera",
    "CAMERA_MODEL_IDS",
    "CAMERA_MODEL_NUM_PARAMS",
]
