"""SfM <-> NeRF coordinate transforms.

The reference scatters one similarity transform across three files
(pixtrack/utils/ingp_utils.py:47-83, pixtrack/utils/colmap2ingp.py:284-350,
instant-ngp internals). Here it is encoded once as an explicit composition:

    x_nerf = R_up @ ( s * (P_w @ x_sfm - centroid) ) - totp
    with   P_w = world axis fix   = [[0,1,0],[1,0,0],[0,0,-1]]
           s   = 3 / avglen
    and camera-to-world matrices additionally right-multiplied by
           C = diag(1,-1,-1)      (OpenCV -> OpenGL camera axes)

plus the instant-ngp *internal* unit-cube space used by ``render_aabb``
(OBJ_AABB config values live in this space, ingp_utils.py:41-42,102-107):

    x_ngp = (x_nerf / 3 + 0.5) permuted by [1, 2, 0]

The parameters (up, centroid, avglen, totp, R) are produced at asset-creation
time (see pixtrack_tpu.mapping.nerf_dataset) and persisted in the same
``nerf2sfm.pkl`` dict format the reference writes (colmap2ingp.py:356-371) so
assets interoperate.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Union

import numpy as np

# World axis fix applied to SfM world coordinates (rows of the c2w matrix):
# swap x/y, negate z — colmap2nerf's axis convention.
P_W = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
# Camera axis fix applied to camera axes (columns of the c2w matrix):
# flip y and z — OpenCV (x right, y down, z forward) to OpenGL (y up, z back).
C_CAM = np.diag([1.0, -1.0, -1.0])


@dataclasses.dataclass
class NerfTransform:
    """Similarity transform between SfM world and NeRF (transforms.json) world."""

    centroid: np.ndarray  # (3,)
    avglen: float
    R: np.ndarray  # (4, 4) up-alignment rotation (homogeneous, as stored)
    totp: np.ndarray  # (3,) center-of-attention shift
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0.0, 1.0]))

    # -- persistence (reference-compatible dict pickle) -----------------------
    @classmethod
    def load(cls, path) -> "NerfTransform":
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(
            centroid=np.asarray(d["centroid"], np.float64),
            avglen=float(d["avglen"]),
            R=np.asarray(d["R"], np.float64),
            totp=np.asarray(d["totp"], np.float64),
            up=np.asarray(d.get("up", [0.0, 0.0, 1.0]), np.float64),
        )

    def save(self, path) -> None:
        d = {
            "up": np.asarray(self.up),
            "centroid": np.asarray(self.centroid),
            "avglen": float(self.avglen),
            "totp": np.asarray(self.totp),
            "R": np.asarray(self.R),
        }
        with open(path, "wb") as f:
            pickle.dump(d, f)

    @classmethod
    def identity(cls) -> "NerfTransform":
        return cls(
            centroid=np.zeros(3), avglen=3.0, R=np.eye(4), totp=np.zeros(3)
        )

    # -- derived --------------------------------------------------------------
    @property
    def scale(self) -> float:
        return 3.0 / self.avglen

    @property
    def R3(self) -> np.ndarray:
        return np.asarray(self.R)[:3, :3]

    # -- point maps -----------------------------------------------------------
    def points_sfm_to_nerf(self, x: np.ndarray) -> np.ndarray:
        """(..., 3) SfM world -> NeRF world."""
        x = np.asarray(x, np.float64)
        y = x @ P_W.T
        y = (y - self.centroid) * self.scale
        y = y @ self.R3.T
        return y - self.totp

    def points_nerf_to_sfm(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        y = (x + self.totp) @ self.R3
        y = y / self.scale + self.centroid
        return y @ P_W  # P_W is symmetric and orthogonal, so P_W^-1 = P_W^T = P_W

    # -- pose maps (4x4 camera-to-world) ---------------------------------------
    def pose_sfm_to_nerf(self, c2w: np.ndarray) -> np.ndarray:
        """SfM camera-to-world (4, 4) -> NeRF camera-to-world (4, 4)."""
        c2w = np.asarray(c2w, np.float64)
        Rm = P_W @ c2w[:3, :3] @ C_CAM
        t = self.points_sfm_to_nerf(c2w[:3, 3])
        out = np.eye(4)
        out[:3, :3] = self.R3 @ Rm
        out[:3, 3] = t
        return out

    def pose_nerf_to_sfm(self, c2w_nerf: np.ndarray) -> np.ndarray:
        c2w_nerf = np.asarray(c2w_nerf, np.float64)
        Rm = self.R3.T @ c2w_nerf[:3, :3]
        out = np.eye(4)
        out[:3, :3] = P_W.T @ Rm @ C_CAM  # C_CAM^-1 == C_CAM
        out[:3, 3] = self.points_nerf_to_sfm(c2w_nerf[:3, 3])
        return out


# -- instant-ngp internal unit-cube space -------------------------------------
# transforms.json world -> ngp render space (where render_aabb / OBJ_AABB live).
_NGP_PERM = np.array([1, 2, 0])
_NGP_PERM_INV = np.array([2, 0, 1])


def nerf_to_ngp_points(x: np.ndarray, aabb_scale: float = 1.0) -> np.ndarray:
    """NeRF (transforms.json) coords -> ngp internal coords.

    Evidence for the convention: ingp_utils.get_nerf_aabb_from_sfm
    (reference ingp_utils.py:102-107) computes AABBs as x/3 + 0.5 with axes
    reordered [1, 2, 0].
    """
    x = np.asarray(x, np.float64)
    y = x / 3.0 + 0.5
    return y[..., _NGP_PERM]


def ngp_to_nerf_points(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    y = x[..., _NGP_PERM_INV]
    return (y - 0.5) * 3.0


def nerf_to_ngp_pose(c2w: np.ndarray) -> np.ndarray:
    """NeRF c2w -> ngp-internal c2w (axes cycled, translation mapped)."""
    c2w = np.asarray(c2w, np.float64)
    out = np.eye(4)
    out[:3, :3] = c2w[:3, :3][_NGP_PERM, :]
    out[:3, 3] = nerf_to_ngp_points(c2w[:3, 3])
    return out


def ngp_to_nerf_pose(c2w_ngp: np.ndarray) -> np.ndarray:
    c2w_ngp = np.asarray(c2w_ngp, np.float64)
    out = np.eye(4)
    out[:3, :3] = c2w_ngp[:3, :3][_NGP_PERM_INV, :]
    out[:3, 3] = ngp_to_nerf_points(c2w_ngp[:3, 3])
    return out


PathLike = Union[str, bytes]
