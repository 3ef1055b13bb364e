"""Multi-view triangulation against known poses.

Port of ``pixtrack_tpu/mapping/triangulate.py``: tracks are built by
union-find over the pairwise matches (host Python, the same insertion order
and so the same tracks and point ids), then every track is triangulated in
one batched, padded normal-equation DLT in f32 on the device
(``torch.linalg.solve``, ridge 1e-9), and the reprojection, cheirality and
triangulation-angle filter runs in f64 numpy on the host, as in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve, true_f32
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.sfm import colmap_io
from pixtrack_tpu_torch.sfm.scene import SceneModel

_CPU = torch.device("cpu")


class _UnionFind:
    def __init__(self):
        self.parent: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        if p != x:
            p = self.find(p)
            self.parent[x] = p
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(keypoints: Dict[int, np.ndarray], matches: Dict[Tuple[int, int], np.ndarray],
                 min_track_length: int = 2) -> List[List[Tuple[int, int]]]:
    """Union-find over matches -> tracks of (image_id, keypoint_idx); a track
    with two observations in one image is inconsistent and dropped."""
    uf = _UnionFind()
    for (i0, i1), m0 in matches.items():
        for k0 in np.nonzero(m0 >= 0)[0]:
            uf.union((i0, int(k0)), (i1, int(m0[k0])))
    groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for (img, kp_idx) in list(uf.parent.keys()):
        root = uf.find((img, kp_idx))
        groups.setdefault(root, []).append((img, kp_idx))
    tracks = []
    for obs in groups.values():
        imgs = [o[0] for o in obs]
        if len(obs) >= min_track_length and len(set(imgs)) == len(imgs):
            tracks.append(sorted(obs))
    return tracks


def _triangulate_padded(P_stack: torch.Tensor, uv_stack: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Batched DLT over padded tracks: P_stack (T, V, 3, 4), uv_stack (T, V,
    2), mask (T, V). Normal equations of the inhomogeneous DLT (x, y, z, 1),
    each observation contributing the rows u P3 - P1 and v P3 - P2."""
    p1, p2, p3 = P_stack[..., 0, :], P_stack[..., 1, :], P_stack[..., 2, :]
    r1 = uv_stack[..., 0:1] * p3 - p1  # (T, V, 4)
    r2 = uv_stack[..., 1:2] * p3 - p2
    rows = torch.cat([r1, r2], dim=1) * torch.cat([mask, mask], dim=1)[..., None]  # (T, 2V, 4)
    A, b = rows[..., :3], -rows[..., 3]
    with true_f32():
        AtA = torch.einsum("tvi,tvj->tij", A, A)
        Atb = torch.einsum("tvi,tv->ti", A, b)
    AtA = AtA + 1e-9 * torch.eye(3, dtype=AtA.dtype, device=AtA.device)
    return torch.linalg.solve(AtA, Atb[..., None])[..., 0]


def triangulate_tracks(tracks: List[List[Tuple[int, int]]], keypoints: Dict[int, np.ndarray],
                       poses: Dict[int, Pose], cameras: Dict[int, Camera], camera_for_image: Dict[int, int],
                       max_reproj_error: float = 4.0, min_tri_angle_deg: float = 0.5, device=None,
                       ) -> Tuple[np.ndarray, List[List[Tuple[int, int]]], np.ndarray]:
    """Triangulate tracks on ``device`` (None is the CUDA card); returns
    (xyz (M, 3), kept_tracks, mean reprojection errors (M,))."""
    if not tracks:
        return np.zeros((0, 3)), [], np.zeros(0)
    V = max(len(t) for t in tracks)
    T = len(tracks)
    P_stack = np.zeros((T, V, 3, 4), np.float64)
    uv_stack = np.zeros((T, V, 2), np.float64)
    mask = np.zeros((T, V), np.float64)
    Pmats = {}
    for iid, pose in poses.items():
        K = cameras[camera_for_image[iid]].K().to(_CPU).numpy().astype(np.float64)
        Rt = np.concatenate([pose.R.to(_CPU).numpy().astype(np.float64),
                             pose.t.to(_CPU).numpy().astype(np.float64)[:, None]], axis=1)
        Pmats[iid] = K @ Rt
    for ti, track in enumerate(tracks):
        for vi, (iid, kidx) in enumerate(track):
            P_stack[ti, vi] = Pmats[iid]
            uv_stack[ti, vi] = keypoints[iid][kidx]
            mask[ti, vi] = 1.0

    dev = resolve(device)
    xyz = _triangulate_padded(*(torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (P_stack, uv_stack, mask)))
    xyz = xyz.cpu().numpy().astype(np.float64)

    # vectorised reprojection filter
    xyzh = np.concatenate([xyz, np.ones((T, 1))], axis=1)
    proj = np.einsum("tvij,tj->tvi", P_stack, xyzh)  # (T, V, 3)
    z = proj[..., 2]
    uv_hat = proj[..., :2] / np.where(np.abs(z[..., None]) < 1e-9, 1e-9, z[..., None])
    err = np.linalg.norm(uv_hat - uv_stack, axis=-1)
    err = np.where(mask > 0, err, 0.0)
    nobs = mask.sum(axis=1)
    mean_err = err.sum(axis=1) / np.maximum(nobs, 1)
    in_front = np.all((z > 1e-6) | (mask == 0), axis=1)

    # triangulation angle: the largest angle between two viewing rays
    centers = {iid: p.center.to(_CPU).numpy().astype(np.float64) for iid, p in poses.items()}
    good_angle = np.zeros(T, bool)
    for ti, track in enumerate(tracks):
        cs = np.stack([centers[iid] for iid, _ in track])
        rays = xyz[ti][None] - cs
        rays /= np.linalg.norm(rays, axis=1, keepdims=True).clip(1e-12)
        ang = np.degrees(np.arccos(np.clip(rays @ rays.T, -1, 1)))
        good_angle[ti] = ang.max() > min_tri_angle_deg

    keep = (mean_err < max_reproj_error) & in_front & good_angle
    kept_tracks = [t for t, k in zip(tracks, keep) if k]
    return xyz[keep], kept_tracks, mean_err[keep]


def triangulate_scene(images: Dict[int, dict], keypoints: Dict[int, np.ndarray],
                      matches: Dict[Tuple[int, int], np.ndarray], cameras: Dict[int, colmap_io.CameraRecord],
                      min_track_length: int = 2, max_reproj_error: float = 4.0, device=None) -> SceneModel:
    """A SceneModel triangulated from matches against known poses.

    ``images``: {image_id: {"name", "qvec", "tvec", "camera_id"}};
    ``keypoints`` in COLMAP's corner convention."""
    tracks = build_tracks(keypoints, matches, min_track_length)
    poses = {iid: Pose.from_quat_t(np.asarray(im["qvec"], np.float32), np.asarray(im["tvec"], np.float32))
             for iid, im in images.items()}
    cams = {cid: Camera.from_colmap(rec.model, rec.params, rec.width, rec.height) for cid, rec in cameras.items()}
    cam_for_img = {iid: im["camera_id"] for iid, im in images.items()}
    # the Camera projects index-centred: shift the observations by -0.5
    kp_ic = {iid: np.asarray(kp, np.float64) - 0.5 for iid, kp in keypoints.items()}
    xyz, kept, errs = triangulate_tracks(tracks, kp_ic, poses, cams, cam_for_img,
                                         max_reproj_error=max_reproj_error, device=device)

    img_records: Dict[int, colmap_io.ImageRecord] = {}
    obs_per_image: Dict[int, List[Tuple[float, float, int]]] = {iid: [] for iid in images}
    point_records: Dict[int, colmap_io.Point3DRecord] = {}
    for pid, (track, p, e) in enumerate(zip(kept, xyz, errs)):
        iids, idxs = [], []
        for (iid, kidx) in track:
            idxs.append(len(obs_per_image[iid]))
            obs_per_image[iid].append((keypoints[iid][kidx][0], keypoints[iid][kidx][1], pid))
            iids.append(iid)
        point_records[pid] = colmap_io.Point3DRecord(
            pid, p, np.array([128, 128, 128], np.uint8), float(e), np.array(iids, np.int32), np.array(idxs, np.int32))
    for iid, im in images.items():
        obs = obs_per_image[iid]
        xys = np.array([(x, y) for x, y, _ in obs]).reshape(-1, 2)
        p3ds = np.array([p for _, _, p in obs], np.int64)
        img_records[iid] = colmap_io.ImageRecord(
            iid, np.asarray(im["qvec"], np.float64), np.asarray(im["tvec"], np.float64), im["camera_id"], im["name"],
            xys, p3ds)
    return SceneModel(cameras, img_records, point_records)
