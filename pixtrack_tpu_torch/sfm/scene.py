"""SceneModel: an SfM scene packed into flat numpy arrays.

Port of ``pixtrack_tpu/sfm/scene.py`` over the port's ``colmap_io``. The
host-side arrays (numpy, scipy.sparse) are unchanged; only ``Pose`` and
``Camera`` are the torch ones.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from pixtrack_tpu_torch.sfm import colmap_io
from pixtrack_tpu_torch.geometry import Camera, Pose


class SceneModel:
    """SfM scene with packed arrays, loaded from a COLMAP model."""

    def __init__(self, cameras, images, points3D):
        self.cameras = cameras
        self.images = images
        self.points3D = points3D

        self.image_ids = np.array(sorted(images.keys()), np.int64)
        self._imgidx = {int(i): k for k, i in enumerate(self.image_ids)}
        n = len(self.image_ids)
        self.qvecs = np.zeros((n, 4))
        self.tvecs = np.zeros((n, 3))
        self.camera_ids = np.zeros(n, np.int64)
        self.names = []
        for k, iid in enumerate(self.image_ids):
            im = images[int(iid)]
            self.qvecs[k] = im.qvec
            self.tvecs[k] = im.tvec
            self.camera_ids[k] = im.camera_id
            self.names.append(im.name)
        self.name2id = {nm: int(i) for nm, i in zip(self.names, self.image_ids)}

        self.point_ids = np.array(sorted(points3D.keys()), np.int64)
        m = len(self.point_ids)
        self.xyz = np.zeros((m, 3))
        self.track_lengths = np.zeros(m, np.int64)
        rows, cols = [], []
        for k, pid in enumerate(self.point_ids):
            p = points3D[int(pid)]
            self.xyz[k] = p.xyz
            self.track_lengths[k] = len(p.image_ids)
            for iid in p.image_ids:
                ii = self._imgidx.get(int(iid))
                if ii is not None:
                    rows.append(ii)
                    cols.append(k)
        self.incidence = sp.csr_matrix(
            (np.ones(len(rows), np.int32), (rows, cols)), shape=(n, m), dtype=np.int32
        )
        # a point observed twice in one image counts once
        self.incidence.data = np.minimum(self.incidence.data, 1)

    @classmethod
    def load(cls, path) -> "SceneModel":
        return cls(*colmap_io.read_model(path))

    def pose_w2c(self, image_id: int, device=None) -> Pose:
        k = self._imgidx[int(image_id)]
        return Pose.from_quat_t(
            self.qvecs[k].astype(np.float32), self.tvecs[k].astype(np.float32), device
        )

    def camera(self, camera_id: int, device=None) -> Camera:
        rec = self.cameras[int(camera_id)]
        return Camera.from_colmap(rec.model, rec.params, rec.width, rec.height, device)

    def p3d_indices_for_images(
        self, image_ids: Sequence[int], min_track_length: int = 1
    ) -> np.ndarray:
        """Indices of the points observed by any of ``image_ids`` with a
        track of at least ``min_track_length``."""
        rows = [self._imgidx[int(i)] for i in image_ids if int(i) in self._imgidx]
        if not rows:
            return np.zeros(0, np.int64)
        seen = np.asarray(self.incidence[rows].sum(axis=0)).ravel() > 0
        return np.nonzero(seen & (self.track_lengths >= min_track_length))[0].astype(np.int64)

    def covisibility_dict(self, threshold: int = 0) -> Dict[str, Dict[str, int]]:
        """{name: {other_name: shared point count}} (the covis.pkl layout)."""
        cov = (self.incidence @ self.incidence.T).tocsr()
        cov.setdiag(0)
        cov.eliminate_zeros()
        cov = cov.tocoo()
        out: Dict[str, Dict[str, int]] = {nm: {} for nm in self.names}
        for i, j, v in zip(cov.row, cov.col, cov.data):
            if v > threshold:
                out[self.names[i]][self.names[j]] = int(v)
        return out

    def pack_points(
        self, indices: np.ndarray, pad_to: Optional[int] = None, pad_multiple: int = 512
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(xyz (P, 3) f32, valid (P,) bool), padded to a multiple of
        ``pad_multiple``; keeps the longest tracks when cut."""
        n = len(indices)
        if pad_to is None:
            pad_to = max(pad_multiple, int(np.ceil(n / pad_multiple)) * pad_multiple)
        if n > pad_to:
            order = np.argsort(-self.track_lengths[indices])
            indices = indices[order[:pad_to]]
            n = pad_to
        xyz = np.zeros((pad_to, 3), np.float32)
        xyz[:n] = self.xyz[indices].astype(np.float32)
        mask = np.zeros(pad_to, bool)
        mask[:n] = True
        return xyz, mask

    def __repr__(self):
        return (
            f"SceneModel(images={len(self.image_ids)}, "
            f"points={len(self.point_ids)}, cameras={len(self.cameras)})"
        )
