"""COLMAP-compatible SQLite database (database.db) reader/writer.

Port of ``pixtrack_tpu/sfm/database.py`` (stdlib ``sqlite3``, no JAX in
it): a copy, so that either package opens the other's files.

A first-party implementation of the public COLMAP database schema (the
reference reaches it through hloc's COLMAPDatabase, used at
pixtrack/utils/hloc_utils.py:23,180-210 to import augmented features and
matches). Python's stdlib sqlite3 is the right native backend here — the
reference's own writer is also a thin SQLite shim.
"""

from __future__ import annotations

import sqlite3
from typing import Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def pair_id_from_image_ids(id1: int, id2: int) -> int:
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * MAX_IMAGE_ID + id2


def image_ids_from_pair_id(pair_id: int) -> Tuple[int, int]:
    return pair_id // MAX_IMAGE_ID, pair_id % MAX_IMAGE_ID


def _blob(arr: np.ndarray, dtype) -> bytes:
    return np.ascontiguousarray(arr, dtype).tobytes()


class ColmapDatabase:
    """Thin typed wrapper over the COLMAP database.db schema."""

    def __init__(self, path):
        self.conn = sqlite3.connect(str(path))
        self.conn.executescript(_SCHEMA)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self.conn.commit()
        self.conn.close()

    # ---- cameras ----
    def add_camera(
        self,
        model_id: int,
        width: int,
        height: int,
        params: np.ndarray,
        camera_id: Optional[int] = None,
        prior_focal_length: bool = False,
    ) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (
                camera_id,
                model_id,
                int(width),
                int(height),
                _blob(np.asarray(params), np.float64),
                int(prior_focal_length),
            ),
        )
        return cur.lastrowid

    # ---- images ----
    def add_image(
        self,
        name: str,
        camera_id: int,
        prior_q: Optional[np.ndarray] = None,
        prior_t: Optional[np.ndarray] = None,
        image_id: Optional[int] = None,
    ) -> int:
        q = [None] * 4 if prior_q is None else [float(x) for x in prior_q]
        t = [None] * 3 if prior_t is None else [float(x) for x in prior_t]
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *q, *t),
        )
        return cur.lastrowid

    # ---- keypoints / descriptors ----
    def add_keypoints(self, image_id: int, keypoints: np.ndarray) -> None:
        kp = np.asarray(keypoints, np.float32)
        if kp.ndim != 2 or kp.shape[1] not in (2, 4, 6):
            raise ValueError("keypoints must be (N, 2|4|6)")
        if kp.shape[1] == 2:
            # COLMAP expects affine keypoints; extend with scale=1, ori=0.
            kp = np.concatenate(
                [kp, np.ones_like(kp[:, :1]), np.zeros_like(kp[:, :1])], axis=1
            )
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], kp.shape[1], _blob(kp, np.float32)),
        )

    def add_descriptors(self, image_id: int, descriptors: np.ndarray) -> None:
        d = np.asarray(descriptors, np.uint8)
        self.conn.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, d.shape[0], d.shape[1], _blob(d, np.uint8)),
        )

    # ---- matches ----
    def add_matches(self, id1: int, id2: int, matches: np.ndarray) -> None:
        m = np.asarray(matches, np.uint32)
        if id1 > id2:
            m = m[:, ::-1]
        pid = pair_id_from_image_ids(id1, id2)
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (pid, m.shape[0], 2, _blob(m, np.uint32)),
        )

    def add_two_view_geometry(
        self, id1: int, id2: int, matches: np.ndarray, config: int = 2,
        F=None, E=None, H=None,
    ) -> None:
        m = np.asarray(matches, np.uint32)
        if id1 > id2:
            m = m[:, ::-1]
        pid = pair_id_from_image_ids(id1, id2)
        eye = np.eye(3)
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                pid, m.shape[0], 2, _blob(m, np.uint32), config,
                _blob(eye if F is None else F, np.float64),
                _blob(eye if E is None else E, np.float64),
                _blob(eye if H is None else H, np.float64),
                _blob(np.array([1.0, 0, 0, 0]), np.float64),
                _blob(np.zeros(3), np.float64),
            ),
        )

    # ---- reads ----
    def get_keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id = ?", (image_id,)
        ).fetchone()
        r, c, data = row
        return np.frombuffer(data, np.float32).reshape(r, c)

    def get_matches(self, id1: int, id2: int) -> np.ndarray:
        pid = pair_id_from_image_ids(id1, id2)
        row = self.conn.execute(
            "SELECT rows, data FROM matches WHERE pair_id = ?", (pid,)
        ).fetchone()
        if row is None:
            return np.zeros((0, 2), np.uint32)
        r, data = row
        m = np.frombuffer(data, np.uint32).reshape(r, 2)
        if id1 > id2:
            m = m[:, ::-1]
        return m

    def image_name_to_id(self):
        return {
            name: iid
            for iid, name in self.conn.execute("SELECT image_id, name FROM images")
        }

    def commit(self):
        self.conn.commit()


def create_db_from_scene(scene, path) -> "ColmapDatabase":
    """Seed a database with a SceneModel's cameras + images (the reference's
    create_db_from_model role, hloc triangulation prep).

    Idempotent: an existing database at ``path`` is replaced — re-running
    `augment` used to die on the UNIQUE camera_id constraint of the
    previous run's db."""
    from pathlib import Path

    from pixtrack_tpu_torch.sfm.colmap_io import COLMAP_MODEL_IDS

    Path(path).unlink(missing_ok=True)
    db = ColmapDatabase(path)
    for cam in scene.cameras.values():
        db.add_camera(
            COLMAP_MODEL_IDS[cam.model], cam.width, cam.height, cam.params,
            camera_id=cam.camera_id, prior_focal_length=True,
        )
    for iid in scene.image_ids:
        im = scene.images[int(iid)]
        db.add_image(im.name, im.camera_id, image_id=int(iid))
    db.commit()
    return db
