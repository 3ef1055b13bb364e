"""COLMAP model IO: cameras/images/points3D in .bin and .txt formats.

The readers and writers of ``pixtrack_tpu/sfm/colmap_io.py``, copied (the
port has no native parser): for the same records both packages write the
same bytes.

A from-scratch, numpy-vectorized implementation of the public COLMAP
sparse-model format (the reference vendors COLMAP's own reader at
pixtrack/utils/colmap_read_model.py; our design differs: whole-file buffer
parsing with ``np.frombuffer`` instead of per-record ``struct.unpack`` calls,
and flat record dataclasses that convert directly to SceneModel arrays).

Format summary (public COLMAP spec):
  cameras.bin:  u64 n; per cam: i32 id, i32 model_id, u64 w, u64 h, f64 params[k]
  images.bin:   u64 n; per img: i32 id, f64 q[4], f64 t[3], i32 cam_id,
                name\\0, u64 m, then m * (f64 x, f64 y, i64 p3d_id)
  points3D.bin: u64 n; per pt: i64 id, f64 xyz[3], u8 rgb[3], f64 err,
                u64 L, then L * (i32 image_id, i32 p2d_idx)
"""

from __future__ import annotations

import dataclasses
import os
import struct
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

# model_id -> (name, num_params); public COLMAP enumeration.
COLMAP_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
COLMAP_MODEL_IDS = {name: mid for mid, (name, _) in COLMAP_MODELS.items()}


@dataclasses.dataclass
class CameraRecord:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # (k,) float64


@dataclasses.dataclass
class ImageRecord:
    image_id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (m, 2)
    point3D_ids: np.ndarray  # (m,) int64, -1 = unobserved


@dataclasses.dataclass
class Point3DRecord:
    id: int
    xyz: np.ndarray  # (3,)
    rgb: np.ndarray  # (3,) uint8
    error: float
    image_ids: np.ndarray  # (L,) int32
    point2D_idxs: np.ndarray  # (L,) int32


class _Buf:
    """Cursor over a bytes buffer with vectorized reads."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, dtype, count=1):
        dt = np.dtype(dtype).newbyteorder("<")
        out = np.frombuffer(self.data, dtype=dt, count=count, offset=self.pos)
        self.pos += dt.itemsize * count
        return out

    def read_scalar(self, dtype):
        return self.read(dtype, 1)[0]

    def read_cstr(self) -> str:
        end = self.data.index(b"\x00", self.pos)
        s = self.data[self.pos : end].decode("utf-8")
        self.pos = end + 1
        return s


# ---------------------------------------------------------------- cameras ----
def read_cameras_bin(path) -> Dict[int, CameraRecord]:
    buf = _Buf(Path(path).read_bytes())
    n = int(buf.read_scalar(np.uint64))
    out = {}
    for _ in range(n):
        cam_id = int(buf.read_scalar(np.int32))
        model_id = int(buf.read_scalar(np.int32))
        w = int(buf.read_scalar(np.uint64))
        h = int(buf.read_scalar(np.uint64))
        name, k = COLMAP_MODELS[model_id]
        params = buf.read(np.float64, k).copy()
        out[cam_id] = CameraRecord(cam_id, name, w, h, params)
    return out


def write_cameras_bin(cameras: Dict[int, CameraRecord], path) -> None:
    parts = [struct.pack("<Q", len(cameras))]
    for cam in cameras.values():
        mid = COLMAP_MODEL_IDS[cam.model]
        parts.append(struct.pack("<iiQQ", cam.camera_id, mid, cam.width, cam.height))
        parts.append(np.asarray(cam.params, "<f8").tobytes())
    Path(path).write_bytes(b"".join(parts))


def read_cameras_txt(path) -> Dict[int, CameraRecord]:
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        out[int(tok[0])] = CameraRecord(
            int(tok[0]), tok[1], int(tok[2]), int(tok[3]),
            np.array([float(x) for x in tok[4:]]),
        )
    return out


def write_cameras_txt(cameras: Dict[int, CameraRecord], path) -> None:
    lines = ["# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]"]
    for cam in cameras.values():
        p = " ".join(f"{float(x):.17g}" for x in cam.params)
        lines.append(f"{cam.camera_id} {cam.model} {cam.width} {cam.height} {p}")
    Path(path).write_text("\n".join(lines) + "\n")


# ----------------------------------------------------------------- images ----
def read_images_bin(path) -> Dict[int, ImageRecord]:
    buf = _Buf(Path(path).read_bytes())
    n = int(buf.read_scalar(np.uint64))
    out = {}
    for _ in range(n):
        image_id = int(buf.read_scalar(np.int32))
        qvec = buf.read(np.float64, 4).copy()
        tvec = buf.read(np.float64, 3).copy()
        cam_id = int(buf.read_scalar(np.int32))
        name = buf.read_cstr()
        m = int(buf.read_scalar(np.uint64))
        # (x, y, p3d_id) packed as 2 f64 + 1 i64 = 24 bytes/row; read raw and split
        raw = buf.read(np.uint8, m * 24)
        rows = raw.reshape(m, 24)
        xys = rows[:, :16].copy().view("<f8").reshape(m, 2)
        p3d = rows[:, 16:].copy().view("<i8").reshape(m)
        out[image_id] = ImageRecord(image_id, qvec, tvec, cam_id, name, xys, p3d)
    return out


def write_images_bin(images: Dict[int, ImageRecord], path) -> None:
    parts = [struct.pack("<Q", len(images))]
    for im in images.values():
        parts.append(struct.pack("<i", im.image_id))
        parts.append(np.asarray(im.qvec, "<f8").tobytes())
        parts.append(np.asarray(im.tvec, "<f8").tobytes())
        parts.append(struct.pack("<i", im.camera_id))
        parts.append(im.name.encode("utf-8") + b"\x00")
        m = len(im.xys)
        parts.append(struct.pack("<Q", m))
        rows = np.empty((m, 24), np.uint8)
        rows[:, :16] = np.ascontiguousarray(im.xys, "<f8").view(np.uint8).reshape(m, 16)
        rows[:, 16:] = np.ascontiguousarray(im.point3D_ids, "<i8").view(np.uint8).reshape(m, 8)
        parts.append(rows.tobytes())
    Path(path).write_bytes(b"".join(parts))


def read_images_txt(path) -> Dict[int, ImageRecord]:
    out = {}
    lines = [
        l.strip()
        for l in Path(path).read_text().splitlines()
        if l.strip() and not l.strip().startswith("#")
    ]
    for i in range(0, len(lines), 2):
        tok = lines[i].split()
        image_id = int(tok[0])
        qvec = np.array([float(x) for x in tok[1:5]])
        tvec = np.array([float(x) for x in tok[5:8]])
        cam_id = int(tok[8])
        name = tok[9]
        ptok = lines[i + 1].split() if i + 1 < len(lines) else []
        m = len(ptok) // 3
        xys = np.array(
            [[float(ptok[3 * j]), float(ptok[3 * j + 1])] for j in range(m)]
        ).reshape(m, 2)
        p3d = np.array([int(ptok[3 * j + 2]) for j in range(m)], np.int64)
        out[image_id] = ImageRecord(image_id, qvec, tvec, cam_id, name, xys, p3d)
    return out


def write_images_txt(images: Dict[int, ImageRecord], path) -> None:
    lines = [
        "# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME",
        "#             POINTS2D[] as (X, Y, POINT3D_ID)",
    ]
    for im in images.values():
        q = " ".join(f"{float(x):.17g}" for x in im.qvec)
        t = " ".join(f"{float(x):.17g}" for x in im.tvec)
        lines.append(f"{im.image_id} {q} {t} {im.camera_id} {im.name}")
        lines.append(" ".join(
            f"{float(x):.17g} {float(y):.17g} {int(pid)}" for (x, y), pid in zip(im.xys, im.point3D_ids)))
    Path(path).write_text("\n".join(lines) + "\n")


# --------------------------------------------------------------- points3D ----
def read_points3D_bin(path) -> Dict[int, Point3DRecord]:
    buf = _Buf(Path(path).read_bytes())
    n = int(buf.read_scalar(np.uint64))
    out = {}
    for _ in range(n):
        pid = int(buf.read_scalar(np.int64))
        xyz = buf.read(np.float64, 3).copy()
        rgb = buf.read(np.uint8, 3).copy()
        err = float(buf.read_scalar(np.float64))
        L = int(buf.read_scalar(np.uint64))
        track = buf.read(np.int32, 2 * L).copy().reshape(L, 2)
        out[pid] = Point3DRecord(pid, xyz, rgb, err, track[:, 0].copy(), track[:, 1].copy())
    return out


def write_points3D_bin(points: Dict[int, Point3DRecord], path) -> None:
    parts = [struct.pack("<Q", len(points))]
    for p in points.values():
        parts.append(struct.pack("<q", p.id))
        parts.append(np.asarray(p.xyz, "<f8").tobytes())
        parts.append(np.asarray(p.rgb, np.uint8).tobytes())
        parts.append(struct.pack("<d", p.error))
        L = len(p.image_ids)
        parts.append(struct.pack("<Q", L))
        track = np.empty((L, 2), "<i4")
        track[:, 0] = p.image_ids
        track[:, 1] = p.point2D_idxs
        parts.append(track.tobytes())
    Path(path).write_bytes(b"".join(parts))


def read_points3D_txt(path) -> Dict[int, Point3DRecord]:
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        pid = int(tok[0])
        xyz = np.array([float(x) for x in tok[1:4]])
        rgb = np.array([int(x) for x in tok[4:7]], np.uint8)
        err = float(tok[7])
        rest = tok[8:]
        image_ids = np.array([int(x) for x in rest[0::2]], np.int32)
        p2d_idxs = np.array([int(x) for x in rest[1::2]], np.int32)
        out[pid] = Point3DRecord(pid, xyz, rgb, err, image_ids, p2d_idxs)
    return out


def write_points3D_txt(points: Dict[int, Point3DRecord], path) -> None:
    lines = ["# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[] as (IMAGE_ID, POINT2D_IDX)"]
    for p in points.values():
        xyz = " ".join(f"{float(x):.17g}" for x in p.xyz)
        rgb = " ".join(str(int(x)) for x in p.rgb)
        track = " ".join(f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs))
        lines.append(f"{p.id} {xyz} {rgb} {float(p.error):.17g} {track}")
    Path(path).write_text("\n".join(lines) + "\n")


# ------------------------------------------------------------- model reader ----
def read_model(path, ext: str | None = None) -> Tuple[dict, dict, dict]:
    """Read a COLMAP model directory. Auto-detects .bin vs .txt."""
    path = Path(path)
    if ext is None:
        ext = ".bin" if (path / "cameras.bin").exists() else ".txt"
    if ext == ".bin":
        return (
            read_cameras_bin(path / "cameras.bin"),
            read_images_bin(path / "images.bin"),
            read_points3D_bin(path / "points3D.bin"),
        )
    return (
        read_cameras_txt(path / "cameras.txt"),
        read_images_txt(path / "images.txt"),
        read_points3D_txt(path / "points3D.txt"),
    )


def write_model(cameras, images, points3D, path, ext: str = ".bin") -> None:
    path = Path(path)
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_bin(cameras, path / "cameras.bin")
        write_images_bin(images, path / "images.bin")
        write_points3D_bin(points3D, path / "points3D.bin")
    else:
        write_cameras_txt(cameras, path / "cameras.txt")
        write_images_txt(images, path / "images.txt")
        write_points3D_txt(points3D, path / "points3D.txt")
