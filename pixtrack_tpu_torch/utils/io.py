"""Frame iterators and dataset loaders (host code).

Port of ``pixtrack_tpu/utils/io.py``: lazy and preloading image iterators
plus the YCB-Video loader (class map, ground-truth pose and calibrated
camera per frame), yielding the port's ``Pose`` and ``Camera``. PNG files
are read by the port's own decoder; other formats, and PNG layouts it does
not decode, need ``cv2`` or ``PIL``, imported when first used.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.mapping.mesh_render import read_png

# YCB-Video class ids for the objects pixtrack evaluates
YCB_CLASS_MAP = {
    "003_cracker_box": 2,
    "004_sugar_box": 3,
    "006_mustard_bottle": 5,
    "021_bleach_cleanser": 12,
    "035_power_drill": 15,
}

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def _list_images(folder) -> list:
    files = []
    for ext in _IMG_EXTS:
        files.extend(glob.glob(os.path.join(str(folder), f"*{ext}")))
    return sorted(files)


def _read_rgb(path) -> np.ndarray:
    """uint8 (H, W, 3) RGB image; gray is repeated and alpha dropped."""
    if not os.path.exists(str(path)):
        raise FileNotFoundError(path)
    if str(path).lower().endswith(".png"):
        try:
            img = read_png(path)
        except ValueError:  # 16-bit or interlaced: left to a library
            pass
        else:
            if img.shape[-1] <= 2:  # gray, or gray + alpha
                return np.repeat(img[..., :1], 3, axis=-1)
            return np.ascontiguousarray(img[..., :3])
    try:
        import cv2
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(str(path)).convert("RGB"))
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class ImagePathIterator:
    """Lazy frame iterator: yields (path, image) on demand."""

    def __init__(self, folder, max_frames: Optional[int] = None):
        self.paths = _list_images(folder)
        if max_frames is not None:
            self.paths = self.paths[:max_frames]

    def __len__(self):
        return len(self.paths)

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        for p in self.paths:
            yield p, _read_rgb(p)


class ImageIterator:
    """Preloading iterator: all frames read to RAM up front (the reference's
    steady-state tracking mode: no disk IO on the per-frame hot path)."""

    def __init__(self, folder, max_frames: Optional[int] = None):
        self.paths = _list_images(folder)
        if max_frames is not None:
            self.paths = self.paths[:max_frames]
        self.images = [_read_rgb(p) for p in self.paths]

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        return iter(zip(self.paths, self.images))


def parse_frame_range(spec: str, n_total: int):
    """Reference-style frame spec '7/:20' -> (video '7', slice(None, 20)).

    Bare specs like ':20', '5:', '10:50' select frames; 'v/' prefixes pick a
    video subfolder.
    """
    video = None
    if "/" in spec:
        video, spec = spec.split("/", 1)
    spec = spec.strip()
    if not spec:
        sl = slice(None)
    else:
        parts = spec.split(":")
        start = int(parts[0]) if parts[0] else None
        stop = int(parts[1]) if len(parts) > 1 and parts[1] else None
        sl = slice(start, stop)
    return video, range(*sl.indices(n_total))


class YCBVideoIterator:
    """YCB-Video sequence iterator.

    Layout: <root>/data/<video>/<frame:06d>-color.png + -meta.mat with
    ``poses`` (3, 4, n_obj), ``cls_indexes``, ``intrinsic_matrix``.
    Yields (path, image, gt_pose (w2c Pose), camera), both on ``device``
    (None is the CUDA card)
    (the dataset's own intrinsics are kept, in the index-centred convention).
    """

    def __init__(self, root, video: str, object_name_or_id, frames=None, device=None):
        from scipy.io import loadmat  # noqa: F401 (validated at init)

        self.device = resolve(device)
        self.root = Path(root)
        self.video = str(video).zfill(4)
        if isinstance(object_name_or_id, str):
            self.class_id = YCB_CLASS_MAP[object_name_or_id]
        else:
            self.class_id = int(object_name_or_id)
        folder = self.root / "data" / self.video
        colors = sorted(folder.glob("*-color.png"))
        self.frames = [p.name.split("-")[0] for p in colors]
        if frames is not None:
            self.frames = [self.frames[i] for i in frames if i < len(self.frames)]

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        from scipy.io import loadmat

        folder = self.root / "data" / self.video
        for fr in self.frames:
            img_path = folder / f"{fr}-color.png"
            meta = loadmat(str(folder / f"{fr}-meta.mat"))
            image = _read_rgb(img_path)
            cls = meta["cls_indexes"].ravel().astype(int)
            sel = np.nonzero(cls == self.class_id)[0]
            if len(sel) == 0:
                continue
            pose34 = meta["poses"][:, :, sel[0]]  # (3, 4) object-to-camera
            T = Pose.from_Rt(
                pose34[:, :3].astype(np.float32), pose34[:, 3].astype(np.float32), device=self.device
            )
            K = meta["intrinsic_matrix"]
            h, w = image.shape[:2]
            camera = Camera.from_colmap(
                "PINHOLE",
                [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])],
                w,
                h,
                self.device,
            )
            yield str(img_path), image, T, camera
