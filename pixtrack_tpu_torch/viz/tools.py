"""Folder-level visualization tools (host code).

Port of ``pixtrack_tpu/viz/tools.py``: max/alpha merge of image folders,
pairwise blend of a render folder over a query folder, axes overlay on saved
frames from poses.pkl, a video writer, and a multi-object overlay pass.
``cv2`` is imported inside the functions that write or resize images.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.utils.io import _list_images, _read_rgb
from pixtrack_tpu_torch.viz.overlay import blend_images, draw_pose_axes, write_video


def merge_image_folders(
    folders: Sequence[str], out_dir, mode: str = "max", alpha: float = 0.5
) -> list:
    """Merge same-named frames across folders: 'max' (per-pixel maximum,
    the default) or 'blend' (running alpha blend)."""
    import cv2

    assert mode in ("max", "blend")
    os.makedirs(out_dir, exist_ok=True)
    lists = [_list_images(f) for f in folders]
    n = min(len(l) for l in lists)
    written = []
    for i in range(n):
        acc = _read_rgb(lists[0][i]).astype(np.float32)
        for l in lists[1:]:
            img = _read_rgb(l[i]).astype(np.float32)
            acc = np.maximum(acc, img) if mode == "max" else (
                alpha * img + (1 - alpha) * acc
            )
        out = Path(out_dir) / os.path.basename(lists[0][i])
        cv2.imwrite(str(out), acc.astype(np.uint8)[..., ::-1])
        written.append(str(out))
    return written


def blend_render_and_query_folders(
    render_dir, query_dir, out_dir, alpha: float = 0.5
) -> list:
    """Blend rendered frames over query frames pairwise: black render pixels pass the
    query through."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    renders = _list_images(render_dir)
    queries = _list_images(query_dir)
    written = []
    for rp, qp in zip(renders, queries):
        fg = _read_rgb(rp)
        bg = _read_rgb(qp)
        if fg.shape[:2] != bg.shape[:2]:
            fg = cv2.resize(fg, (bg.shape[1], bg.shape[0]))
        out = Path(out_dir) / os.path.basename(qp)
        cv2.imwrite(str(out), blend_images(fg, bg, alpha)[..., ::-1])
        written.append(str(out))
    return written


def add_pose_axes_to_folder(
    poses_pkl, images_dir, out_dir,
    origin: Optional[np.ndarray] = None, length: float = 0.1,
) -> list:
    """Overlay tracked-pose axes onto saved frames using poses.pkl (consumes the
    tracker's output contract)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    with open(poses_pkl, "rb") as f:
        poses = pickle.load(f)
    written = []
    for name, rec in poses.items():
        path = Path(images_dir) / name
        if not path.exists():
            continue
        img = _read_rgb(str(path))
        cam = rec["camera"]
        camera = Camera.pinhole(
            float(cam["f"][0]), float(cam["f"][1]),
            float(cam["c"][0]), float(cam["c"][1]),
            float(cam["size"][0]), float(cam["size"][1]),
        )
        T = Pose.from_4x4(np.asarray(rec["T_refined"], np.float32))
        out = draw_pose_axes(img, camera, T, origin=origin, length=length)
        op = Path(out_dir) / f"axes_{name}"
        cv2.imwrite(str(op), out[..., ::-1])
        written.append(str(op))
    return written


def make_video_from_folder(folder, out_path, fps: int = 30) -> None:
    """Write every image in a folder to a video."""
    write_video(_list_images(folder), out_path, fps=fps)


def render_overlays_multi(
    poses_pkls: Sequence[str],
    render_fns: Sequence,
    query_dir,
    out_dir,
    alpha: float = 0.5,
) -> list:
    """Multi-object overlay pass: blend
    each object's re-render over the shared query frame, in sequence.

    ``render_fns[k](rec) -> (H, W, 3) uint8`` renders object k at the refined
    pose record ``rec`` from ``poses_pkls[k]``.
    """
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    all_poses = []
    for p in poses_pkls:
        with open(p, "rb") as f:
            all_poses.append(pickle.load(f))
    names = sorted(set.intersection(*(set(p.keys()) for p in all_poses)))
    written = []
    for name in names:
        q = Path(query_dir) / name
        if not q.exists():
            continue
        canvas = _read_rgb(str(q))
        for poses, render_fn in zip(all_poses, render_fns):
            fg = render_fn(poses[name])
            if fg.shape[:2] != canvas.shape[:2]:
                fg = cv2.resize(fg, (canvas.shape[1], canvas.shape[0]))
            canvas = blend_images(fg, canvas, alpha)
        op = Path(out_dir) / f"result_{name}"
        cv2.imwrite(str(op), canvas[..., ::-1])
        written.append(str(op))
    return written
