"""Pose-overlay rendering: axes, object center, AABB box, blending, errors.

Port of ``pixtrack_tpu/viz/overlay.py`` (host drawing code): K-projected RGB
axes, object center dot, AABB wireframe, alpha blend of the NeRF render over
the query, per-frame error text. ``cv2`` is imported inside the functions
that draw or touch files; nothing on the tracking path imports this module.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch.geometry import Camera, Pose

AXIS_COLORS = ((0, 0, 255), (0, 255, 0), (255, 0, 0))  # BGR: x red, y green, z blue


def _project(camera: Camera, T_w2c: Pose, pts: np.ndarray) -> np.ndarray:
    dev = T_w2c.R.device
    p2d, _ = camera.to(dev).world2image(T_w2c, torch.as_tensor(np.asarray(pts, np.float32), device=dev))
    return p2d.cpu().numpy()


def blend_images(fg: np.ndarray, bg: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Alpha-blend a rendered view over the query frame; black pixels of the
    render (the zeroed background) pass the query through unchanged."""
    fg = fg.astype(np.float32)
    bg = bg.astype(np.float32)
    mask = (fg.sum(axis=-1, keepdims=True) > 0).astype(np.float32)
    out = mask * (alpha * fg + (1 - alpha) * bg) + (1 - mask) * bg
    return out.astype(np.uint8)


def draw_pose_axes(
    image: np.ndarray,
    camera: Camera,
    T_w2c: Pose,
    origin: Optional[np.ndarray] = None,
    length: float = 0.1,
    thickness: int = 2,
) -> np.ndarray:
    """Draw RGB xyz axes of the object frame at ``origin`` (world)."""
    import cv2

    if origin is None:
        origin = np.zeros(3)
    pts = np.stack(
        [
            origin,
            origin + np.array([length, 0, 0]),
            origin + np.array([0, length, 0]),
            origin + np.array([0, 0, length]),
        ]
    ).astype(np.float32)
    p2d = _project(camera, T_w2c, pts).round().astype(int)
    out = image.copy()
    for i, color in enumerate(AXIS_COLORS):
        cv2.line(out, tuple(p2d[0]), tuple(p2d[i + 1]), color, thickness)
    return out


def draw_object_center(
    image: np.ndarray, camera: Camera, T_w2c: Pose, center: np.ndarray,
    radius: int = 5, color=(255, 255, 0),
) -> np.ndarray:
    import cv2

    p2d = _project(camera, T_w2c, center[None].astype(np.float32))[0]
    out = image.copy()
    cv2.circle(out, tuple(p2d.round().astype(int)), radius, color, -1)
    return out


def draw_aabb_box(
    image: np.ndarray, camera: Camera, T_w2c: Pose,
    aabb_min: np.ndarray, aabb_max: np.ndarray,
    color=(0, 255, 255), thickness: int = 1,
) -> np.ndarray:
    """Wireframe of a world-space AABB."""
    import cv2

    mn, mx = np.asarray(aabb_min), np.asarray(aabb_max)
    corners = np.array(
        [
            [x, y, z]
            for x in (mn[0], mx[0])
            for y in (mn[1], mx[1])
            for z in (mn[2], mx[2])
        ],
        np.float32,
    )
    p2d = _project(camera, T_w2c, corners).round().astype(int)
    edges = [
        (0, 1), (0, 2), (1, 3), (2, 3),
        (4, 5), (4, 6), (5, 7), (6, 7),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    out = image.copy()
    for a, b in edges:
        cv2.line(out, tuple(p2d[a]), tuple(p2d[b]), color, thickness)
    return out


def draw_error_text(
    image: np.ndarray, t_err: float, r_err_deg: float,
    origin: Tuple[int, int] = (10, 30),
) -> np.ndarray:
    """Per-frame error overlay."""
    import cv2

    out = image.copy()
    cv2.putText(
        out,
        f"t: {t_err * 100:.1f} cm  r: {r_err_deg:.1f} deg",
        origin,
        cv2.FONT_HERSHEY_SIMPLEX,
        0.7,
        (255, 255, 255),
        2,
    )
    return out


def render_pose_overlays(
    poses_pkl_path,
    scene,
    testbed,
    nerf2sfm,
    out_dir,
    camera: Optional[Camera] = None,
    object_center: Optional[np.ndarray] = None,
    aabb_sfm: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    gt_poses: Optional[dict] = None,
    blend_alpha: float = 0.5,
    spp: int = 2,
    axis_length: float = 0.1,
) -> list:
    """Load poses.pkl, re-render the NeRF at each refined pose (on the
    Testbed's device), blend over the query frame, draw overlays, write
    ``result_<name>.jpg`` under ``out_dir``. Returns the written paths."""
    import os
    import pickle

    import cv2

    from pixtrack_tpu_torch.eval.metrics import pose_errors
    from pixtrack_tpu_torch.tracking.render_bridge import render_nerf_view

    with open(poses_pkl_path, "rb") as f:
        poses = pickle.load(f)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, rec in poses.items():
        T = Pose.from_4x4(np.asarray(rec["T_refined"], np.float32))
        if camera is None:
            cam = Camera(*(torch.as_tensor(np.asarray(rec["camera"][k])) for k in ("size", "f", "c", "k")))
        else:
            cam = camera
        query = cv2.imread(str(rec["query_path"])) if os.path.exists(
            str(rec["query_path"])
        ) else None
        render = render_nerf_view(testbed, nerf2sfm, T, cam, spp=spp)
        render_bgr = cv2.cvtColor(render, cv2.COLOR_RGB2BGR)
        if query is not None and query.shape == render_bgr.shape:
            img = blend_images(render_bgr, query, blend_alpha)
        else:
            img = render_bgr
        img = draw_pose_axes(img, cam, T, length=axis_length)
        if object_center is not None:
            img = draw_object_center(img, cam, T, object_center)
        if aabb_sfm is not None:
            img = draw_aabb_box(img, cam, T, aabb_sfm[0], aabb_sfm[1])
        if gt_poses is not None and name in gt_poses:
            Rg, tg = gt_poses[name]
            r_err, t_err = pose_errors(T.R.numpy(), T.t.numpy(), Rg, tg)
            img = draw_error_text(img, t_err, r_err)
        path = os.path.join(out_dir, f"result_{os.path.splitext(name)[0]}.jpg")
        cv2.imwrite(path, img)
        written.append(path)
    return written


def write_video(image_paths: Sequence[str], out_path, fps: int = 30) -> None:
    """Frames -> mp4."""
    import cv2

    if not image_paths:
        return
    first = cv2.imread(str(image_paths[0]))
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(
        str(out_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for p in image_paths:
        img = cv2.imread(str(p))
        if img is not None:
            vw.write(img)
    vw.release()
