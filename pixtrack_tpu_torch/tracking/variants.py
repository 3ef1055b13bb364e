"""Tracker lineage: the evolution steps of the tracker as first-class variants.

Port of ``pixtrack_tpu/tracking/variants.py``:

- r1: fixed single reference image;
- r2: covisibility-based reference selection, K = 2;
- r3: r2 + in-plane **roll tracking**: the query image is rotated by the
  negative tracked roll before optimization and the refined pose is
  re-rotated after, so the optimizer always sees an upright object (the
  emitted ``tracked_roll``/``tracked_center`` are consumed by the visualizer);
- r5: static SfM reference images (no NeRF);
- r6: + NeRF-rendered reference view at the reference's own SfM pose;
- r7: + ``reference_scale``;
- r8: + dynamic-reference feature cache and cold-start multiscale [4, 1]
  (r8 == r9 minus depth masking);
- r9: the flagship (``PixTrackTracker``, tracking/tracker.py).

The lineage is expressed over ONE engine: ``StaticRefTracker`` serves
r1/r2/r5 (disk reference images at their SfM poses), a render-at-db-pose
option serves r6/r7, config presets serve r8, and ``RollTracker`` adds the
r3 mechanism on top of any of them.

The image warps (``rotate_image``, the ``reference_scale`` resize) are
``torch.nn.functional`` calls on the tracker's device; no image library is
needed on the tracking path.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pixtrack_tpu_torch.geometry import Pose
from pixtrack_tpu_torch.tracking.refiner import ReferenceFeatures, RefineResult
from pixtrack_tpu_torch.tracking.tracker import PixTrackTracker, TrackerConfig


# ---------------------------------------------------------------------------
# In-plane roll machinery
# ---------------------------------------------------------------------------

def _as_nchw(image):
    """(H, W) or (H, W, C) numpy array or tensor -> float (1, C, H, W) tensor."""
    t = image if isinstance(image, torch.Tensor) else torch.as_tensor(np.ascontiguousarray(image))
    t = t[..., None] if t.ndim == 2 else t
    return t.permute(2, 0, 1)[None].float()


def _like_input(out: torch.Tensor, image):
    """A (1, C, H, W) result in the layout, dtype and kind (numpy array or
    tensor) of ``image``; integer images are rounded to nearest."""
    out = out[0].permute(1, 2, 0)
    if image.ndim == 2:
        out = out[..., 0]
    is_tensor = isinstance(image, torch.Tensor)
    dtype = image.dtype if is_tensor else torch.as_tensor(np.empty(0, image.dtype)).dtype
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        out = out.round().clamp(info.min, info.max)
    out = out.to(dtype)
    return out if is_tensor else out.cpu().numpy()


def rotate_image(image, angle_deg: float, center: Optional[Tuple[float, float]] = None):
    """Rotate image content counter-clockwise by ``angle_deg`` about
    ``center`` (default: the image centre), same-size output.

    The affine warp of ``cv2.warpAffine(image, cv2.getRotationMatrix2D(center,
    angle_deg, 1.0), (w, h), flags=cv2.INTER_LINEAR)``: bilinear, zeros
    outside the image, pixel centres at integer coordinates. ``image`` is a
    numpy array (warped on the CPU, numpy out) or a tensor (warped on its
    device, tensor out)."""
    h, w = image.shape[:2]
    if center is None:
        center = ((w - 1) / 2.0, (h - 1) / 2.0)
    cx, cy = float(center[0]), float(center[1])
    src = _as_nchw(image)
    a, b = np.cos(np.deg2rad(float(angle_deg))), np.sin(np.deg2rad(float(angle_deg)))
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=src.device),
                            torch.arange(w, dtype=torch.float32, device=src.device), indexing="ij")
    # the inverse map: the source position of every output pixel
    sx = cx + a * (xs - cx) - b * (ys - cy)
    sy = cy + b * (xs - cx) + a * (ys - cy)
    grid = torch.stack([2.0 * sx / max(w - 1, 1) - 1.0, 2.0 * sy / max(h - 1, 1) - 1.0], dim=-1)[None]
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return _like_input(out, image)


def resize_image(image, scale: float):
    """Bilinear resize by ``scale`` without anti-aliasing, pixel centres at
    half-integer positions: ``cv2.resize(image, None, fx=scale, fy=scale)``."""
    h, w = image.shape[:2]
    size = (int(round(h * scale)), int(round(w * scale)))
    out = F.interpolate(_as_nchw(image), size=size, mode="bilinear", align_corners=False, antialias=False)
    return _like_input(out, image)


def _rz(angle_rad: float) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def roll_of_pose(T_w2c: Pose, up_world=(0.0, 0.0, 1.0)) -> float:
    """In-plane roll of the object in the image: angle (rad, CCW-positive in
    image coords with y down) between the projected world up-axis and image
    'up' (-y). 0 when the object appears upright."""
    u_c = T_w2c.R.detach().cpu().numpy().astype(np.float64) @ np.asarray(up_world, np.float64)
    # image-plane direction of the up axis (x right, y down in pixels)
    return float(np.arctan2(u_c[0], -u_c[1]))


def pre_opt_rotation(T_w2c: Pose, image_angle_rad: float) -> Pose:
    """Pose seen by the optimizer when the query image has been rotated by
    ``image_angle_rad`` (positive = content turns CCW on a y-down display)
    about the principal point.

    The image's coordinate map is p' - c = [[cos a, sin a], [-sin a, cos a]](p - c);
    with the pinhole model p - c = f/z (x, y) that equals a camera-frame
    rotation x_cam' = Rz(-a) x_cam, so R' = Rz(-a) R, t' = Rz(-a) t."""
    Rz = _rz(-image_angle_rad)
    R = T_w2c.R.detach().cpu().numpy()
    t = T_w2c.t.detach().cpu().numpy()
    return Pose.from_Rt((Rz @ R).astype(np.float32), (Rz @ t).astype(np.float32), device=T_w2c.R.device)


def post_opt_rotation(T_w2c_rot: Pose, image_angle_rad: float) -> Pose:
    """Inverse of :func:`pre_opt_rotation`: recover the true-image pose from
    the pose refined against the rotated query."""
    return pre_opt_rotation(T_w2c_rot, -image_angle_rad)


# ---------------------------------------------------------------------------
# Static / db-pose reference tracker (r1 / r2 / r5 / r6 / r7)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StaticRefConfig(TrackerConfig):
    """r1/r2/r5-era options on top of the shared TrackerConfig."""

    images_dir: Optional[str] = None   # mapping images root (disk refs)
    fixed_reference: bool = False      # r1: never re-select
    render_at_db_pose: bool = False    # r6/r7: NeRF render at the ref's pose
    # precomputed reference_features.h5: when set, per-reference features
    # load from disk instead of being extracted from images/renders
    features_h5: Optional[str] = None


class StaticRefTracker(PixTrackTracker):
    """Reference features come from the reference image itself — either the
    stored mapping image (r5: disk) or a NeRF render at the reference's own
    SfM pose (r6/r7) — instead of a render at the current estimate (r8/r9).

    Per-reference features are extracted once and memoized; masking is off
    (pre-r9 semantics) unless explicitly enabled.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if not isinstance(self.config, StaticRefConfig):
            raise TypeError("StaticRefTracker requires a StaticRefConfig")
        self._static_refs: Dict[int, ReferenceFeatures] = {}
        if self.config.features_h5:
            from pixtrack_tpu_torch.tracking.feature_io import load_reference_features

            self._static_refs.update(load_reference_features(self.config.features_h5, device=self.device))

    # -- reference features -------------------------------------------------
    def _load_reference_image(self, ref_id: int) -> np.ndarray:
        from pixtrack_tpu_torch.utils.io import _read_rgb

        name = self.scene.images[int(ref_id)].name
        return _read_rgb(os.path.join(self.config.images_dir, name))

    def static_reference(self, ref_id: int) -> ReferenceFeatures:
        ref = self._static_refs.get(int(ref_id))
        if ref is not None:
            return ref
        pose = self.scene.pose_w2c(int(ref_id), device=self.device)
        if self.config.render_at_db_pose:
            img, cam, alpha = self.get_reference_image(pose)
        else:
            img = self._load_reference_image(ref_id)
            cam = self.scene.camera(self.scene.images[int(ref_id)].camera_id, device=self.device)
            if self.config.reference_scale != 1.0:
                s = self.config.reference_scale
                img = resize_image(torch.as_tensor(img, device=self.device), s)
                cam = cam.scale(s)
            alpha = None
        ref = self.refiner.extract_reference_features([int(ref_id)], pose, img, cam, ref_alpha=alpha)
        self._static_refs[int(ref_id)] = ref
        return ref

    # -- overridden engine hooks --------------------------------------------
    def update_reference_ids(self) -> List[int]:
        if self.config.fixed_reference:
            return self.reference_ids
        # covis-based geodesic selection, K = num_refs
        saved, self.cache_hit = self.cache_hit, False
        try:
            return super().update_reference_ids()
        finally:
            self.cache_hit = saved

    def refine(self, query) -> bool:
        query_path, query_image = query
        query_image = np.asarray(query_image)

        if self.cold_start:
            multiscale = self.config.cold_multiscale
            self.relocalize(query)
            self.cold_start = False
        else:
            multiscale = self.config.steady_multiscale
            if self.config.mask_always or (self.success and self.config.use_mask):
                mask = self.get_mask(self.pose)
                query_image = (query_image * mask[..., None]).astype(query_image.dtype)

        self.update_reference_ids()
        results: Dict[int, RefineResult] = {}
        for ref_id in self.reference_ids:
            ref = self.static_reference(ref_id)
            results[ref_id] = self.refiner.refine(query_image, self.camera, self.pose, ref, multiscale=multiscale)
        best_id = min(results, key=lambda k: results[k].cost)
        best = results[best_id]
        self.reference_ids = [best_id] + [i for i in self.reference_ids if i != best_id]
        return self._finish_frame(query_path, best)

    def _finish_frame(self, query_path, best: RefineResult) -> bool:
        """Shared bookkeeping tail of refine() (threshold, history, trace)."""
        if self.cost_threshold is None and np.isfinite(best.cost):
            self.cost_threshold = max(best.cost * self.config.cost_threshold_factor,
                                      self.config.cost_threshold_min)
        success = best.success and best.cost <= (self.cost_threshold or np.inf)
        if success:
            self.pose = best.T_refined
        self.success = success
        name = os.path.basename(str(query_path))
        self.pose_history[name] = {
            "success": success,
            "T_init": best.T_init.to_4x4().cpu().numpy(),
            "T_refined": best.T_refined.to_4x4().cpu().numpy(),
            "camera": {k: getattr(self.camera, k).cpu().numpy() for k in ("size", "f", "c", "k")},
            "cost": best.cost,
            "reference_ids": list(self.reference_ids),
            "query_path": str(query_path),
        }
        self.trace.append({
            "frame": name,
            "cost": best.cost,
            "num_iters": best.num_iters,
            "num_valid": best.num_valid,
            "cache_hit": self.cache_hit,
            "success": success,
        })
        return success


class RollTracker(StaticRefTracker):
    """r3: tracks the object's in-plane roll explicitly. Each frame the query
    is rotated by -tracked_roll about tracked_center so the optimizer sees an
    upright object (matching the upright reference set); the refined pose is
    rotated back and the roll re-estimated from it."""

    def __init__(self, *args, up_world=(0.0, 0.0, 1.0), **kwargs):
        super().__init__(*args, **kwargs)
        self.up_world = np.asarray(up_world, np.float64)
        self.tracked_roll = 0.0   # radians
        self.tracked_center: Optional[Tuple[float, float]] = None

    def relocalize(self, query) -> None:
        super().relocalize(query)
        self.tracked_roll = roll_of_pose(self.pose, self.up_world)

    def refine(self, query) -> bool:
        query_path, query_image = query
        if self.cold_start:
            self.relocalize(query)
            self.cold_start = False
            multiscale = self.config.cold_multiscale
        else:
            multiscale = self.config.steady_multiscale

        roll = self.tracked_roll
        c = self.camera.c.cpu().numpy()
        self.tracked_center = (float(c[0]), float(c[1]))
        # rotate the query (on the device) so the object appears upright; the
        # optimizer works in the rotated frame
        q_rot = rotate_image(torch.as_tensor(np.asarray(query_image), device=self.device),
                             np.rad2deg(roll), self.tracked_center)
        T_rot = pre_opt_rotation(self.pose, roll)

        self.update_reference_ids()
        results: Dict[int, RefineResult] = {}
        for ref_id in self.reference_ids:
            ref = self.static_reference(ref_id)
            results[ref_id] = self.refiner.refine(q_rot, self.camera, T_rot, ref, multiscale=multiscale)
        best_id = min(results, key=lambda k: results[k].cost)
        best = results[best_id]

        # un-rotate the refined pose back into the true image frame
        best.T_refined = post_opt_rotation(best.T_refined, roll)
        best.T_init = self.pose
        ok = self._finish_frame(query_path, best)
        if ok:
            self.tracked_roll = roll_of_pose(self.pose, self.up_world)
        self.pose_history[os.path.basename(str(query_path))].update(
            {"tracked_roll": self.tracked_roll, "tracked_center": self.tracked_center}
        )
        return ok


# ---------------------------------------------------------------------------
# Named lineage presets
# ---------------------------------------------------------------------------

def _static_cfg(**kw) -> StaticRefConfig:
    base = dict(use_mask=False, cold_multiscale=(1,), steady_multiscale=(1,), reference_scale=1.0)
    base.update(kw)
    return StaticRefConfig(**base)


def make_tracker_r1(scene, extractor, images_dir, **kw):
    """Fixed single reference."""
    cfg = _static_cfg(images_dir=images_dir, fixed_reference=True, num_refs=1)
    return StaticRefTracker(scene, extractor, testbed=None, nerf2sfm=None, config=cfg, **kw)


def make_tracker_r2(scene, extractor, images_dir, **kw):
    """Covisibility reference selection, K = 2."""
    cfg = _static_cfg(images_dir=images_dir, num_refs=2)
    return StaticRefTracker(scene, extractor, testbed=None, nerf2sfm=None, config=cfg, **kw)


def make_tracker_r3(scene, extractor, images_dir, up_world=(0.0, 0.0, 1.0), **kw):
    """r2 + in-plane roll tracking."""
    cfg = _static_cfg(images_dir=images_dir, num_refs=2)
    return RollTracker(scene, extractor, testbed=None, nerf2sfm=None, config=cfg, up_world=up_world, **kw)


def make_tracker_r5(scene, extractor, images_dir, **kw):
    """Static SfM reference images, K = 1."""
    cfg = _static_cfg(images_dir=images_dir, num_refs=1)
    return StaticRefTracker(scene, extractor, testbed=None, nerf2sfm=None, config=cfg, **kw)


def make_tracker_r6(scene, extractor, testbed, nerf2sfm, **kw):
    """NeRF-rendered reference at the reference's own SfM pose."""
    cfg = _static_cfg(render_at_db_pose=True, num_refs=1)
    return StaticRefTracker(scene, extractor, testbed=testbed, nerf2sfm=nerf2sfm, config=cfg, **kw)


def make_tracker_r7(scene, extractor, testbed, nerf2sfm, reference_scale=0.5, **kw):
    """r6 + reference_scale."""
    cfg = _static_cfg(render_at_db_pose=True, num_refs=1, reference_scale=reference_scale)
    return StaticRefTracker(scene, extractor, testbed=testbed, nerf2sfm=nerf2sfm, config=cfg, **kw)


def make_tracker_r8(scene, extractor, testbed, nerf2sfm, **kw):
    """Dynamic-reference cache + cold multiscale [4, 1]; no depth masking
    (r8 == r9 minus the mask)."""
    cfg = TrackerConfig(use_mask=False)
    return PixTrackTracker(scene, extractor, testbed=testbed, nerf2sfm=nerf2sfm, config=cfg, **kw)
