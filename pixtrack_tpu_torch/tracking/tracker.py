"""PixTrackTracker: the NeRF-referenced feature-metric tracker.

Port of ``pixtrack_tpu/tracking/tracker.py``: ``TrackerConfig``,
construction (``fast_render`` forces 96 coarse samples and no importance
pass, K1; without it the Testbed keeps its 64 coarse and 32 importance
samples, K2), ``relocalize``, ``update_reference_ids``,
``get_dynamic_reference``, ``get_mask`` (point splat, or the reference's
NeRF-depth render eroded and dilated), best-of-K ``refine``, the stepwise
video loop of ``PoseTracker`` (``run``, ``run_single_frame``),
``run_fused``, ``save_poses`` and ``stats``. The older variants (r1-r8, roll
tracking) are in ``tracking/variants.py``, the YCB evaluation tracker in
``tracking/tracker_ycb.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch.align.lm import AlignConfig
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.geometry.rotation import geodesic_distance, quat_to_rotmat
from pixtrack_tpu_torch.tracking.base import PoseTracker
from pixtrack_tpu_torch.tracking.mask import depth_to_object_mask, splat_object_mask
from pixtrack_tpu_torch.tracking.refiner import ReferenceSet, Refiner, RefineResult, infer_camera_from_image
from pixtrack_tpu_torch.tracking.render_bridge import render_nerf_view


@dataclasses.dataclass
class TrackerConfig:
    """The fields and defaults of the JAX TrackerConfig."""

    upright_ref_img: Optional[str] = None
    reference_scale: float = 0.5
    covis_threshold: int = 50
    num_refs: int = 1
    cache_thresh_rad: float = 0.0
    cost_threshold_factor: float = 1.1
    cost_threshold_min: float = 0.0
    cold_multiscale: Tuple[int, ...] = (4, 1)
    steady_multiscale: Tuple[int, ...] = (1,)
    use_mask: bool = True
    mask_always: bool = False
    mask_mode: str = "splat"
    mask_kernel: int = 5
    mask_erode_iters: int = 1
    mask_dilate_iters: int = 5
    render_spp: int = 1
    fast_render: bool = True
    max_cache_entries: int = 64
    refine_rounds: int = 1
    motion_model: bool = False
    vel_t_damp: float = 0.5
    ref_crop: bool = True


def _rot_np(qvecs: np.ndarray) -> torch.Tensor:
    return quat_to_rotmat(torch.as_tensor(np.asarray(qvecs), dtype=torch.float32))


class PixTrackTracker(PoseTracker):
    def __init__(self, scene, extractor, testbed, nerf2sfm, config: TrackerConfig = TrackerConfig(),
                 align_cfg: AlignConfig = AlignConfig(), eval_path: Optional[str] = None,
                 covis: Optional[dict] = None):
        self.scene = scene
        self.config = config
        self.testbed = testbed
        if config.fast_render and testbed is not None:
            testbed.n_coarse, testbed.n_fine = 96, 0
        self.nerf2sfm = nerf2sfm
        self.eval_path = eval_path
        self.refiner = Refiner(scene, extractor, align_cfg)
        self.device = extractor.device
        self.covis = covis if covis is not None else scene.covisibility_dict()
        ref_name = config.upright_ref_img or scene.names[0]
        self.reference_ids: List[int] = [scene.name2id[ref_name]]

        self.cold_start = True
        self.success = True
        self.cache_hit = False
        self.pose: Optional[Pose] = None
        self.camera: Optional[Camera] = None
        self.cost_threshold: Optional[float] = None
        self.relocalization_count = 0
        self.hits = 0
        self.misses = 0
        self._cache: List[Tuple[np.ndarray, ReferenceSet]] = []
        self.pose_history: Dict[str, dict] = {}
        self.trace: List[dict] = []

    def relocalize(self, query) -> None:
        _, query_image = query
        if self.camera is None:
            self.camera = infer_camera_from_image(np.asarray(query_image), device=self.device)
        self.pose = self.scene.pose_w2c(self.reference_ids[0], device=self.device)
        self.relocalization_count += 1

    def update_reference_ids(self) -> List[int]:
        """Geodesic-nearest covisible references of the current one."""
        if self.cache_hit:
            return self.reference_ids
        curr_name = self.scene.images[int(self.reference_ids[0])].name
        cand_names = [curr_name] + [
            n for n, c in self.covis.get(curr_name, {}).items() if c > self.config.covis_threshold
        ]
        cand_ids = np.array([self.scene.name2id[n] for n in cand_names])
        R_refs = _rot_np(self.scene.qvecs[[self.scene._imgidx[int(i)] for i in cand_ids]])
        dists = geodesic_distance(self.pose.R.cpu()[None], R_refs).numpy()
        order = np.argsort(dists)
        self.reference_ids = [int(cand_ids[i]) for i in order[: self.config.num_refs]]
        return self.reference_ids

    def get_reference_image(self, pose: Pose):
        cam_id = self.scene.images[int(self.reference_ids[0])].camera_id
        ref_camera = self.scene.camera(cam_id, device=self.device).scale(self.config.reference_scale)
        img, alpha = render_nerf_view(self.testbed, self.nerf2sfm, pose, ref_camera,
                                      spp=self.config.render_spp, return_alpha=True)
        return img, ref_camera, alpha

    def _create_reference(self, pose: Pose) -> ReferenceSet:
        img, ref_camera, alpha = self.get_reference_image(pose)
        return self.refiner.extract_reference_set(self.reference_ids, pose, img, ref_camera, ref_alpha=alpha)

    def get_dynamic_reference(self, pose: Pose) -> ReferenceSet:
        """Reuse a cached reference within ``cache_thresh_rad``, else render."""
        R_now = pose.R.detach().cpu().numpy()
        if self._cache:
            Rs = torch.as_tensor(np.stack([r for r, _ in self._cache]))
            dists = geodesic_distance(torch.as_tensor(R_now)[None], Rs).numpy()
            best = int(np.argmin(dists))
            if dists[best] <= self.config.cache_thresh_rad:
                self.hits += 1
                self.cache_hit = True
                ref = self._cache[best][1]
                self.reference_ids = list(ref.ref_ids)
                return ref
        self.cache_hit = False
        self.update_reference_ids()
        ref = self._create_reference(pose)
        self._cache.append((R_now, ref))
        if len(self._cache) > self.config.max_cache_entries:
            self._cache.pop(0)
        self.misses += 1
        self.cache_hit = True
        return ref

    def get_mask(self, pose: Pose) -> np.ndarray:
        cfg = self.config
        if cfg.mask_mode == "splat":
            if not hasattr(self, "_mask_p3d"):
                self._mask_p3d = torch.as_tensor(self.scene.xyz.astype(np.float32), device=self.device)
            H = int(round(float(self.camera.height)))
            W = int(round(float(self.camera.width)))
            m = splat_object_mask(pose, self.camera, self._mask_p3d, (H, W),
                                  dilate_iters=cfg.mask_dilate_iters)
            return m.cpu().numpy()
        depth = render_nerf_view(self.testbed, self.nerf2sfm, pose, self.camera, spp=1, depth=True)
        m = depth_to_object_mask(torch.as_tensor(depth, device=self.device), size=cfg.mask_kernel,
                                 erode_iters=cfg.mask_erode_iters, dilate_iters=cfg.mask_dilate_iters)
        return m.cpu().numpy()

    def refine(self, query) -> bool:
        """One stepwise frame: cold start at multiscale (4, 1) from the
        upright pose, or a steady frame at (1,) with the object mask."""
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

        refset = self.get_dynamic_reference(self.pose)
        results: Dict[int, RefineResult] = {}
        for ref_id in self.reference_ids:
            results[ref_id] = self.refiner.refine(
                query_image, self.camera, self.pose, refset.for_ref(ref_id), multiscale=multiscale
            )
        best_id = min(results, key=lambda k: results[k].cost)
        best = results[best_id]
        for _ in range(self.config.refine_rounds - 1):
            if not best.success:
                break
            ref2 = self._create_reference(best.T_refined)
            nxt = self.refiner.refine(query_image, self.camera, best.T_refined,
                                      ref2.for_ref(best_id), multiscale=self.config.steady_multiscale)
            if not nxt.success:
                break
            nxt.T_init = best.T_init
            best = nxt

        if self.cost_threshold is None and np.isfinite(best.cost):
            self.cost_threshold = max(best.cost * self.config.cost_threshold_factor,
                                      self.config.cost_threshold_min)
        success = best.success and best.cost <= (self.cost_threshold or np.inf)
        if success:
            self.pose = best.T_refined
        self.success = success
        name = os.path.basename(str(query_path))
        cam = self.camera
        self.pose_history[name] = {
            "success": success,
            "T_init": best.T_init.to_4x4().cpu().numpy(),
            "T_refined": best.T_refined.to_4x4().cpu().numpy(),
            "camera": {k: getattr(cam, k).cpu().numpy() for k in ("size", "f", "c", "k")},
            "cost": best.cost,
            "reference_ids": list(self.reference_ids),
            "query_path": str(query_path),
        }
        self.trace.append({
            "frame": name,
            "cost": best.cost,
            "ref_costs": {int(k): float(v.cost) for k, v in results.items()},
            "best_ref": int(best_id),
            "num_iters": best.num_iters,
            "num_valid": best.num_valid,
            "cache_hit": self.cache_hit,
            "success": success,
        })
        return success

    def run_fused(self, frames, camera: Optional[Camera] = None):
        """Closed-loop tracking: a stepwise cold start, then one fused
        steady-state frame per query (tracking/fused.py)."""
        from pixtrack_tpu_torch.tracking.fused import run_fused

        return run_fused(self, frames, camera=camera)

    def save_poses(self) -> None:
        """``poses.pkl`` (pose_history) and ``trackers.pkl`` (trace) under eval_path."""
        if self.eval_path is None:
            return
        os.makedirs(self.eval_path, exist_ok=True)
        with open(Path(self.eval_path) / "poses.pkl", "wb") as f:
            pickle.dump(self.pose_history, f)
        with open(Path(self.eval_path) / "trackers.pkl", "wb") as f:
            pickle.dump(self.trace, f)

    @property
    def stats(self) -> dict:
        return {
            "cache_hits": self.hits,
            "cache_misses": self.misses,
            "relocalizations": self.relocalization_count,
            "frames": len(self.pose_history),
        }
