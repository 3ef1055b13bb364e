"""Refiner: feature-metric pose refinement against reference observations.

Port of ``pixtrack_tpu/tracking/refiner.py``: ``Refiner.select_points``,
``extract_reference_features``, ``extract_reference_set``, ``refine``
(multiscale), the optional ``DebugTracker`` hook (``attach_tracker``; with
none attached ``refine`` runs ``align_pyramid`` as it always did), and
``infer_camera_from_image``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch.align.interpolate import interpolate_scalar
from pixtrack_tpu_torch.align.lm import AlignConfig, align_level_traced, align_pyramid
from pixtrack_tpu_torch.align.observations import build_level_data, observe_points
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.tracking.mask import erode


@dataclasses.dataclass
class RefineResult:
    success: bool
    T_init: Pose
    T_refined: Pose
    cost: float
    num_valid: int
    num_iters: int
    costs_per_scale: Optional[list] = None


@dataclasses.dataclass
class ReferenceFeatures:
    """One reference image's observation pack."""

    p3d: torch.Tensor
    mask: torch.Tensor
    feats: Tuple[torch.Tensor, ...]
    weights: Tuple[torch.Tensor, ...]
    valids: Tuple[torch.Tensor, ...]
    pose: Pose
    ref_ids: Sequence[int]


@dataclasses.dataclass
class ReferenceSet:
    """One rendered view observed once per reference id."""

    pose: Pose
    ref_ids: Sequence[int]
    per_ref: Dict[int, ReferenceFeatures]

    def for_ref(self, ref_id: int) -> ReferenceFeatures:
        return self.per_ref[int(ref_id)]


class Refiner:
    def __init__(self, scene, extractor, align_cfg: AlignConfig = AlignConfig(),
                 min_points_opt: int = 10, min_track_length: int = 1, pad_multiple: int = 1024):
        self.scene = scene
        self.extractor = extractor
        self.align_cfg = align_cfg
        self.min_points_opt = min_points_opt
        self.min_track_length = min_track_length
        self.pad_multiple = pad_multiple
        self.tracker = None  # optional DebugTracker, see attach_tracker

    def attach_tracker(self, tracker) -> None:
        """Attach a DebugTracker; refinement then records per-iteration
        optimizer traces (and dense maps at debug >= 2)."""
        self.tracker = tracker

    @property
    def device(self) -> torch.device:
        return self.extractor.device

    def select_points(self, ref_ids: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed (P, 3) points observed by ``ref_ids`` and their (P,) mask."""
        idx = self.scene.p3d_indices_for_images(ref_ids, min_track_length=self.min_track_length)
        xyz, mask = self.scene.pack_points(idx, pad_multiple=self.pad_multiple)
        return torch.as_tensor(xyz, device=self.device), torch.as_tensor(mask, device=self.device)

    def extract_reference_features(self, ref_ids, pose_w2c: Pose, ref_image, ref_camera: Camera,
                                   ref_alpha=None, interior_erode: int = 7) -> ReferenceFeatures:
        """Observe the points of ``ref_ids`` in a reference view (a stored
        image, or a render at ``pose_w2c`` with ``ref_camera``). With
        ``ref_alpha`` the observations are weighted by the eroded silhouette
        interior, which keeps the background edge out of the descriptors."""
        p3d, mask = self.select_points(ref_ids)
        pyr = self.extractor(ref_image)
        interior = self._interior_map(ref_alpha, interior_erode)
        return self._observe_reference(pyr, interior, p3d, mask, pose_w2c, ref_camera, list(ref_ids))

    def extract_reference_set(self, ref_ids, pose_w2c: Pose, ref_image, ref_camera: Camera,
                              ref_alpha=None, interior_erode: int = 7) -> ReferenceSet:
        """Observation packs of each reference id's own points in ONE render."""
        pyr = self.extractor(ref_image)
        interior = self._interior_map(ref_alpha, interior_erode)
        per_ref = {}
        for rid in ref_ids:
            p3d, mask = self.select_points([rid])
            per_ref[int(rid)] = self._observe_reference(
                pyr, interior, p3d, mask, pose_w2c, ref_camera, [int(rid)]
            )
        return ReferenceSet(pose=pose_w2c, ref_ids=[int(r) for r in ref_ids], per_ref=per_ref)

    def _interior_map(self, ref_alpha, interior_erode: int):
        if ref_alpha is None or interior_erode <= 0:
            return None
        alpha = torch.as_tensor(np.asarray(ref_alpha), device=self.device)
        return erode((alpha > 0.5).float(), size=interior_erode)

    def _observe_reference(self, pyr, interior, p3d, mask, pose_w2c, ref_camera, ref_ids):
        feats, weights, valids = observe_points(pyr, pose_w2c, ref_camera, p3d, mask)
        if interior is not None:
            # the interior map is at full reference resolution
            p2d_img, _ = ref_camera.world2image(pose_w2c, p3d)
            wi, _ = interpolate_scalar(interior, p2d_img)
            weights = tuple(w * wi for w in weights)
        return ReferenceFeatures(p3d=p3d, mask=mask, feats=feats, weights=weights,
                                 valids=valids, pose=pose_w2c, ref_ids=ref_ids)

    def refine(self, query_image, camera: Camera, T_init: Pose, ref_feats: ReferenceFeatures,
               multiscale: Sequence[int] = (1,)) -> RefineResult:
        """Coarse-to-fine over image scales, then pyramid levels."""
        if int(ref_feats.mask.sum()) < self.min_points_opt:
            return RefineResult(success=False, T_init=T_init, T_refined=T_init,
                                cost=float("inf"), num_valid=0, num_iters=0)
        debug = self.tracker is not None and self.tracker.debug >= 1
        T = T_init
        costs = []
        last = None
        for image_scale in multiscale:
            pyr = self.extractor(query_image, image_scale=int(image_scale))
            levels = build_level_data(pyr, ref_feats.feats, ref_feats.weights,
                                      ref_feats.valids, ref_feats.p3d, ref_feats.mask)
            if debug:
                last = self._refine_traced(T, levels, camera)
            else:
                last, _ = align_pyramid(T, levels, camera, self.align_cfg)
            T = last.T
            costs.append(float(last.cost))
        if debug:
            self.tracker.log_optim_done(T, p3d=ref_feats.p3d, cost=costs[-1])
        ok = bool(np.isfinite(costs[-1])) and int(last.num_valid) >= self.min_points_opt
        return RefineResult(success=ok, T_init=T_init, T_refined=T, cost=costs[-1],
                            num_valid=int(last.num_valid), num_iters=int(last.num_iters),
                            costs_per_scale=costs)


    def _refine_traced(self, T, levels, camera):
        """Coarse-to-fine with per-iteration traces fed to the attached
        DebugTracker (``align_level_traced`` per level)."""
        for li, data in enumerate(reversed(levels)):
            st, trace = align_level_traced(T, data, camera, self.align_cfg)
            level_idx = len(levels) - 1 - li
            self.tracker.log_optim_iter(level_idx, trace)
            if self.tracker.debug >= 2:
                self.tracker.log_dense(level_idx, data.fmap, data.conf)
            T = st.T
        return st


def infer_camera_from_image(image_or_shape, focal_factor: float = 1.2, device=None) -> Camera:
    """SIMPLE_RADIAL camera with f = 1.2 max(w, h), principal point at the centre."""
    if hasattr(image_or_shape, "shape"):
        h, w = image_or_shape.shape[:2]
    else:
        h, w = image_or_shape
    f = focal_factor * max(w, h)
    return Camera.from_colmap("SIMPLE_RADIAL", [f, w / 2.0, h / 2.0, 0.0], w, h, device=device)
