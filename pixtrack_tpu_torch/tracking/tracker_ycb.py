"""YCB-Video evaluation tracker.

Port of ``pixtrack_tpu/tracking/tracker_ycb.py``, the GT-assisted evaluation
protocol: the same engine as the flagship tracker, but
- frames carry dataset GT poses and calibrated cameras (``YCBVideoIterator``);
- cold start / relocalization snap to the GT pose;
- the object mask is applied on EVERY frame;
- reference selection searches the FULL model, not covisibility neighbours;
- per-frame translation/rotation errors vs GT are recorded and success is
  gated at t < 10 cm AND r < 10 deg;
- ``reference_scale`` defaults to 0.3.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from pixtrack_tpu_torch.eval.metrics import evaluate_trajectory, pose_errors
from pixtrack_tpu_torch.geometry import Pose
from pixtrack_tpu_torch.geometry.rotation import geodesic_distance, quat_to_rotmat
from pixtrack_tpu_torch.tracking.tracker import PixTrackTracker, TrackerConfig


def ycb_tracker_config(**overrides) -> TrackerConfig:
    base = dict(
        reference_scale=0.3,
        mask_always=True,
        use_mask=True,
        cold_multiscale=(4, 1),
        steady_multiscale=(1,),
    )
    base.update(overrides)
    return TrackerConfig(**base)


class YCBTracker(PixTrackTracker):
    """Tracker over (path, image, gt_pose, camera) tuples with GT gating."""

    def __init__(self, *args, t_gate: float = 0.10, r_gate_deg: float = 10.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.t_gate = t_gate
        self.r_gate_deg = r_gate_deg
        self.errors: List[dict] = []
        self._gt_pose: Optional[Pose] = None
        # every reference rotation of the model, on the device
        self._ref_Rs = quat_to_rotmat(torch.as_tensor(np.asarray(self.scene.qvecs), dtype=torch.float32,
                                                      device=self.device))

    def update_reference_ids(self) -> List[int]:
        """Full-model reference search (no covisibility restriction)."""
        if self.cache_hit:
            return self.reference_ids
        dists = geodesic_distance(self.pose.R.to(self.device)[None], self._ref_Rs)
        # a stable sort, as numpy's argsort over the same distances
        order = torch.sort(dists, stable=True).indices[: self.config.num_refs].cpu().numpy()
        self.reference_ids = [int(self.scene.image_ids[i]) for i in order]
        return self.reference_ids

    def relocalize(self, query) -> None:
        """Snap to the dataset GT pose. ``query`` is the 4-tuple from the
        eval loop, or the 2-tuple the inherited cold-start path passes
        (``PixTrackTracker.refine`` strips GT before relocalizing): then the
        GT stashed by ``refine`` is the current frame's."""
        if len(query) == 4:
            _, _, gt_pose, camera = query
            self.camera = camera.to(self.device)
            self.pose = self._on_device(gt_pose)
        else:
            assert self._gt_pose is not None, "cold start before refine()"
            self.pose = self._gt_pose
        self.relocalization_count += 1

    def _on_device(self, pose: Pose) -> Pose:
        return Pose(R=pose.R.to(self.device), t=pose.t.to(self.device))

    def refine(self, query) -> bool:
        path, image, gt_pose, camera = query
        self._gt_pose = self._on_device(gt_pose)
        if self.camera is None:
            self.camera = camera.to(self.device)
        ok = super().refine((path, image))
        rec = self.pose_history[list(self.pose_history)[-1]]
        T, T_gt = rec["T_refined"], gt_pose.to_4x4().cpu().numpy()
        r_err, t_err = pose_errors(T[:3, :3], T[:3, 3], T_gt[:3, :3], T_gt[:3, 3])
        rec["gt_pose"] = T_gt
        rec["t_error"] = t_err
        rec["r_error_deg"] = r_err
        self.errors.append({"frame": rec["query_path"], "t": t_err, "r": r_err})
        gated = ok and t_err < self.t_gate and r_err < self.r_gate_deg
        self.success = gated
        rec["success"] = gated
        return gated

    def summary(self, model_points: Optional[np.ndarray] = None) -> dict:
        est, gt = [], []
        for rec in self.pose_history.values():
            Te = rec["T_refined"]
            Tg = rec.get("gt_pose")
            if Tg is None:
                continue
            est.append((Te[:3, :3], Te[:3, 3]))
            gt.append((Tg[:3, :3], Tg[:3, 3]))
        return evaluate_trajectory(est, gt, model_points=model_points, add_auc_threshold=0.1)
