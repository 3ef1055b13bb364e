"""Tracking: the refiner, the PixTrack tracker, its video loop and its fused
steady-state frame; the tracker lineage (``variants``), the YCB evaluation
tracker (``tracker_ycb``), the optimizer trace (``debug``) and the
reference-feature store (``feature_io``) are imported from their modules."""

from pixtrack_tpu_torch.tracking.base import PoseTracker
from pixtrack_tpu_torch.tracking.fused import FusedSteadyStep, run_fused
from pixtrack_tpu_torch.tracking.refiner import Refiner, RefineResult, infer_camera_from_image
from pixtrack_tpu_torch.tracking.tracker import PixTrackTracker, TrackerConfig

__all__ = [
    "FusedSteadyStep",
    "run_fused",
    "Refiner",
    "RefineResult",
    "infer_camera_from_image",
    "PoseTracker",
    "PixTrackTracker",
    "TrackerConfig",
]
