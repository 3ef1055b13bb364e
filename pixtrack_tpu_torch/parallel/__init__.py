"""Offline tracking at batch on one card: B videos refined in lockstep."""

from pixtrack_tpu_torch.parallel.mesh import batch_align
from pixtrack_tpu_torch.parallel.video import (
    make_production_video_tracker,
    make_video_tracker,
    track_video_batch,
)

__all__ = ["batch_align", "make_production_video_tracker", "make_video_tracker", "track_video_batch"]
