"""Scale-out: B videos refined in lockstep on one card or split over several,
and the (dp, tp) NeRF trainer, one process a card."""

from pixtrack_tpu_torch.parallel.mesh import (
    Mesh,
    batch_align,
    gather_field,
    launch,
    make_mesh,
    shard_field_params,
    sharded_nerf_train_step,
    unshard_field_params,
)
from pixtrack_tpu_torch.parallel.video import (
    make_production_video_tracker,
    make_video_tracker,
    track_video_batch,
)

__all__ = ["Mesh", "batch_align", "gather_field", "launch", "make_mesh", "make_production_video_tracker",
           "make_video_tracker", "shard_field_params", "sharded_nerf_train_step", "track_video_batch",
           "unshard_field_params"]
