"""Batched pose alignment: many videos' or objects' pose refines at once.

Port of ``sharded_batch_align`` (``pixtrack_tpu/parallel/mesh.py:115-142``).
The JAX package builds a ``(dp, tp)`` device mesh and shards this batch over
``dp``; on one card the batch is the leading axis of the tensors and the
LM's batched carry (``align.lm``) does what ``vmap`` does there.

``make_mesh``, ``shard_field_params`` and ``sharded_nerf_train_step`` are
not ported: they shard the NeRF's rays over ``dp`` and its hash table over
``tp`` across several chips, and one card has no such axis. Its
data-parallel training step is ``nerf/train.py``'s; a multi-card port comes
only if a multi-GPU consumer appears.
"""

from __future__ import annotations

from pixtrack_tpu_torch.align.lm import AlignConfig, AlignState, LevelData, align_level
from pixtrack_tpu_torch.geometry import Camera, Pose


def batch_align(T_b: Pose, levels_b: LevelData, cam_b: Camera, cfg: AlignConfig = AlignConfig(num_iters=8)
                ) -> AlignState:
    """``align_level`` at 8 iterations over B problems: poses (B,), a level
    whose tensors lead with B (scale (B, 2) or (2,)) and B cameras ((B, 2)
    fields) or one. Returns the (B,)-batched state."""
    return align_level(T_b, levels_b, cam_b, cfg)
