"""SfM layer: the scene container over the COLMAP reader."""

from pixtrack_tpu_torch.sfm.scene import SceneModel

__all__ = ["SceneModel"]
