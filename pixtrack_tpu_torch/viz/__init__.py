"""Visualization: pose-axes overlays, NeRF/query blending, video export."""

from pixtrack_tpu_torch.viz.overlay import (
    blend_images,
    draw_pose_axes,
    draw_object_center,
    draw_aabb_box,
    draw_error_text,
    render_pose_overlays,
)

__all__ = [
    "blend_images",
    "draw_pose_axes",
    "draw_object_center",
    "draw_aabb_box",
    "draw_error_text",
    "render_pose_overlays",
]
