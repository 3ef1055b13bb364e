"""Mapping: mesh loading, rasterisation and the mapping rig, surface
sampling, and NeRF dataset creation from an SfM scene (host side)."""

from pixtrack_tpu_torch.mapping.mesh_render import (
    icosphere_directions,
    load_obj,
    look_at_rig_for_mesh,
    read_png,
    render_mesh,
    sample_mesh_surface,
)

__all__ = ["icosphere_directions", "load_obj", "look_at_rig_for_mesh", "read_png", "render_mesh",
           "sample_mesh_surface"]
