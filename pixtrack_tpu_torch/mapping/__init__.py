"""Mapping: mesh loading, rasterisation and surface sampling (host side)."""

from pixtrack_tpu_torch.mapping.mesh_render import load_obj, read_png, render_mesh, sample_mesh_surface

__all__ = ["load_obj", "read_png", "render_mesh", "sample_mesh_surface"]
