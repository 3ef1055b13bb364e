"""Mapping: mesh loading, rasterisation and the mapping rig, surface
sampling, NeRF dataset creation from an SfM scene (host side), and the
posed-view SfM: detection, matching, triangulation, augmentation."""

from pixtrack_tpu_torch.mapping.detector import describe_keypoints, detect_keypoints
from pixtrack_tpu_torch.mapping.matcher import exhaustive_pairs, match_descriptors
from pixtrack_tpu_torch.mapping.mesh_render import (
    icosphere_directions,
    load_obj,
    look_at_rig_for_mesh,
    read_png,
    render_mesh,
    sample_mesh_surface,
    write_png,
)
from pixtrack_tpu_torch.mapping.triangulate import triangulate_scene, triangulate_tracks

__all__ = ["describe_keypoints", "detect_keypoints", "exhaustive_pairs", "icosphere_directions", "load_obj",
           "look_at_rig_for_mesh", "match_descriptors", "read_png", "render_mesh", "sample_mesh_surface",
           "triangulate_scene", "triangulate_tracks", "write_png"]
