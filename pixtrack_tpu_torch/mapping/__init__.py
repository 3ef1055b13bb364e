"""Mapping: mesh loading, rasterisation and the mapping rig, surface
sampling, NeRF dataset creation from an SfM scene (host side), the
posed-view SfM (detection, matching, triangulation, augmentation), and the
unposed SfM (two-view geometry, PnP, global averaging, the incremental
mapper).

The checkpoint paths of the learned SfM components are resolved as the JAX
package resolves them (``pixtrack_tpu/mapping/__init__.py``): the CLI's
``auto`` choices look there. The components themselves are not ported yet.
"""

import os
from pathlib import Path

from pixtrack_tpu_torch.mapping.detector import describe_keypoints, detect_keypoints
from pixtrack_tpu_torch.mapping.global_init import average_rotations, average_translations, global_initialize
from pixtrack_tpu_torch.mapping.incremental import (
    decompose_homography,
    estimate_relative_pose,
    incremental_sfm,
    refine_pose_reprojection,
    refine_relative_pose_sampson,
)
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

_ASSETS = Path(__file__).resolve().parents[2] / "assets"


def default_matcher_weights_path() -> Path:
    """The attention-matcher checkpoint (assets/matcher.npz), overridable
    via PIXTRACK_MATCHER_WEIGHTS."""
    env = os.environ.get("PIXTRACK_MATCHER_WEIGHTS")
    return Path(env) if env else _ASSETS / "matcher.npz"


def default_superpoint_weights_path() -> Path:
    """The SuperPoint checkpoint (assets/superpoint.npz), overridable via
    PIXTRACK_SUPERPOINT_WEIGHTS."""
    env = os.environ.get("PIXTRACK_SUPERPOINT_WEIGHTS")
    return Path(env) if env else _ASSETS / "superpoint.npz"


def default_descriptor_weights_path() -> Path:
    """The dense-descriptor checkpoint (assets/dense_descriptor.npz),
    overridable via PIXTRACK_DENSE_DESCRIPTOR_WEIGHTS."""
    env = os.environ.get("PIXTRACK_DENSE_DESCRIPTOR_WEIGHTS")
    return Path(env) if env else _ASSETS / "dense_descriptor.npz"


__all__ = ["average_rotations", "average_translations", "decompose_homography", "default_descriptor_weights_path",
           "default_matcher_weights_path", "default_superpoint_weights_path", "describe_keypoints",
           "detect_keypoints", "estimate_relative_pose", "exhaustive_pairs", "global_initialize",
           "icosphere_directions", "incremental_sfm", "load_obj", "look_at_rig_for_mesh", "match_descriptors",
           "read_png", "refine_pose_reprojection", "refine_relative_pose_sampson", "render_mesh",
           "sample_mesh_surface", "triangulate_scene", "triangulate_tracks", "write_png"]
