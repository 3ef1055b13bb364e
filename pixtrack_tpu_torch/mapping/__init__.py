"""Mapping: mesh loading, rasterisation and the mapping rig, surface
sampling, NeRF dataset creation from an SfM scene (host side), the
posed-view SfM (detection, matching, triangulation, augmentation), and the
unposed SfM (two-view geometry, PnP, global averaging, the incremental
mapper).

SuperPoint's trainers are ``mapping.train_superpoint`` (the MagicPoint
recipe with its texture label bank, and the two repeatability gates) and
``mapping.train_superpoint_dense`` (dense distillation on a pair bank);
their configurations and gates are exported here.

The learned SfM components at inference (``dense_descriptor``,
``superpoint``, ``attention_matcher``) are loaded from their checkpoints as
the JAX package loads them (``pixtrack_tpu/mapping/__init__.py``):
``default_matcher``, ``default_detector`` and ``default_descriptor`` return
None when no checkpoint is found, and the CLI's ``auto`` choices then fall
back to Harris + mutual-NN / ratio.
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
from pixtrack_tpu_torch.mapping.train_superpoint import SPTrainConfig, mesh_repeatability, repeatability
from pixtrack_tpu_torch.mapping.train_superpoint_dense import SPDenseConfig
from pixtrack_tpu_torch.mapping.triangulate import triangulate_scene, triangulate_tracks

_ASSETS = Path(__file__).resolve().parents[2] / "assets"


def default_matcher_weights_path() -> Path:
    """The attention-matcher checkpoint (assets/matcher.npz), overridable
    via PIXTRACK_MATCHER_WEIGHTS."""
    env = os.environ.get("PIXTRACK_MATCHER_WEIGHTS")
    return Path(env) if env else _ASSETS / "matcher.npz"


def default_matcher(min_score: float = 0.2, device=None):
    """The production pair matcher for SfM (the SuperGlue-weights role): the
    trained attention matcher on ``device`` (None is the CUDA card) when its
    checkpoint is found, else None (mutual-NN + ratio inside
    ``incremental_sfm``). Its ``.desc_dim`` lets callers check the
    detector's descriptors against it."""
    path = default_matcher_weights_path()
    if not path.exists():
        return None
    from pixtrack_tpu_torch.mapping.attention_matcher import LearnedMatcher, load_matcher_weights

    model, _ = load_matcher_weights(path, device=device)
    return LearnedMatcher(model, min_score=min_score)


def default_superpoint_weights_path() -> Path:
    """The SuperPoint checkpoint (assets/superpoint.npz), overridable via
    PIXTRACK_SUPERPOINT_WEIGHTS."""
    env = os.environ.get("PIXTRACK_SUPERPOINT_WEIGHTS")
    return Path(env) if env else _ASSETS / "superpoint.npz"


def default_detector(max_keypoints: int = 1024, device=None, **kw):
    """The learned keypoint detector for SfM (the SuperPoint-weights role):
    SuperPoint on ``device`` (None is the CUDA card) when its checkpoint is
    found, else None (multi-scale Harris inside ``incremental_sfm``).

    Returns a ``detect(image, max_keypoints=..., **kw) -> (kp, scores,
    desc)`` callable with ``.desc_dim`` / ``.name``, the contract of
    ``detector.detect_and_describe``; Harris's ``nms_radius`` is dropped."""
    path = default_superpoint_weights_path()
    if not path.exists():
        return None
    from pixtrack_tpu_torch.mapping.superpoint import extract_superpoint, load_superpoint_weights

    net = load_superpoint_weights(path, device=device)

    def detect(image, max_keypoints=max_keypoints, **kw2):
        merged = {**kw, **kw2}
        merged.pop("nms_radius", None)  # Harris-specific knob
        return extract_superpoint(net, image, max_keypoints=max_keypoints, **merged)

    detect.desc_dim = 256
    detect.name = "superpoint"
    return detect


def default_descriptor_weights_path() -> Path:
    """The dense-descriptor checkpoint (assets/dense_descriptor.npz),
    overridable via PIXTRACK_DENSE_DESCRIPTOR_WEIGHTS."""
    env = os.environ.get("PIXTRACK_DENSE_DESCRIPTOR_WEIGHTS")
    return Path(env) if env else _ASSETS / "dense_descriptor.npz"


def default_descriptor(max_keypoints: int = 1024, device=None, **kw):
    """The learned SfM feature extractor (``reconstruct --detector dense``):
    Harris keypoints described by the InfoNCE-trained half-resolution dense
    descriptor (``mapping/dense_descriptor.py``), on ``device`` (None is the
    CUDA card); None when no checkpoint is found. The callable carries
    ``.desc_dim``, ``.name`` and ``.match_kw``, the matcher's operating point
    the descriptor was accepted at (``assets/dense_descriptor_eval.json``)."""
    path = default_descriptor_weights_path()
    if not path.exists():
        return None
    from pixtrack_tpu_torch.mapping.dense_descriptor import describe_at_dense, load_descriptor_weights

    net = load_descriptor_weights(path, device=device)
    dev = next(net.parameters()).device

    def detect(image, max_keypoints=max_keypoints, **kw2):
        kp, sc = detect_keypoints(image, max_keypoints=max_keypoints, device=dev, **{**kw, **kw2})
        return kp, sc, describe_at_dense(net, image, kp.cpu().numpy())

    detect.desc_dim = 128
    detect.name = "harris+dense"
    detect.match_kw = dict(min_score=0.1, ratio=0.98)
    return detect


__all__ = ["average_rotations", "average_translations", "decompose_homography", "default_descriptor",
           "default_descriptor_weights_path", "default_detector", "default_matcher", "default_matcher_weights_path",
           "default_superpoint_weights_path", "describe_keypoints", "detect_keypoints", "estimate_relative_pose",
           "exhaustive_pairs", "global_initialize", "icosphere_directions", "incremental_sfm", "load_obj",
           "look_at_rig_for_mesh", "match_descriptors", "mesh_repeatability", "read_png", "refine_pose_reprojection",
           "refine_relative_pose_sampson", "render_mesh", "repeatability", "sample_mesh_surface", "SPDenseConfig",
           "SPTrainConfig", "triangulate_scene", "triangulate_tracks", "write_png"]
