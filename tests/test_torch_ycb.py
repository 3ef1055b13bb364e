"""Parity of the port's YCB evaluation tracker with the JAX package on the
CPU: tests/test_tracker_ycb.py's three cases on synthetic frames in the YCB
tuple protocol (path, image, gt Pose, camera), each run through both
packages' ``YCBTracker``.

Tolerances: against the ground truth as the JAX test (rotation median under
5 deg, translation median under 0.05, mean rotation under 6 deg); between the
packages, per frame: the same reference ids and success flags, poses and the
recorded GT errors within 0.25 deg and 5e-3, costs within 10 % plus 5e-6, and
every ``summary()`` entry within 0.25 deg, 5e-3 or 2e-2 of an AUC. These are
wider than the variant trackers' (tests/test_torch_variants.py): this
tracker renders its reference anew at every estimate, twice a frame, the two
packages' renders differ in a few bf16 roundings, and the queries are renders
of the same field, so the costs are ~1e-5 and the minimum is flat.
"""

import numpy as np
import pytest
import torch

from pixtrack_tpu.align.lm import AlignConfig as JAlignConfig
from pixtrack_tpu.features import FeatureExtractor as JExtractor
from pixtrack_tpu.features import HandcraftedExtractor as JHandcrafted
from pixtrack_tpu.tracking import tracker_ycb as jycb
from pixtrack_tpu_torch.align.lm import AlignConfig
from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
from pixtrack_tpu_torch.tracking import tracker_ycb as tycb

from test_torch_world import keep_samples, paired_world

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = paired_world(tmp_path_factory.mktemp("ycb"), res=96, n_frames=4)
    # one JAX extractor and one LM program cache for every tracker of this file: each compiles once
    w.jextractor, w.jit_cache = JExtractor(JHandcrafted(), resize=None), {}
    return w


def _trackers(world, **overrides):
    cfg = dict(reference_scale=1.0, cold_multiscale=(1,), steady_multiscale=(1,), cost_threshold_min=0.05,
               refine_rounds=2, **overrides)
    jtr = jycb.YCBTracker(world.j.scene, world.jextractor, world.j.testbed,
                          world.j.nerf2sfm, jycb.ycb_tracker_config(**cfg),
                          align_cfg=JAlignConfig(num_iters=40, robust_c=1.0))
    jtr.refiner._refine_jit = world.jit_cache
    ttr = tycb.YCBTracker(world.t.scene, FeatureExtractor(HandcraftedExtractor(device="cpu"), resize=None),
                          world.t.testbed, world.t.nerf2sfm, tycb.ycb_tracker_config(**cfg),
                          align_cfg=AlignConfig(num_iters=40, robust_c=1.0))
    keep_samples(world)
    return jtr, ttr


def _sequences(world, frames=None):
    frames = frames or world.frames
    return ([(n, im, world.j.gt[i], world.j.camera) for i, (n, im) in enumerate(frames)],
            [(n, im, world.t.gt[i], world.t.camera) for i, (n, im) in enumerate(frames)])


def _same_records(jtr, ttr):
    assert list(jtr.pose_history) == list(ttr.pose_history)
    for name, rj in jtr.pose_history.items():
        rt = ttr.pose_history[name]
        assert rj["success"] == rt["success"], name
        assert list(rj["reference_ids"]) == list(rt["reference_ids"]), name
        if np.isfinite(rj["cost"]):
            np.testing.assert_allclose(rt["cost"], rj["cost"], rtol=0.1, atol=5e-6, err_msg=name)
        assert abs(rj["r_error_deg"] - rt["r_error_deg"]) < 0.25 and abs(rj["t_error"] - rt["t_error"]) < 5e-3, name
        Tj, Tt = np.asarray(rj["T_refined"], np.float64), np.asarray(rt["T_refined"], np.float64)
        ang = np.rad2deg(np.arccos(np.clip((np.trace(Tj[:3, :3] @ Tt[:3, :3].T) - 1) / 2, -1, 1)))
        assert ang < 0.25 and np.abs(Tj[:3, 3] - Tt[:3, 3]).max() < 5e-3, (name, ang)
        np.testing.assert_array_equal(np.asarray(rj["gt_pose"]), rt["gt_pose"])
    assert jtr.relocalization_count == ttr.relocalization_count


def test_ycb_config_matches():
    import dataclasses

    assert dataclasses.asdict(jycb.ycb_tracker_config()) == dataclasses.asdict(tycb.ycb_tracker_config())
    cfg = tycb.ycb_tracker_config(num_refs=3)
    assert cfg.reference_scale == 0.3 and cfg.mask_always and cfg.num_refs == 3


def test_tracks_with_gt_protocol(world):
    jtr, ttr = _trackers(world)
    jseq, tseq = _sequences(world)
    jtr.run(jseq)
    ttr.run(tseq)
    # the cold start snapped to the ground truth
    first = ttr.pose_history[world.frames[0][0]]
    np.testing.assert_array_equal(first["T_init"], world.t.gt[0].to_4x4().numpy())
    assert ttr.relocalization_count >= 1
    assert len(ttr.errors) == len(tseq)
    assert np.median([e["r"] for e in ttr.errors]) < 5.0 and np.median([e["t"] for e in ttr.errors]) < 0.05
    for rec in ttr.pose_history.values():
        assert {"gt_pose", "t_error", "r_error_deg"} <= set(rec) and rec["success"]
    _same_records(jtr, ttr)
    sj, st = jtr.summary(model_points=world.j.scene.xyz), ttr.summary(model_points=world.t.scene.xyz)
    assert set(sj) == set(st) and {"add_auc", "add_s_auc", "mean_add", "median_r_deg"} <= set(st)
    assert st["mean_r_deg"] < 6.0
    for k in sj:  # degrees; accuracies and AUCs in [0, 1]; lengths (mean_t, mean_add, ...)
        atol = 0.25 if k.endswith("_deg") else (2e-2 if k.startswith(("acc_", "add_", "success_")) else 5e-3)
        np.testing.assert_allclose(st[k], sj[k], atol=atol, err_msg=k)


def test_full_model_reference_search(world):
    """The geodesic-nearest image over the FULL model, not the covisibility
    neighbours, and the same ids (in order) as the JAX tracker's for K = 3."""
    jtr, ttr = _trackers(world, num_refs=3)
    for k in (3, 7, 10):
        iid = world.j.scene.image_ids[k]
        jtr.pose, ttr.pose = world.j.scene.pose_w2c(iid), world.t.scene.pose_w2c(iid)
        jtr.cache_hit = ttr.cache_hit = False
        ids = ttr.update_reference_ids()
        assert ids[0] == int(iid) and ids == jtr.update_reference_ids()
    ttr.cache_hit = True  # a cached reference keeps its ids
    ttr.pose = world.t.scene.pose_w2c(world.t.scene.image_ids[0])
    assert ttr.update_reference_ids() == ids


def test_gate_fails_bad_frame_and_relocalizes_to_gt(world):
    """A noise frame fails the 10 cm / 10 deg gate; the next frame snaps to
    the dataset GT pose and recovers, in both packages alike."""
    jtr, ttr = _trackers(world)
    noise = np.random.default_rng(7).integers(0, 256, (96, 96, 3)).astype(np.uint8)
    frames = world.frames[:2] + [("noise.png", noise)] + world.frames[3:]  # frame 3 follows the noise
    jseq, tseq = _sequences(world, frames)
    jtr.run(jseq)
    ttr.run(tseq)
    assert not ttr.pose_history["noise.png"]["success"]
    assert ttr.relocalization_count >= 2
    rec = ttr.pose_history["frame_0003.png"]
    assert rec["success"] and rec["r_error_deg"] < 5.0 and rec["t_error"] < 0.05
    np.testing.assert_array_equal(rec["T_init"], world.t.gt[3].to_4x4().numpy())
    _same_records(jtr, ttr)
