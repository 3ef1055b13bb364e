"""Parity of the port's optimizer trace (``DebugTracker`` through the
Refiner's hook) and reference-feature store (``feature_io``) with the JAX
package on the CPU, mirroring tests/test_debug_and_feature_io.py.

Tolerances: the traced refinement's per-iteration costs within 5e-3
relative plus 1e-6 of JAX's over the first three iterations of every level
(in this world the queries are renders of the field the references come
from: the costs are ~1e-5, and once at the optimum the traced loop, which
has no stagnation rule, goes on until rounding hands it a small accepted
step or the budget ends, so the counts differ: measured 11 vs 25); with the tracker
attached the refined pose and cost equal JAX's traced ones, and the plain
refinement's, within 0.5 deg, 5e-3 and 10 % plus 5e-6 (the minimum is that
flat; measured 0.2 deg. The traced LM is the classic loop, not the
deferred-accept one; tests/test_torch_align.py holds both on a well-posed
problem to 0.02 deg); the
feature store round trip across packages is exact for the arrays it holds
(f32 in, f32 out).
"""

import numpy as np
import pytest
import torch

from pixtrack_tpu.align.lm import AlignConfig as JAlignConfig
from pixtrack_tpu.features import FeatureExtractor as JExtractor
from pixtrack_tpu.features import HandcraftedExtractor as JHandcrafted
from pixtrack_tpu.tracking import PixTrackTracker as JTracker
from pixtrack_tpu.tracking import TrackerConfig as JTrackerConfig
from pixtrack_tpu.tracking import feature_io as jio
from pixtrack_tpu.tracking.debug import DebugTracker as JDebugTracker
from pixtrack_tpu.tracking.variants import StaticRefConfig as JStaticRefConfig
from pixtrack_tpu.tracking.variants import StaticRefTracker as JStaticRefTracker
from pixtrack_tpu_torch.align.lm import AlignConfig
from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
from pixtrack_tpu_torch.geometry import Pose
from pixtrack_tpu_torch.tracking import PixTrackTracker, TrackerConfig
from pixtrack_tpu_torch.tracking import feature_io as tio
from pixtrack_tpu_torch.tracking.debug import DebugTracker
from pixtrack_tpu_torch.tracking.variants import StaticRefConfig, StaticRefTracker

from test_torch_world import keep_samples, paired_world, pose_error

torch.set_num_threads(2)
CFG = dict(reference_scale=1.0, cold_multiscale=(1,), steady_multiscale=(1,), covis_threshold=10,
           cost_threshold_min=0.1)
STATIC_CFG = dict(use_mask=False, cold_multiscale=(1,), steady_multiscale=(1,), reference_scale=1.0,
                  covis_threshold=10, cost_threshold_min=0.2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return paired_world(tmp_path_factory.mktemp("debug_io"), res=64, n_frames=3)


def _trackers(world, n_iters):
    jtr = JTracker(world.j.scene, JExtractor(JHandcrafted(), resize=None), world.j.testbed, world.j.nerf2sfm,
                   JTrackerConfig(**CFG), align_cfg=JAlignConfig(num_iters=n_iters, robust_c=1.0))
    ttr = PixTrackTracker(world.t.scene, FeatureExtractor(HandcraftedExtractor(device="cpu"), resize=None),
                          world.t.testbed, world.t.nerf2sfm, TrackerConfig(**CFG),
                          align_cfg=AlignConfig(num_iters=n_iters, robust_c=1.0))
    keep_samples(world)
    jtr.camera, ttr.camera = world.j.camera, world.t.camera
    return jtr, ttr


def test_traces_recorded(world):
    jtr, ttr = _trackers(world, 25)
    jdbg, tdbg = JDebugTracker(debug=1), DebugTracker(debug=1)
    jtr.refiner.attach_tracker(jdbg)
    ttr.refiner.attach_tracker(tdbg)
    for q in world.frames:
        for dbg, tr in ((jdbg, jtr), (tdbg, ttr)):
            dbg.start_frame(q[0])
            tr.run_single_frame(q)
    assert len(tdbg.frames) == 3
    for fj, ft in zip(jdbg.frames, tdbg.frames):
        assert ft["frame"] == fj["frame"] and "T_refined" in ft and not ft["dense"]
        assert [lv["level"] for lv in ft["levels"]] == [lv["level"] for lv in fj["levels"]] == [2, 1, 0]
        for lj, lt in zip(fj["levels"], ft["levels"]):
            assert 1 <= lt["num_iters"] <= 25 and 1 <= lj["num_iters"] <= 25
            assert all(isinstance(lt[k], np.ndarray) and len(lt[k]) == lt["num_iters"]
                       for k in ("costs", "dt", "dR", "accepted"))
            assert np.isfinite(lt["costs"]).all()
            n = min(3, lt["num_iters"], lj["num_iters"])
            np.testing.assert_allclose(lt["costs"][:n], lj["costs"][:n], rtol=5e-3, atol=1e-6)
            acc = lt["costs"][lt["accepted"]]
            assert (np.diff(acc) <= 1e-7).all()  # monotone over the accepted steps
        np.testing.assert_allclose(ft["cost"], fj["cost"], rtol=0.1, atol=5e-6)
        dR, dt = pose_error(Pose.from_4x4(ft["T_refined"]), Pose.from_4x4(np.asarray(fj["T_refined"])))
        assert dR < 0.5 and dt < 5e-3, (ft["frame"], dR, dt)

    # with no tracker attached the hot path is the plain one, and lands where the traced one did
    _, plain = _trackers(world, 25)
    for q in world.frames:
        plain.run_single_frame(q)
    for name, _ in world.frames:
        a, b = ttr.pose_history[name], plain.pose_history[name]
        dR, dt = pose_error(Pose.from_4x4(a["T_refined"]), Pose.from_4x4(b["T_refined"]))
        assert dR < 0.5 and dt < 5e-3, (name, dR, dt)
        np.testing.assert_allclose(a["cost"], b["cost"], rtol=0.1, atol=5e-6)


def test_debug2_records_dense_maps(world):
    _, ttr = _trackers(world, 10)
    dbg = DebugTracker(debug=2)
    ttr.refiner.attach_tracker(dbg)
    dbg.start_frame(world.frames[0][0])
    ttr.run_single_frame(world.frames[0])
    dense = dbg.frames[0]["dense"]
    assert [d["level"] for d in dense] == [2, 1, 0]
    assert all(isinstance(d["fmap"], np.ndarray) and d["fmap"].ndim == 3 and d["conf"].ndim == 2 for d in dense)
    assert dbg.frames[0]["p3d"].shape[1] == 3
    # debug 0 and a tracker without a started frame record nothing
    quiet = DebugTracker(debug=2)
    quiet.log_dense(0, torch.zeros(2, 2, 1))
    quiet.log_optim_iter(0, {"active": torch.ones(1, dtype=torch.bool)})
    assert quiet.frames == []


def _static_trackers(world, **kw):
    jtr = JStaticRefTracker(world.j.scene, JExtractor(JHandcrafted(), resize=None), world.j.testbed,
                            world.j.nerf2sfm, JStaticRefConfig(**STATIC_CFG, **kw),
                            align_cfg=JAlignConfig(num_iters=25, robust_c=1.0))
    ttr = StaticRefTracker(world.t.scene, FeatureExtractor(HandcraftedExtractor(device="cpu"), resize=None),
                           world.t.testbed, world.t.nerf2sfm, StaticRefConfig(**STATIC_CFG, **kw),
                           align_cfg=AlignConfig(num_iters=25, robust_c=1.0))
    keep_samples(world)
    return jtr, ttr


def test_feature_store_roundtrip_across_packages(world, tmp_path):
    """Each package writes the first four references' features; each reads
    the other's file: layout, ids, poses and arrays come back as written,
    and a tracker of either package consumes either file."""
    pytest.importorskip("h5py")
    from pixtrack_tpu.tracking.render_bridge import render_nerf_view as jrender
    from pixtrack_tpu_torch.tracking.render_bridge import render_nerf_view as trender

    jtr, ttr = _static_trackers(world)
    ids = [int(i) for i in world.j.scene.image_ids[:4]]
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    jio.precompute_reference_features(
        jtr.refiner, world.j.scene,
        lambda rid, pose: (jrender(world.j.testbed, world.j.nerf2sfm, pose, world.j.camera, spp=1), world.j.camera,
                           None), jpath, image_ids=ids)
    tio.precompute_reference_features(
        ttr.refiner, world.t.scene,
        lambda rid, pose: (trender(world.t.testbed, world.t.nerf2sfm, pose, world.t.camera, spp=1), world.t.camera,
                           None), tpath, image_ids=ids)

    for path in (jpath, tpath):  # JAX wrote / the port wrote
        from_j, from_t = jio.load_reference_features(path), tio.load_reference_features(path, device="cpu")
        assert sorted(from_j) == sorted(from_t) == ids
        for rid in ids:
            a, b = from_j[rid], from_t[rid]
            assert b.ref_ids == a.ref_ids == [rid] and len(b.feats) == len(a.feats) == 3
            assert b.p3d.dtype == torch.float32 and b.mask.dtype == torch.bool and b.feats[0].device.type == "cpu"
            for x, y in [(a.p3d, b.p3d), (a.mask, b.mask), (a.pose.R, b.pose.R), (a.pose.t, b.pose.t),
                         *zip(a.feats, b.feats), *zip(a.weights, b.weights), *zip(a.valids, b.valids)]:
                np.testing.assert_array_equal(np.asarray(x), y.numpy())
    # what the two packages computed and stored agrees: 95 % of the entries within 1e-3, all within 0.05
    from_j, from_t = tio.load_reference_features(jpath, device="cpu"), tio.load_reference_features(tpath, device="cpu")
    for rid in ids:
        for x, y in zip(from_j[rid].feats + from_j[rid].weights, from_t[rid].feats + from_t[rid].weights):
            # the two renders differ by a level in a few pixels, and the blurs spread that
            assert ((x - y).abs() <= 1e-3).float().mean() >= 0.95 and float((x - y).abs().max()) < 0.05
    assert sorted(tio.load_reference_features(jpath, ref_ids=[ids[1], 999], device="cpu")) == [ids[1]]

    # each tracker consumes the other package's file instead of extracting
    j2, t2 = _static_trackers(world, features_h5=tpath)[0], _static_trackers(world, features_h5=jpath)[1]
    assert len(j2._static_refs) == len(t2._static_refs) == 4
    j2.camera, t2.camera = world.j.camera, world.t.camera
    j2.run(world.frames[:2])
    t2.run(world.frames[:2])
    name = world.frames[1][0]
    dR, _ = pose_error(Pose.from_4x4(t2.pose_history[name]["T_refined"]), world.t.gt[1])
    assert dR < 10.0
    dR, dt = pose_error(Pose.from_4x4(t2.pose_history[name]["T_refined"]),
                        Pose.from_4x4(np.asarray(j2.pose_history[name]["T_refined"])))
    assert dR < 0.05 and dt < 1e-3
