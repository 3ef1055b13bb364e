"""Parity of the PyTorch tracking port with the JAX package on the CPU:
mask morphology, the depth mask and the point-splat mask (exact), one whole
fused steady-state frame, and the stepwise reference-exact video loop
(importance-sampled renders, NeRF-depth mask), on the mesh-world assets at
a small size.

The frame test: a 160x120 query rendered from the mesh at the upright
mapping view, an init perturbed from that pose, 16 samples per ray, a
20-iteration LM budget, the UNet in f32 on both sides and no cost gate
(thresh = inf). Tolerances: final rotation within 0.05 deg, translation
within 1e-3, cost within 2e-3 relative, the same success flag. On the CPU
XLA's and PyTorch's sin/cos differ in the last bit on ~5% of the encoding's
values, and their f32 dot products sum in other orders; with the trained
field either can round an activation to the neighbouring bf16 value, so a
few reference pixels differ (up to 9e-3, mean 2e-6). Near the optimum the
LM's accept and stall decisions then stop the levels a few iterations
apart (53 vs 45 in all): the cost gap measured 1.1e-3.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixtrack_tpu.tracking import mask as jmask
from pixtrack_tpu_torch.tracking import mask as tmask

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
MW = REPO / "assets" / "mesh_world"


@pytest.mark.parametrize("size,iters", [(5, 1), (7, 2)])
def test_erode_dilate_exact(size, iters):
    m = (np.random.default_rng(size).uniform(size=(30, 41)) > 0.6).astype(np.float32)
    for jf, tf in ((jmask.erode, tmask.erode), (jmask.dilate, tmask.dilate)):
        np.testing.assert_array_equal(np.asarray(jf(jnp.asarray(m), size, iters)),
                                      tf(torch.as_tensor(m), size, iters).numpy())


def test_depth_to_object_mask_exact():
    """A depth image with an object, holes and an object at the border."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:37, :52]
    obj = ((yy - 18) ** 2 + (xx - 30) ** 2 < 120) | (xx < 4)
    obj &= rng.uniform(size=obj.shape) > 0.05
    depth = np.where(obj, rng.uniform(1.0, 2.0, obj.shape), 0.0).astype(np.float32)
    for kw in ({}, {"size": 3, "erode_iters": 2, "dilate_iters": 1}):
        mj = np.asarray(jmask.depth_to_object_mask(jnp.asarray(depth), **kw))
        mt = tmask.depth_to_object_mask(torch.as_tensor(depth), **kw)
        assert mt.dtype == torch.float32 and 0 < float(mt.sum()) < mt.numel()
        np.testing.assert_array_equal(mj, mt.numpy())


def test_splat_object_mask_exact():
    from pixtrack_tpu.geometry import Camera as JCamera
    from pixtrack_tpu.geometry import Pose as JPose
    from pixtrack_tpu_torch.geometry import Camera, Pose

    rng = np.random.default_rng(0)
    p3d = rng.uniform(-0.1, 0.1, size=(300, 3)).astype(np.float32)
    q, t = [0.99, 0.05, 0.1, 0.0], [0.1, -0.05, 1.5]
    cam = (100.0, 100.0, 79.5, 59.5, 160, 120)
    mj = jmask.splat_object_mask(JPose.from_quat_t(np.float32(q), np.float32(t)), JCamera.pinhole(*cam),
                                 jnp.asarray(p3d), (120, 160), dilate_iters=1)
    mt = tmask.splat_object_mask(Pose.from_quat_t(q, t), Camera.pinhole(*cam), torch.as_tensor(p3d),
                                 (120, 160), dilate_iters=1)
    assert 0 < float(mt.sum()) < mt.numel()
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())


def _upright_name(scene, mesh, look_at_w2c):
    """bench.py's upright pick: the mapping view nearest 0.35 rad elevation
    whose stored orientation is the rig's own look-at (no roll)."""
    center = mesh["vertices"].mean(axis=0)
    best = None
    for i in scene.image_ids:
        T_i = scene.pose_w2c(int(i))
        c = T_i.inv().t.numpy()
        v = c - center
        el = float(np.arcsin(v[1] / np.linalg.norm(v)))
        roll = float(np.rad2deg(float(T_i.geodesic_to(look_at_w2c(c, target=center)))))
        if roll <= 5.0 and (best is None or abs(el - 0.35) < best[0]):
            best = (abs(el - 0.35), int(i))
    return scene.images[best[1]].name


def test_fused_frame_matches_jax():
    from pixtrack_tpu.align.lm import AlignConfig as JAlignConfig
    from pixtrack_tpu.features.extractor import FeatureExtractor as JExtractor
    from pixtrack_tpu.features.train import load_unet_weights as jload_unet
    from pixtrack_tpu.features.unet import UNetExtractor as JUNet
    from pixtrack_tpu.geometry import Camera as JCamera
    from pixtrack_tpu.nerf.distill import load_distilled as jload_distilled
    from pixtrack_tpu.nerf.testbed import Testbed as JTestbed
    from pixtrack_tpu.sfm.scene import SceneModel as JScene
    from pixtrack_tpu.tracking.fused import FusedSteadyStep as JStep
    from pixtrack_tpu.tracking.tracker import PixTrackTracker as JTracker
    from pixtrack_tpu.tracking.tracker import TrackerConfig as JTrackerConfig
    from pixtrack_tpu_torch.geometry import nerf_transform
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.features.extractor import FeatureExtractor
    from pixtrack_tpu_torch.features.unet import load_unet_weights
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
    from pixtrack_tpu_torch.nerf.distill import load_distilled
    from pixtrack_tpu_torch.nerf.testbed import Testbed
    from pixtrack_tpu_torch.sfm.scene import SceneModel
    from pixtrack_tpu_torch.tracking.fused import FusedSteadyStep
    from pixtrack_tpu_torch.tracking.tracker import PixTrackTracker, TrackerConfig
    from smoke_worlds import look_at_w2c

    meta = json.loads((MW / "meta.json").read_text())
    n2s = nerf_transform.NerfTransform.load(MW / "nerf2sfm.pkl")
    scene = SceneModel.load(MW / "aug_sfm")
    mesh = load_obj(MW / "src" / "house.obj")
    covis = scene.covisibility_dict()
    upright = _upright_name(scene, mesh, look_at_w2c)
    cam = (150.0, 150.0, 79.5, 59.5, 160, 120)
    T_up = scene.pose_w2c(scene.name2id[upright])
    query = render_mesh(mesh, T_up, Camera.pinhole(*cam), background=(0.0, 0.0, 0.0))
    q = query.astype(np.float32) / 255.0
    delta = np.array([0.02, -0.015, 0.01, 0.01, -0.008, 0.005], np.float32)
    T0 = T_up.retract(torch.as_tensor(delta))
    R0, t0 = T0.R.numpy(), T0.t.numpy()
    tcfg = dict(reference_scale=0.5, covis_threshold=10, upright_ref_img=upright)

    def testbed(tb):
        tb.render_aabb.min = [float(v) for v in meta["aabb"][0]]
        tb.render_aabb.max = [float(v) for v in meta["aabb"][1]]
        return tb

    jtb = testbed(JTestbed())
    jtb.set_baked_field(jload_distilled(MW / "field.npz"))
    jtr = JTracker(JScene.load(MW / "aug_sfm"),
                   JExtractor(JUNet(dtype=jnp.float32), params=jload_unet(REPO / "assets/unet_basin.npz")[1]),
                   jtb, n2s, JTrackerConfig(**tcfg), align_cfg=JAlignConfig(num_iters=20), covis=covis)
    ttb = testbed(Testbed(device="cpu"))
    ttb.set_baked_field(load_distilled(MW / "field.npz", device="cpu"))
    ttr = PixTrackTracker(scene, FeatureExtractor(load_unet_weights(REPO / "assets/unet_basin.npz",
                                                                    device="cpu", dtype=torch.float32)),
                          ttb, n2s, TrackerConfig(**tcfg), align_cfg=AlignConfig(num_iters=20), covis=covis)
    for tb in (jtb, ttb):
        tb.n_coarse = 16  # after the tracker's fast_render default of 96
    jstep = JStep(jtr, JCamera.pinhole(*cam))
    jout = jstep(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(True), jnp.float32(np.inf), jnp.asarray(q))
    tstep = FusedSteadyStep(ttr, Camera.pinhole(*cam))
    # the cloud spans most of the mesh world's reference view: no crop
    assert tstep._crop == jstep._crop
    tout = tstep(torch.as_tensor(R0), torch.as_tensor(t0), torch.tensor(True),
                 torch.tensor(np.inf, dtype=torch.float32), torch.as_tensor(q))

    chord = np.linalg.norm(np.asarray(jout.R, np.float64) - tout.R.double().numpy())
    assert np.rad2deg(2 * np.arcsin(chord / (2 * np.sqrt(2)))) < 0.05
    np.testing.assert_allclose(np.asarray(jout.t), tout.t.numpy(), atol=1e-3)
    np.testing.assert_allclose(float(jout.cost), float(tout.cost), rtol=2e-3)
    assert bool(jout.ok) == bool(tout.ok)
    # the frame moved the pose back towards the view it was rendered from
    err0 = np.linalg.norm(t0 - T_up.t.numpy())
    assert np.linalg.norm(tout.t.numpy() - T_up.t.numpy()) < err0


@pytest.mark.parametrize("num_refs,n_frames", [(1, 3), (2, 2)])
def test_stepwise_tracker_matches_jax(num_refs, n_frames, tmp_path):
    """The stepwise video loop (PoseTracker.run: refine, relocalize and
    retry on failure) in the reference-exact configuration: every render
    takes 16 coarse and 8 importance samples per ray (the staged render, K2's
    plain version here), every steady frame masks the query with a NeRF
    depth render. 160x120 queries along an orbit from the upright view, UNet
    f32, a 20-iteration LM, best-of-K over ``num_refs`` references. Poses
    within 0.05 deg and 1e-3 and the same successes, relocalizations and
    best references; costs within 5e-3 relative, not the fused frame's
    2e-3: the importance pass moves its samples with the coarse weights,
    so the last-bit differences of the CPU sin/cos and sums (module
    docstring) move the fine samples too. A 224x224 reference render at
    16+8 samples differs from JAX's by up to 2.3e-2 (mean 4e-5), against
    1.3e-2 coarse-only, and the costs of the three frames by 2.2e-3, 3.1e-3
    and 1.9e-3 relative (measured on the CPU); JAX's jitted linspace values
    in place of torch's change neither."""
    import pickle

    from pixtrack_tpu.align.lm import AlignConfig as JAlignConfig
    from pixtrack_tpu.features.extractor import FeatureExtractor as JExtractor
    from pixtrack_tpu.features.train import load_unet_weights as jload_unet
    from pixtrack_tpu.features.unet import UNetExtractor as JUNet
    from pixtrack_tpu.geometry import Camera as JCamera
    from pixtrack_tpu.nerf.distill import load_distilled as jload_distilled
    from pixtrack_tpu.nerf.testbed import Testbed as JTestbed
    from pixtrack_tpu.sfm.scene import SceneModel as JScene
    from pixtrack_tpu.tracking.tracker import PixTrackTracker as JTracker
    from pixtrack_tpu.tracking.tracker import TrackerConfig as JTrackerConfig
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.features.extractor import FeatureExtractor
    from pixtrack_tpu_torch.features.unet import load_unet_weights
    from pixtrack_tpu_torch.geometry import Camera, nerf_transform
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
    from pixtrack_tpu_torch.nerf.distill import load_distilled
    from pixtrack_tpu_torch.nerf.testbed import Testbed
    from pixtrack_tpu_torch.sfm.scene import SceneModel
    from pixtrack_tpu_torch.tracking.tracker import PixTrackTracker, TrackerConfig
    from smoke_worlds import look_at_w2c

    meta = json.loads((MW / "meta.json").read_text())
    n2s = nerf_transform.NerfTransform.load(MW / "nerf2sfm.pkl")
    scene = SceneModel.load(MW / "aug_sfm")
    mesh = load_obj(MW / "src" / "house.obj")
    covis = scene.covisibility_dict()
    upright = _upright_name(scene, mesh, look_at_w2c)
    cam = (150.0, 150.0, 79.5, 59.5, 160, 120)
    center = mesh["vertices"].mean(axis=0)
    v0 = scene.pose_w2c(scene.name2id[upright]).inv().t.numpy().astype(np.float64) - center
    dist = float(np.linalg.norm(v0))
    ang0, el0 = float(np.arctan2(v0[0], v0[2])), float(np.arcsin(v0[1] / dist))
    frames = []
    for i in range(n_frames):
        ang, el = ang0 + 0.02 * i, el0 + 0.05 * np.sin(0.4 * i)
        eye = center + dist * np.array([np.cos(el) * np.sin(ang), np.sin(el), np.cos(el) * np.cos(ang)])
        img = render_mesh(mesh, look_at_w2c(eye, target=center), Camera.pinhole(*cam), background=(0.0, 0.0, 0.0))
        frames.append((f"frame_{i:04d}.png", img))
    tcfg = dict(reference_scale=0.5, covis_threshold=10, upright_ref_img=upright, num_refs=num_refs,
                cost_threshold_min=0.05, fast_render=False, mask_mode="nerf_depth")

    def testbed(tb):
        tb.render_aabb.min = [float(v) for v in meta["aabb"][0]]
        tb.render_aabb.max = [float(v) for v in meta["aabb"][1]]
        tb.n_coarse, tb.n_fine = 16, 8
        return tb

    jtb = testbed(JTestbed())
    jtb.set_baked_field(jload_distilled(MW / "field.npz"))
    jtr = JTracker(JScene.load(MW / "aug_sfm"),
                   JExtractor(JUNet(dtype=jnp.float32), params=jload_unet(REPO / "assets/unet_basin.npz")[1]),
                   jtb, n2s, JTrackerConfig(**tcfg), align_cfg=JAlignConfig(num_iters=20),
                   eval_path=str(tmp_path / "jax"), covis=covis)
    ttb = testbed(Testbed(device="cpu"))
    ttb.set_baked_field(load_distilled(MW / "field.npz", device="cpu"))
    ttr = PixTrackTracker(scene, FeatureExtractor(load_unet_weights(REPO / "assets/unet_basin.npz",
                                                                    device="cpu", dtype=torch.float32)),
                          ttb, n2s, TrackerConfig(**tcfg), align_cfg=AlignConfig(num_iters=20),
                          eval_path=str(tmp_path / "port"), covis=covis)
    jtr.camera, ttr.camera = JCamera.pinhole(*cam), Camera.pinhole(*cam)
    for tr in (jtr, ttr):
        tr.run(frames)
        tr.save_poses()
    assert (ttb.n_coarse, ttb.n_fine) == (16, 8)  # fast_render off keeps the importance pass

    assert ttr.stats == jtr.stats
    assert ttr.relocalization_count == jtr.relocalization_count
    assert [r["best_ref"] for r in ttr.trace] == [r["best_ref"] for r in jtr.trace]
    assert [sorted(r["ref_costs"]) for r in ttr.trace] == [sorted(r["ref_costs"]) for r in jtr.trace]
    assert len(ttr.trace[0]["ref_costs"]) == num_refs
    for name, _ in frames:
        jrec, trec = jtr.pose_history[name], ttr.pose_history[name]
        assert trec["success"] == jrec["success"], name
        assert trec["reference_ids"] == jrec["reference_ids"], name
        np.testing.assert_allclose(trec["cost"], jrec["cost"], rtol=5e-3, err_msg=name)
        Tj, Tt = np.asarray(jrec["T_refined"], np.float64), trec["T_refined"].astype(np.float64)
        chord = np.linalg.norm(Tj[:3, :3] - Tt[:3, :3])
        assert np.rad2deg(2 * np.arcsin(chord / (2 * np.sqrt(2)))) < 0.05, name
        np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=1e-3, err_msg=name)
        for k in ("size", "f", "c", "k"):
            np.testing.assert_array_equal(np.asarray(jrec["camera"][k]), trec["camera"][k])
    assert sum(r["success"] for r in ttr.pose_history.values()) >= 1

    for fname in ("poses.pkl", "trackers.pkl"):
        with open(tmp_path / "jax" / fname, "rb") as f:
            jout = pickle.load(f)
        with open(tmp_path / "port" / fname, "rb") as f:
            tout = pickle.load(f)
        assert len(tout) == len(jout) == len(ttr.trace)
        if fname == "poses.pkl":
            assert set(tout) == set(jout)
            assert all(set(tout[k]) == set(jout[k]) for k in jout)
        else:
            assert [set(r) for r in tout] == [set(r) for r in jout]
