"""Parity of the PyTorch tracking port with the JAX package on the CPU:
mask morphology and the point-splat mask (exact), and one whole fused
steady-state frame on the mesh-world assets at a small size.

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
    from pixtrack_tpu_torch._shared import nerf_transform
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
    ttb = testbed(Testbed())
    ttb.set_baked_field(load_distilled(MW / "field.npz"))
    ttr = PixTrackTracker(scene, FeatureExtractor(load_unet_weights(REPO / "assets/unet_basin.npz",
                                                                    dtype=torch.float32)),
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
