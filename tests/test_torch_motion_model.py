"""The fused steady-state frame with the constant-velocity motion model
(``TrackerConfig.motion_model=True``), chained over a few frames of the mesh
world's orbit, through the JAX package and through the port on the CPU.

Each frame starts from the previous frame's pose extrapolated by the motion
between the two frames before it (rotation fully, translation damped by
``vel_t_damp``). The chains are held together frame by frame, to the fused
frame test's tolerances (tests/test_torch_tracking.py) widened for chaining:
0.1 deg, 2e-3 in translation, costs 5e-3 relative. Their errors against the
ground truth are the reference's behaviour, recorded in ROADMAP.md.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_tracking import _upright_name

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
MW = REPO / "assets" / "mesh_world"


def _rot_deg(Ra, Rb) -> float:
    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T) - 1) / 2
    return float(np.rad2deg(np.arccos(np.clip(c, -1, 1))))


def motion_chains(n_frames: int, step_rad: float, size=(160, 120), n_coarse: int = 16, num_iters: int = 20):
    """The JAX and the port chain over frames 2..n_frames of an orbit from the
    mesh world's upright view (azimuth ``step_rad`` a frame, elevation
    swaying), both started from the ground truth of frames 0 and 1, UNet
    f32. Yields per frame: (frame, JAX output, port output, ground truth)."""
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
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.features.extractor import FeatureExtractor
    from pixtrack_tpu_torch.features.unet import load_unet_weights
    from pixtrack_tpu_torch.geometry import Camera, nerf_transform
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
    w, h = size
    f = 150.0 * w / 160
    cam = (f, f, (w - 1) / 2, (h - 1) / 2, w, h)
    # the orbit from the upright view: azimuth step_rad a frame, elevation swaying
    center = mesh["vertices"].mean(axis=0)
    v0 = scene.pose_w2c(scene.name2id[upright]).inv().t.numpy().astype(np.float64) - center
    dist = float(np.linalg.norm(v0))
    ang0, el0 = float(np.arctan2(v0[0], v0[2])), float(np.arcsin(v0[1] / dist))
    gt = []
    for i in range(n_frames + 1):
        ang, el = ang0 + step_rad * i, el0 + 0.03 * np.sin(0.5 * i)
        gt.append(look_at_w2c(center + dist * np.array([np.cos(el) * np.sin(ang), np.sin(el),
                                                         np.cos(el) * np.cos(ang)]), target=center))
    queries = [render_mesh(mesh, T, Camera.pinhole(*cam), background=(0.0, 0.0, 0.0)).astype(np.float32) / 255.0
               for T in gt]
    tcfg = dict(reference_scale=0.5, covis_threshold=10, upright_ref_img=upright, motion_model=True)

    def testbed(tb):
        tb.render_aabb.min = [float(v) for v in meta["aabb"][0]]
        tb.render_aabb.max = [float(v) for v in meta["aabb"][1]]
        return tb

    jtb = testbed(JTestbed())
    jtb.set_baked_field(jload_distilled(MW / "field.npz"))
    jtr = JTracker(JScene.load(MW / "aug_sfm"),
                   JExtractor(JUNet(dtype=jnp.float32), params=jload_unet(REPO / "assets/unet_basin.npz")[1]),
                   jtb, n2s, JTrackerConfig(**tcfg), align_cfg=JAlignConfig(num_iters=num_iters), covis=covis)
    ttb = testbed(Testbed(device="cpu"))
    ttb.set_baked_field(load_distilled(MW / "field.npz", device="cpu"))
    ttr = PixTrackTracker(scene, FeatureExtractor(load_unet_weights(REPO / "assets/unet_basin.npz",
                                                                    device="cpu", dtype=torch.float32)),
                          ttb, n2s, TrackerConfig(**tcfg), align_cfg=AlignConfig(num_iters=num_iters), covis=covis)
    for tb in (jtb, ttb):
        tb.n_coarse = n_coarse
    jstep, tstep = JStep(jtr, JCamera.pinhole(*cam)), FusedSteadyStep(ttr, Camera.pinhole(*cam))

    # both chains from the ground truth of frames 0 and 1, so that frame 2 on extrapolates
    R0, t0 = gt[0].R.numpy(), gt[0].t.numpy()
    j_state = [(jnp.asarray(gt[1].R.numpy()), jnp.asarray(gt[1].t.numpy()), jnp.asarray(True)),
               (jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(True))]
    t_state = [(gt[1].R, gt[1].t, torch.tensor(True)), (torch.as_tensor(R0), torch.as_tensor(t0), torch.tensor(True))]
    inf = np.float32(np.inf)
    for k in range(2, n_frames + 1):
        (jR, jt, jok), (jR2, jt2, jok2) = j_state
        jout = jstep(jR, jt, jok, jnp.float32(inf), jnp.asarray(queries[k]), R_prev=jR2, t_prev=jt2, vel_ok=jok2)
        (tR, tt, tok), (tR2, tt2, tok2) = t_state
        tout = tstep(tR, tt, tok, torch.tensor(inf), torch.as_tensor(queries[k]), R_prev=tR2, t_prev=tt2,
                     vel_ok=tok2)
        j_state = [(jout.R, jout.t, jout.ok), j_state[0]]
        t_state = [(tout.R, tout.t, tout.ok), t_state[0]]
        yield k, jout, tout, gt[k]


def test_motion_model_chain_matches_jax():
    """Four chained frames, 0.04 rad a frame: the port stays with JAX."""
    errs = []
    for k, jout, tout, T in motion_chains(5, 0.04):
        gap = _rot_deg(jout.R, tout.R.numpy())
        errs.append((_rot_deg(jout.R, T.R.numpy()), _rot_deg(tout.R.numpy(), T.R.numpy())))
        assert gap < 0.1, (k, gap, errs)
        np.testing.assert_allclose(np.asarray(jout.t), tout.t.numpy(), atol=2e-3)
        np.testing.assert_allclose(float(jout.cost), float(tout.cost), rtol=5e-3)
        assert bool(jout.ok) == bool(tout.ok)
    assert max(e for pair in errs for e in pair) < 3.0, errs  # neither runs away over these frames
