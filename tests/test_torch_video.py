"""Parity of the port's batched video tracker (``parallel/video.py``,
``parallel/mesh.py``, CLI ``track-batch``) with the JAX package on the CPU,
on one process and over several.

The JAX side runs as its own tests run it: sharded over the virtual
8-device CPU mesh (tests/conftest.py), the reference renders through its
plain XLA render. The port runs on the CPU, where K1 is its plain version.
Both packages render the shipped distilled blob field
(``assets/bench_field.npz``), the world of tests/test_torch_world.py.

Tolerances:
- the batched LM against B unbatched calls of the port: the same iteration
  count per problem and level, poses within 1e-6 (measured: equal to the
  bit on the CPU; the batched step composes its poses and contracts its
  gradient per problem for that);
- ``batch_align`` against ``sharded_batch_align`` on well-posed smooth
  problems: tests/test_torch_align.py's LM tolerances (1e-3 deg, 1e-5, cost
  1e-3 relative), the same convergence flags, and iteration counts within
  one, where that file asks for the same count on its one problem (measured
  over these 8: one problem stops an iteration later in the port, both
  converged, 3.9e-7 apart in translation and 2e-7 relative in cost);
- the video trackers against JAX's, per video and frame: poses within
  0.25 deg (ROADMAP's for the synthetic world) and 5e-3, costs within 5e-3
  relative (the stepwise tracker's: each step renders its reference anew
  and the two packages' renders part in a few bf16 roundings), total
  iterations over both levels within 10. Measured: 0.18 deg, 1.4e-3, 3.7e-3
  relative, 9 iterations (one frame: 26 in the port, 35 in JAX, at the same
  pose to 0.006 deg; the minimum is flat and the stopping rules part on
  the cost's last bits, so ROADMAP's +-3 on the fine level does not hold);
- ``track-batch`` through the CLI against the same calls through the API:
  equal to the bit.

Over several processes (``track_video_batch(mesh=...)``, ``track-batch
--devices``; gloo ranks spawned by the tests on the CPU, one thread each,
a 60 s collective timeout, a join timeout; the rank functions in
tests/scaleout_ranks.py, which imports no JAX):
- 2 ranks against the one-process batch, B = 4 and B = 3 (padded to 4 by
  repeating the last video): equal to the bit (each problem's LM is
  batch-independent, ``test_batched_align_equals_unbatched_calls``; the
  renders and pyramids are per image; measured equal, also at 1, 2 and 4
  CPU threads); B = 4 against JAX's sharded tracker at the tolerances
  above (equal to the one-process batch, so the gaps measured above);
- ``track-batch --devices 2 --device cpu`` against ``--devices 1``: the
  same ``poses_*.pkl`` to the bit, the summary's mesh {"dp": 2, "tp": 1};
- ``train_nerf_asset(devices=2, tp=2, device="cpu")``: rank 0's snapshot
  loads in the one-process port and equals the field returned.
"""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixtrack_tpu.align.lm import AlignConfig as JAlignConfig
from pixtrack_tpu.align.lm import LevelData as JLevelData
from pixtrack_tpu.features import FeatureExtractor as JExtractor
from pixtrack_tpu.features import HandcraftedExtractor as JHandcrafted
from pixtrack_tpu.geometry import Camera as JCamera
from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu.geometry.nerf_transform import C_CAM, P_W
from pixtrack_tpu.nerf.render import RenderConfig as JRenderConfig
from pixtrack_tpu.parallel.mesh import make_mesh, sharded_batch_align
from pixtrack_tpu.parallel.video import make_production_video_tracker as j_production
from pixtrack_tpu.parallel.video import make_sharded_video_tracker
from pixtrack_tpu.parallel.video import track_video_batch as j_track_video_batch
from pixtrack_tpu.tracking.render_bridge import render_nerf_view as jrender_nerf_view
from pixtrack_tpu_torch.align.lm import AlignConfig, LevelData, align_level, align_pyramid
from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.nerf.render import RenderConfig
from pixtrack_tpu_torch.parallel import batch_align, make_production_video_tracker, make_video_tracker
from pixtrack_tpu_torch.parallel import track_video_batch

import scaleout_ranks
from synthetic_world import look_at_w2c, sphere_surface_points
from test_torch_align import _problem
from test_torch_cli import object_dir, port  # noqa: F401  (the module-scoped object folder)
from test_torch_world import paired_world

torch.set_num_threads(2)
CPU = "cpu"
ROT_DEG, TRANS, COST_REL, ITERS = 0.25, 5e-3, 5e-3, 10


def _rot_deg(Ra, Rb) -> float:
    """The angle between two rotations from the chord ||Ra - Rb||_F = 2 sqrt(2)
    sin(angle / 2): the arccos of the trace is ~0.03 deg of noise at f32."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.rad2deg(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0))))


def _stack_levels(problems, with_conf):
    """B problems of test_torch_align as one batched port level and the same
    in JAX's layout (every leaf batched, as vmap takes it)."""
    cams, levels = [], []
    for cam, fmap, conf, p3d, f_ref, w_ref, mask, _, _ in problems:
        cams.append(cam)
        levels.append(dict(p3d=p3d, f_ref=f_ref, w_ref=w_ref, mask=mask, fmap=fmap, conf=conf))
    leaf = {k: np.stack([lv[k] for lv in levels]) for k in ("p3d", "f_ref", "w_ref", "mask", "fmap")}
    conf = np.stack([lv["conf"] for lv in levels]) if with_conf else None
    B = len(problems)
    t_level = LevelData(p3d=torch.as_tensor(leaf["p3d"]), f_ref=torch.as_tensor(leaf["f_ref"]),
                        w_ref=torch.as_tensor(leaf["w_ref"]), mask=torch.as_tensor(leaf["mask"]),
                        fmap=torch.as_tensor(leaf["fmap"]), conf=None if conf is None else torch.as_tensor(conf),
                        scale=torch.ones(B, 2))
    j_level = JLevelData(p3d=jnp.asarray(leaf["p3d"]), f_ref=jnp.asarray(leaf["f_ref"]),
                         w_ref=jnp.asarray(leaf["w_ref"]), mask=jnp.asarray(leaf["mask"]),
                         fmap=jnp.asarray(leaf["fmap"]), conf=None if conf is None else jnp.asarray(conf),
                         scale=jnp.ones((B, 2)))
    size, f, c = (np.asarray([[cm[i], cm[i + 1]] for cm in cams], np.float32) for i in (4, 0, 2))
    t_cam = Camera(size=torch.as_tensor(size), f=torch.as_tensor(f), c=torch.as_tensor(c), k=torch.zeros(B, 2))
    j_cam = JCamera(size=jnp.asarray(size), f=jnp.asarray(f), c=jnp.asarray(c), k=jnp.zeros((B, 2)))
    return t_level, j_level, t_cam, j_cam


def _inits(B, seed=7):
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.03, 0.03, (B, 3)).astype(np.float32)
    t = rng.uniform(-0.02, 0.02, (B, 3)).astype(np.float32)
    return w, t


@pytest.mark.parametrize("with_conf", [False, True])
def test_batched_align_equals_unbatched_calls(with_conf):
    """align_level and align_pyramid over B = 4 problems (with their own
    cameras) against one call per problem."""
    B = 4
    problems = [_problem(s, with_conf=with_conf) for s in range(B)]
    level, _, cam_b, _ = _stack_levels(problems, with_conf)
    w, t = _inits(B)
    T_b = Pose.from_aa_t(torch.as_tensor(w), torch.as_tensor(t))
    cfg = AlignConfig(num_iters=40)
    st_b = align_level(T_b, level, cam_b, cfg)
    coarse = LevelData(p3d=level.p3d, f_ref=level.f_ref, w_ref=level.w_ref, mask=level.mask,
                       fmap=level.fmap[:, ::2, ::2].contiguous(), conf=None if level.conf is None
                       else level.conf[:, ::2, ::2].contiguous(), scale=torch.full((B, 2), 0.5))
    pyr_b, states_b = align_pyramid(T_b, (level, coarse), cam_b, cfg)
    for k in range(B):
        one = lambda lv: LevelData(  # noqa: E731
            p3d=lv.p3d[k], f_ref=lv.f_ref[k], w_ref=lv.w_ref[k], mask=lv.mask[k], fmap=lv.fmap[k],
            conf=None if lv.conf is None else lv.conf[k], scale=lv.scale[k])
        cam = Camera(size=cam_b.size[k], f=cam_b.f[k], c=cam_b.c[k], k=cam_b.k[k])
        T = Pose(T_b.R[k], T_b.t[k])
        st = align_level(T, one(level), cam, cfg)
        assert int(st.num_iters) == int(st_b.num_iters[k]) > 1
        np.testing.assert_allclose(st_b.T.R[k].numpy(), st.T.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(st_b.T.t[k].numpy(), st.T.t.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(st_b.cost[k]), float(st.cost), rtol=1e-6)
        pyr, states = align_pyramid(T, (one(level), one(coarse)), cam, cfg)
        assert [int(s.num_iters) for s in states] == [int(s.num_iters[k]) for s in states_b]
        np.testing.assert_allclose(pyr_b.T.R[k].numpy(), pyr.T.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(pyr_b.T.t[k].numpy(), pyr.T.t.numpy(), atol=1e-6)


def test_batch_align_matches_sharded_batch_align():
    """parallel/mesh.py: batch_align against sharded_batch_align at B = 8
    (8 iterations), batched levels and cameras."""
    B = 8
    problems = [_problem(s, with_conf=True) for s in range(B)]
    t_level, j_level, t_cam, j_cam = _stack_levels(problems, True)
    w, t = _inits(B, seed=3)
    jst = sharded_batch_align(make_mesh(n_devices=8, tp=1))(
        JPose.from_aa_t(jnp.asarray(w), jnp.asarray(t)), j_level, j_cam)
    tst = batch_align(Pose.from_aa_t(torch.as_tensor(w), torch.as_tensor(t)), t_level, t_cam)
    np.testing.assert_array_equal(np.asarray(jst.converged), tst.converged.numpy())
    assert np.abs(np.asarray(jst.num_iters) - tst.num_iters.numpy()).max() <= 1
    for k in range(B):
        assert _rot_deg(np.asarray(jst.T.R[k]), tst.T.R[k].numpy()) < 1e-3
    np.testing.assert_allclose(np.asarray(jst.T.t), tst.T.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jst.cost), tst.cost.numpy(), rtol=1e-3)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The paired synthetic world at 96 px, 48 samples a ray, and B = 4
    videos of T = 3 frames (tests/test_parallel_production.py's orbits),
    rendered once by the JAX testbed; each video starts from its first
    frame's pose retracted by a numpy draw."""
    d = tmp_path_factory.mktemp("video")
    w = paired_world(d, res=96, n_frames=1, n_coarse=48)
    w.dir = d
    B, T_len = 4, 3
    gts, vids = [], []
    for b in range(B):
        traj = [look_at_w2c(1.6 * np.array([np.sin(a), 0.15, np.cos(a)])) for a in 0.3 + 0.8 * b + 0.02 * np.arange(T_len)]
        gts.append(traj)
        vids.append(np.stack([jrender_nerf_view(w.j.testbed, w.j.nerf2sfm, T, w.j.camera, spp=1) for T in traj]))
    w.videos = np.stack(vids).astype(np.float32) / 255.0
    rng = np.random.default_rng(0)
    R0, t0 = [], []
    for b in range(B):
        T0 = gts[b][0].retract(jnp.asarray(rng.uniform(-1, 1, 6) * np.array([0.01] * 3 + [0.015] * 3), jnp.float32))
        R0.append(np.asarray(T0.R))
        t0.append(np.asarray(T0.t))
    w.R0, w.t0, w.gts = np.stack(R0), np.stack(t0), gts
    w.mesh = make_mesh(n_devices=8, tp=1)
    return w


def _assert_close(j, t):
    """Per frame and video: poses, costs and total iterations (see the module docstring)."""
    j = {k: np.asarray(v) for k, v in j.items()}
    for idx in np.ndindex(*j["cost"].shape):
        assert _rot_deg(j["R"][idx], t["R"][idx]) < ROT_DEG, idx
        assert np.abs(t["t"][idx] - j["t"][idx]).max() < TRANS, idx
        assert abs(t["cost"][idx] - j["cost"][idx]) < COST_REL * abs(j["cost"][idx]), idx
        assert abs(int(t["num_iters"][idx]) - int(j["num_iters"][idx])) <= ITERS, idx


def test_video_tracker_matches_jax(world):
    """make_video_tracker, one batched step over the videos' first frames:
    the SfM-space blob points, the identity NeRF transform, a half-size
    reference camera, the handcrafted pyramid at strides (1, 4)."""
    res = 96
    p3d = sphere_surface_points(n=400, seed=0)
    ref_args = (res * 0.55, res * 0.55, (res // 2 - 1) / 2, (res // 2 - 1) / 2, res // 2, res // 2)
    PWj, CCj = jnp.asarray(P_W, jnp.float32), jnp.asarray(C_CAM, jnp.float32)
    PWt, CCt = torch.as_tensor(P_W, dtype=torch.float32), torch.as_tensor(C_CAM, dtype=torch.float32)

    def j_c2w(T):
        Tinv = T.inv()
        return PWj @ Tinv.R @ CCj, PWj @ Tinv.t

    def t_c2w(T):
        Tinv = T.inv()
        top = torch.cat([PWt @ Tinv.R @ CCt, (PWt @ Tinv.t)[:, None]], dim=1)
        return torch.cat([top, torch.tensor([[0.0, 0.0, 0.0, 1.0]])], dim=0)

    aabb = [[0.3] * 3, [0.7] * 3]
    jrun = make_sharded_video_tracker(
        world.mesh, world.j.testbed._baked, JHandcrafted(strides=(1, 4)), jnp.asarray(p3d), world.j.camera,
        JCamera.pinhole(*ref_args), aabb, j_c2w, align_cfg=JAlignConfig(num_iters=30),
        rcfg=JRenderConfig(n_coarse=48, n_fine=0, perturb=False))
    trun = make_video_tracker(
        world.t.testbed._baked, HandcraftedExtractor(strides=(1, 4), device=CPU), p3d, world.t.camera,
        Camera.pinhole(*ref_args), aabb, t_c2w, align_cfg=AlignConfig(num_iters=30),
        rcfg=RenderConfig(n_coarse=48, n_fine=0, perturb=False), device=CPU)
    q = world.videos[:, 0]
    names = ("R", "t", "cost", "num_iters")
    jout = dict(zip(names, jrun(jnp.asarray(world.R0), jnp.asarray(world.t0), jnp.asarray(q))))
    tout = {k: v.numpy() for k, v in zip(names, trun(torch.as_tensor(world.R0), torch.as_tensor(world.t0),
                                                     torch.as_tensor(q)))}
    assert np.isfinite(tout["cost"]).all() and tout["R"].shape == (4, 3, 3)
    _assert_close(jout, tout)


def _production(world, unet: bool):
    if unet:
        from pixtrack_tpu.features import default_extractor as jdefault
        from pixtrack_tpu_torch.features import default_extractor

        return jdefault(resize=1024), default_extractor(resize=1024, device=CPU)
    return (JExtractor(JHandcrafted(strides=(1, 4))),
            FeatureExtractor(HandcraftedExtractor(strides=(1, 4), device=CPU)))


def _production_batch(world, unet: bool):
    """make_production_video_tracker + track_video_batch of both packages
    over the videos (B = 4, T = 3 with the handcrafted pyramid; B = 2, T = 2
    with the shipped UNet in bf16): (JAX's arrays, the port's)."""
    B, T_len = (2, 2) if unet else (4, 3)
    jext, text = _production(world, unet)
    kw = dict(reference_scale=0.5, n_points=400)
    jrun = j_production(world.mesh, world.j.testbed, world.j.nerf2sfm, jext, world.j.scene, world.j.camera,
                        align_cfg=JAlignConfig(num_iters=30),
                        rcfg=JRenderConfig(n_coarse=48, n_fine=0, perturb=False), **kw)
    trun = make_production_video_tracker(world.t.testbed, world.t.nerf2sfm, text, world.t.scene, world.t.camera,
                                         align_cfg=AlignConfig(num_iters=30),
                                         rcfg=RenderConfig(n_coarse=48, n_fine=0, perturb=False), **kw)
    videos = world.videos[:B, :T_len]
    return (j_track_video_batch(jrun, world.R0[:B], world.t0[:B], videos),
            track_video_batch(trun, world.R0[:B], world.t0[:B], videos))


@pytest.fixture(scope="module")
def handcrafted_b4(world):
    """The handcrafted batch of both packages (B = 4, T = 3), shared by the
    parity test and the two-rank test; and the same tracker's batches of B
    = 4 and B = 3 over 2 gloo ranks (tests/scaleout_ranks.py), started
    first so that they run beside JAX's: call the third item for their
    arrays."""
    res = 96
    cam_args = (res * 1.1, res * 1.1, (res - 1) / 2, (res - 1) / 2, res, res)
    ranks = scaleout_ranks.in_background(scaleout_ranks.video_batches, 2, 2, str(world.dir), cam_args,
                                         [world.videos, world.videos[:3]], world.R0, world.t0, 48)
    return (*_production_batch(world, unet=False), ranks)


@pytest.mark.parametrize("unet", [False, True], ids=["handcrafted_b4", "unet_b2"])
def test_production_video_batch_matches_jax(world, unet, request):
    """make_production_video_tracker + track_video_batch over the videos
    (B = 4, T = 3 with the handcrafted pyramid; B = 2, T = 2 with the
    shipped UNet in bf16): every frame of every video against JAX's."""
    B, T_len = (2, 2) if unet else (4, 3)
    jout, tout = _production_batch(world, unet) if unet else request.getfixturevalue("handcrafted_b4")[:2]
    assert tout["R"].shape == (T_len, B, 3, 3) and np.isfinite(tout["cost"]).all()
    _assert_close(jout, tout)
    # what the JAX test holds its own chain to: each video's last frame within 3 deg
    for b in range(B):
        assert _rot_deg(tout["R"][-1, b], np.asarray(world.gts[b][T_len - 1].R)) < 3.0


def test_video_batch_over_two_ranks(handcrafted_b4):
    """track_video_batch over 2 gloo ranks spawned on the CPU (parallel/
    mesh.py's launch, one thread each), each building the handcrafted
    production tracker over this world: B = 4 and B = 3 (padded to 4 by
    repeating the last video) against the one-process batch of the same
    videos, and B = 4 against JAX's sharded tracker."""
    jout, tout, ranks = handcrafted_b4
    four, three = ranks()
    for out, B in ((four, 4), (three, 3)):
        assert set(out) == set(tout) and out["R"].shape == (3, B, 3, 3)
        for k, v in tout.items():
            np.testing.assert_array_equal(out[k], v[:, :B], err_msg=f"B = {B} {k}")
    _assert_close(jout, four)


def test_track_batch_through_the_cli_matches_the_api(object_dir, tmp_path, capsys):  # noqa: F811
    """``track-batch`` over two copies of the object's first three mapping
    renders (the second cut to two frames, padded by its last): the files
    and the printed keys of the JAX package's subcommand, the poses equal to
    the same calls through the API."""
    import shutil

    from pixtrack_tpu_torch.pipelines import cli as tcli
    from pixtrack_tpu_torch.pipelines.assets import layout
    from pixtrack_tpu_torch.tracking.refiner import infer_camera_from_image
    from pixtrack_tpu_torch.utils.config import ObjectConfig, RunConfig
    from pixtrack_tpu_torch.utils.io import ImageIterator

    paths = layout(object_dir)
    names = sorted(p.name for p in paths["mapping"].iterdir())[:3]
    for v, n in (("v0", 3), ("v1", 2)):
        (tmp_path / v).mkdir()
        for name in names[:n]:
            shutil.copy(paths["mapping"] / name, tmp_path / v / name)
    port(["track-batch", "--object_path", str(object_dir), "--query", str(tmp_path / "v0"), str(tmp_path / "v1"),
          "--out_dir", str(tmp_path / "out")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_videos"] == 2 and summary["n_frames"] == 3 and summary["mesh"] == {"dp": 1, "tp": 1}

    scene, tf, testbed = tcli._object_assets(object_dir, torch.device(CPU), tighten=False)
    run_cfg = RunConfig()
    videos = [list(ImageIterator(tmp_path / v)) for v in ("v0", "v1")]
    camera = infer_camera_from_image(videos[0][0][1], device=CPU)
    run = make_production_video_tracker(testbed, tf, run_cfg.make_extractor(CPU), scene, camera,
                                        reference_scale=run_cfg.reference_scale, align_cfg=run_cfg.align_config())
    batch = np.stack([np.stack([np.asarray(v[min(k, len(v) - 1)][1], np.float32) / 255.0 for k in range(3)])
                      for v in videos])
    T0 = scene.pose_w2c(scene.name2id[ObjectConfig().upright_ref_img or scene.names[0]])
    out = track_video_batch(run, np.tile(T0.R.numpy(), (2, 1, 1)), np.tile(T0.t.numpy(), (2, 1)), batch)
    assert summary["mean_cost_final"] == float(np.mean(out["cost"][-1]))
    for b, vid in enumerate(videos):
        with open(tmp_path / "out" / f"poses_{b:02d}.pkl", "rb") as f:
            poses = pickle.load(f)
        assert sorted(poses) == sorted(str(n).split("/")[-1] for n, _ in vid)
        for k, (name, _) in enumerate(vid):
            rec = poses[str(name).split("/")[-1]]
            np.testing.assert_array_equal(rec["T_refined"][:3, :3], out["R"][k, b])
            np.testing.assert_array_equal(rec["T_refined"][:3, 3], out["t"][k, b])
            assert rec["cost"] == float(out["cost"][k, b]) and rec["success"] == bool(np.isfinite(out["cost"][k, b]))


def test_track_batch_refuses_a_mesh(object_dir, tmp_path, monkeypatch):  # noqa: F811
    """``--devices 4`` on the card with one card visible stops with a message
    before any process starts."""
    from pixtrack_tpu_torch.pipelines import cli as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="asks for 4 cards; 1 visible"):
        tcli.main(["track-batch", "--object_path", str(object_dir), "--query", str(tmp_path), "--devices", "4"])


def test_track_batch_over_two_processes(object_dir, tmp_path, capfd):  # noqa: F811
    """``track-batch --devices 2 --device cpu`` over three videos (two
    ranks, one padded video) against ``--devices 1``, the two runs side by
    side: the same files."""
    import shutil
    import threading

    from pixtrack_tpu_torch.pipelines.assets import layout

    paths = layout(object_dir)
    names = sorted(p.name for p in paths["mapping"].iterdir())[:2]
    queries = []
    for v, n in (("v0", 2), ("v1", 1), ("v2", 1)):
        (tmp_path / v).mkdir()
        for name in names[:n]:
            shutil.copy(paths["mapping"] / name, tmp_path / v / name)
        queries.append(str(tmp_path / v))

    def run(n):
        port(["track-batch", "--object_path", str(object_dir), "--query", *queries, "--out_dir",
              str(tmp_path / f"out{n}"), "--devices", str(n)])

    two = threading.Thread(target=run, args=(2,))
    two.start()
    run(1)
    two.join()
    summaries = {}
    for line in capfd.readouterr().out.strip().splitlines():
        if line.startswith("{"):
            summary = json.loads(line)
            summaries[summary["mesh"]["dp"]] = summary
    assert sorted(summaries) == [1, 2] and summaries[2]["mesh"] == {"dp": 2, "tp": 1}
    assert {k: v for k, v in summaries[1].items() if k != "mesh"} == {k: v for k, v in summaries[2].items()
                                                                      if k != "mesh"}
    for b in range(3):
        with open(tmp_path / "out1" / f"poses_{b:02d}.pkl", "rb") as f:
            one = pickle.load(f)
        with open(tmp_path / "out2" / f"poses_{b:02d}.pkl", "rb") as f:
            two = pickle.load(f)
        assert sorted(one) == sorted(two) and len(one) == (2 if b == 0 else 1)
        for name, rec in one.items():
            np.testing.assert_array_equal(two[name]["T_refined"], rec["T_refined"])
            assert two[name]["cost"] == rec["cost"] and two[name]["success"] == rec["success"]


def test_snapshot_of_the_mesh_trainer_loads_in_one_process(object_dir, tmp_path):  # noqa: F811
    """train_nerf_asset(devices=2, tp=2, device="cpu") on a copy of the
    object folder (the house at 96 px): rank 0's snapshot (the full-width
    field, 2 steps) loads in the single-device port and equals the field
    returned; --tp that does not divide --devices stops first."""
    import shutil

    from pixtrack_tpu_torch.nerf.snapshot import load_snapshot
    from pixtrack_tpu_torch.pipelines import assets

    root = tmp_path / "house"
    shutil.copytree(object_dir, root)
    with pytest.raises(ValueError, match="divide"):
        assets.train_nerf_asset(root, devices=2, tp=3, device="cpu")
    field, info = assets.train_nerf_asset(root, n_steps=2, batch_rays=64, n_coarse=8, n_fine=4, devices=2, tp=2,
                                          device="cpu")
    assert len(info["history"]) == 0 and info["seconds"] > 0
    loaded, extra = load_snapshot(assets.layout(root)["snapshot"], device="cpu")[:2]
    assert type(loaded.encoding).__name__ == "HashEncoding" and len(extra["aabb"]) == 2
    assert loaded.encoding.tables.shape == (16, 2, 1 << 19)
    for (k, a), (_, b) in zip(loaded.named_parameters(), field.named_parameters()):
        assert torch.equal(a, b), k
    assert float(loaded.encoding.tables.detach().abs().max()) > 0


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the batched tracker and the trainers raise unless
    the caller asks for the CPU."""
    from pixtrack_tpu_torch.mapping import dense_descriptor, train_matcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = Camera.pinhole(50.0, 50.0, 23.5, 23.5, 48, 48)
    for call in (lambda: make_video_tracker(None, None, np.zeros((4, 3), np.float32), cam, cam, [[0.0] * 3, [1.0] * 3],
                                            None),
                 lambda: dense_descriptor.train_descriptor({}, dense_descriptor.DescTrainConfig(n_steps=0)),
                 lambda: train_matcher.train_matcher(train_matcher.MatcherTrainConfig(n_steps=0))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
