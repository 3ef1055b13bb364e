"""The port's command line (``pipelines/cli.py``) against the JAX package's,
on the CPU: the subcommands added last (``track``, ``visualize``, ``eval``,
``demo``, ``bench``, ``extract-frames``, ``convert-images``) and the
learned components behind ``reconstruct --detector / --matcher``.

Tolerances, and what was measured: ``demo`` at 3 frames against JAX's
``demo``: the same frame count and success rate, rotation errors within
0.05 deg (measured 1.5e-5 deg apart: 1.9177 deg mean in both) and
translation errors within 1e-3 (1.8e-6); ``eval`` prints JAX's JSON
exactly; ``track`` through the CLI and the same ``PixTrackTracker`` called
through the API give equal poses (1e-5; on the CPU they are bit-equal);
``extract-frames`` writes JAX's frames byte for byte. ``reconstruct
--detector dense`` runs the mapper on the fast tier's 6-view 160 px arc and
is held to that test's gates; its features are JAX's ``default_descriptor``
(tests/test_torch_dense_descriptor.py holds the net), and the learned
matcher the CLI builds from a checkpoint gives JAX's matches.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from pixtrack_tpu.pipelines import cli as jcli
from pixtrack_tpu_torch.mapping import attention_matcher as tam
from pixtrack_tpu_torch.mapping import incremental as tinc
from pixtrack_tpu_torch.pipelines import cli as tcli
from pixtrack_tpu_torch.pipelines.assets import layout
from pixtrack_tpu_torch.sfm.scene import SceneModel

from test_torch_asset_pipeline import HOUSE, _small_snapshot

torch.set_num_threads(2)
CPU = "cpu"
SUBCOMMANDS = ("track", "track-batch", "track-ycb", "visualize", "eval", "demo", "bench", "extract-frames",
               "convert-images", "reconstruct", "sfm-from-obj", "train-nerf", "nerf-sfm", "augment", "bundle-adjust")


def port(argv):
    tcli.main(["--device", CPU] + list(argv))


def test_help_lists_every_subcommand(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    choices = out[out.index("{") + 1:out.index("}")].split(",")
    assert sorted(choices) == sorted(SUBCOMMANDS)


def test_bench_stops_with_a_message():
    with pytest.raises(SystemExit, match="no benchmark"):
        port(["bench"])


class TestCLI:
    def test_demo_subcommand(self, tmp_path, capsys):
        jcli.main(["demo", "--frames", "3", "--out_dir", str(tmp_path / "jax")])
        out = capsys.readouterr().out
        ref = json.loads(out[out.index("{"):])
        port(["demo", "--frames", "3", "--out_dir", str(tmp_path / "port")])
        out = capsys.readouterr().out
        stats = json.loads(out[out.index("{"):])
        assert stats["n_frames"] == ref["n_frames"] == 3
        assert stats["success_10cm10deg"] >= 2 / 3 and stats["success_10cm10deg"] == ref["success_10cm10deg"]
        for k in ("mean_r_deg", "median_r_deg"):
            assert abs(stats[k] - ref[k]) < 0.05, (k, stats[k], ref[k])
        for k in ("mean_t", "median_t"):
            assert abs(stats[k] - ref[k]) < 1e-3, (k, stats[k], ref[k])
        assert (tmp_path / "port" / "poses.pkl").exists()

    def test_convert_images_subcommand(self, tmp_path, capsys):
        """Non-HEIC conversion works out of the box; HEIC decoding is gated
        on an optional decoder with a clear error."""
        from PIL import Image

        from pixtrack_tpu_torch.utils.image_convert import _enable_heif_if_possible, convert_images

        src = tmp_path / "src"
        src.mkdir()
        arr = (np.linspace(0, 255, 24 * 32 * 3) % 256).astype(np.uint8)
        Image.fromarray(arr.reshape(24, 32, 3)).save(src / "a.jpg")
        Image.fromarray(arr.reshape(24, 32, 3)).save(src / "b.jpg")
        out = tmp_path / "out"
        port(["convert-images", str(src), str(out)])
        assert "converted 2 images" in capsys.readouterr().out
        png = Image.open(out / "a.png")
        assert png.size == (32, 24)
        jcli.main(["convert-images", str(src), str(tmp_path / "jax")])
        np.testing.assert_array_equal(np.asarray(png), np.asarray(Image.open(tmp_path / "jax" / "a.png")))

        # HEIC: no decoder here -> a loud failure, not a skip
        if _enable_heif_if_possible() is None:
            (src / "c.heic").write_bytes(b"\x00\x00\x00\x18ftypheic")
            with pytest.raises(RuntimeError, match="no HEIF decoder"):
                convert_images(src, out, exts=["heic"])

    def test_eval_subcommand(self, tmp_path, capsys):
        T = np.eye(4)
        rng = np.random.default_rng(0)
        poses = {"a.png": {"T_refined": T, "gt_pose": T}, "b.png": {"T_refined": T, "gt_pose": T}}
        with open(tmp_path / "poses.pkl", "wb") as f:
            pickle.dump(poses, f)
        port(["eval", "--poses", str(tmp_path / "poses.pkl")])
        out = json.loads(capsys.readouterr().out)
        assert out["mean_t"] == 0.0
        assert out["acc_3cm3deg"] == 1.0
        # a trajectory with errors, and one entry without ground truth: JAX's JSON
        for k in range(6):
            T_gt = np.eye(4)
            T_gt[:3, 3] = rng.normal(scale=0.05, size=3)
            poses[f"c{k}.png"] = {"T_refined": np.eye(4), "gt_pose": T_gt}
        poses["d.png"] = {"T_refined": T}
        with open(tmp_path / "poses.pkl", "wb") as f:
            pickle.dump(poses, f)
        port(["eval", "--poses", str(tmp_path / "poses.pkl")])
        got = capsys.readouterr().out
        jcli.main(["eval", "--poses", str(tmp_path / "poses.pkl")])
        assert got == capsys.readouterr().out
        with open(tmp_path / "none.pkl", "wb") as f:
            pickle.dump({"d.png": {"T_refined": T}}, f)
        port(["eval", "--poses", str(tmp_path / "none.pkl")])
        assert json.loads(capsys.readouterr().out) == {"error": "poses.pkl has no gt_pose entries"}


@pytest.fixture(scope="module")
def object_dir(tmp_path_factory):
    """A small object folder built through the port's CLI: the house at 96
    px, its transforms, a small trained snapshot (tests/
    test_torch_asset_pipeline.py), the augmented model; the mapping renders
    serve as queries."""
    root = tmp_path_factory.mktemp("object") / "house"
    paths = layout(root)
    port(["sfm-from-obj", "--object_path", str(root), "--obj", str(HOUSE), "--image_size", "96", "--subdiv", "0"])
    port(["train-nerf", "--object_path", str(root), "--n_steps", "1", "--batch_rays", "256", "--n_coarse", "8",
          "--n_fine", "0", "--save_every", "0"])
    _small_snapshot(paths["snapshot"], paths)
    port(["augment", "--object_path", str(root)])
    return root


def test_track_through_the_cli_matches_the_api(object_dir, tmp_path, capsys):
    from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
    from pixtrack_tpu_torch.mapping.nerf_dataset import estimate_aabb_from_scene
    from pixtrack_tpu_torch.nerf.testbed import initialize_testbed
    from pixtrack_tpu_torch.tracking import PixTrackTracker
    from pixtrack_tpu_torch.utils.config import ObjectConfig, RunConfig
    from pixtrack_tpu_torch.utils.io import ImageIterator

    paths = layout(object_dir)
    query = paths["mapping"]
    port(["track", "--object_path", str(object_dir), "--query", str(query), "--frames", "3",
          "--out_dir", str(tmp_path / "out")])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 3
    with open(tmp_path / "out" / "poses.pkl", "rb") as f:
        cli_poses = pickle.load(f)
    assert (tmp_path / "out" / "trackers.pkl").exists()

    scene = SceneModel.load(paths["aug_sfm"])
    tf = NerfTransform.load(paths["nerf2sfm"])
    testbed = initialize_testbed(paths["snapshot"], aabb=estimate_aabb_from_scene(scene, tf), tighten=True,
                                 device=CPU)
    run_cfg = RunConfig()
    tracker = PixTrackTracker(scene, run_cfg.make_extractor(CPU), testbed, tf, run_cfg.tracker_config(ObjectConfig()),
                              align_cfg=run_cfg.align_config())
    tracker.run(ImageIterator(query, max_frames=3), max_frames=3)
    assert sorted(cli_poses) == sorted(tracker.pose_history)
    for name, rec in tracker.pose_history.items():
        np.testing.assert_allclose(cli_poses[name]["T_refined"], rec["T_refined"], atol=1e-5)
        assert cli_poses[name]["success"] == rec["success"]

    # visualize: one overlay per pose
    port(["visualize", "--object_path", str(object_dir), "--poses", str(tmp_path / "out" / "poses.pkl"),
          "--out_dir", str(tmp_path / "viz")])
    assert "wrote 3 overlays" in capsys.readouterr().out
    assert len(list((tmp_path / "viz").glob("result_*.jpg"))) == 3


def test_track_ycb_through_the_cli(object_dir, tmp_path, capsys, monkeypatch):
    """``track-ycb`` over a YCB-Video layout of two 320 x 240 renders of the
    object at two of its rig's poses: the YCB tracker's summary printed,
    ``poses.pkl`` with the ground truth. The protocol renders references at
    0.3 of the rig's images and cold-starts at 1/4 scale, which leaves the
    96 px rig's feature maps a pixel wide: here the references keep the
    rig's size and the cold start its full scale."""
    from scipy.io import savemat

    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh, write_png
    from pixtrack_tpu_torch.tracking import tracker_ycb

    config = tracker_ycb.ycb_tracker_config
    monkeypatch.setattr(tracker_ycb, "ycb_tracker_config",
                        lambda **kw: config(reference_scale=1.0, cold_multiscale=(1,), **kw))

    scene = SceneModel.load(layout(object_dir)["ref_sfm"])
    mesh = load_obj(HOUSE)
    W, H, f = 320, 240, 300.0
    camera = Camera.pinhole(f, f, (W - 1) / 2, (H - 1) / 2, W, H, device=CPU)
    folder = tmp_path / "ycb" / "data" / "0003"
    folder.mkdir(parents=True)
    for k, iid in enumerate(scene.image_ids[:2]):
        T = scene.pose_w2c(int(iid))
        write_png(folder / f"{k:06d}-color.png", render_mesh(mesh, T, camera))
        pose = np.concatenate([T.R.numpy(), T.t.numpy()[:, None]], axis=1)[..., None]
        K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]])
        savemat(str(folder / f"{k:06d}-meta.mat"), {"poses": pose, "cls_indexes": np.array([[2]]), "intrinsic_matrix": K})
    port(["track-ycb", "--object_path", str(object_dir), "--ycb_root", str(tmp_path / "ycb"), "--query", "0003/:",
          "--out_dir", str(tmp_path / "out")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_frames"] == 2 and "success_10cm10deg" in summary
    with open(tmp_path / "out" / "poses.pkl", "rb") as f:
        poses = pickle.load(f)
    assert sorted(poses) == ["000000-color.png", "000001-color.png"]
    assert all("gt_pose" in rec for rec in poses.values())


def test_extract_frames_subcommand(tmp_path, capsys):
    import cv2

    video = tmp_path / "clip.avi"
    vw = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 24))
    rng = np.random.default_rng(0)
    for _ in range(5):
        vw.write(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    vw.release()
    port(["extract-frames", "--video", str(video), "--out_dir", str(tmp_path / "port"), "--every", "2"])
    assert "extracted 3 frames" in capsys.readouterr().out
    jcli.main(["extract-frames", "--video", str(video), "--out_dir", str(tmp_path / "jax"), "--every", "2"])
    names = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.png")) and len(names) == 3
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


@pytest.fixture(scope="module")
def arc_images(tmp_path_factory):
    """The fast tier's rig (tests/test_e2e_pipeline.py::test_cli_pipeline_smoke_fast):
    6 views of the textured cube, 22 degrees apart, 160 px, as PNGs."""
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh, write_png
    from smoke_worlds import look_at_w2c, make_cube_obj

    d = tmp_path_factory.mktemp("arc6")
    mesh = load_obj(make_cube_obj(d))
    res = 160
    camera = Camera.pinhole(1.2 * res, 1.2 * res, (res - 1) / 2, (res - 1) / 2, res, res, device=CPU)
    out = d / "captures"
    out.mkdir()
    for i in range(6):
        ang = np.deg2rad(22.0) * i
        T = look_at_w2c(0.9 * np.array([np.sin(ang), 0.35, np.cos(ang)]))
        write_png(out / f"map_{i:04d}.png", render_mesh(mesh, T, camera))
    return out


def test_reconstruct_dense_through_the_cli(arc_images, tmp_path, capsys):
    port(["reconstruct", "--object_path", str(tmp_path / "obj"), "--images", str(arc_images), "--detector", "dense",
          "--no-featuremetric", "--max_keypoints", "384"])
    assert "reconstructed" in capsys.readouterr().out
    rec = SceneModel.load(layout(tmp_path / "obj")["ref_sfm"])
    assert len(rec.images) >= 5 and len(rec.points3D) >= 25, (len(rec.images), len(rec.points3D))


class _Stop(Exception):
    pass


def _captured_mapper_call(monkeypatch, argv):
    """The keyword arguments ``reconstruct`` hands the mapper."""
    seen = {}

    def fake(images, cam_rec, **kw):
        seen.update(kw, images=images)
        raise _Stop

    monkeypatch.setattr(tinc, "incremental_sfm", fake)
    with pytest.raises(_Stop):
        port(argv)
    return seen


def test_reconstruct_learned_matcher_through_the_cli(arc_images, tmp_path, monkeypatch):
    """``--detector dense --matcher learned`` hands the mapper the dense
    descriptor at its own operating point and the checkpoint's matcher; that
    matcher gives JAX's matches on two of the views' features."""
    import jax

    from pixtrack_tpu.mapping import attention_matcher as jam
    from pixtrack_tpu.mapping import default_descriptor as jdefault_descriptor

    cfg = jam.MatcherConfig(d_model=32, n_heads=2, n_layers=1, desc_dim=128)
    jmodel, jparams = jam.init_matcher(jax.random.PRNGKey(5), cfg)
    jam.save_matcher_weights(tmp_path / "m.npz", jparams, cfg)
    monkeypatch.setenv("PIXTRACK_MATCHER_WEIGHTS", str(tmp_path / "m.npz"))
    argv = ["reconstruct", "--object_path", str(tmp_path / "obj"), "--images", str(arc_images),
            "--max_keypoints", "256"]
    kw = _captured_mapper_call(monkeypatch, argv + ["--detector", "dense", "--matcher", "learned"])
    detector, matcher = kw["detector"], kw["matcher"]
    assert detector.name == "harris+dense" and kw["match_kw"] == dict(min_score=0.1, ratio=0.98)
    assert isinstance(matcher, tam.LearnedMatcher) and matcher.desc_dim == 128 and matcher.min_score == 0.2
    img0, img1 = kw["images"][1], kw["images"][2]
    (kp0, _, d0), (kp1, _, d1) = [detector(im, max_keypoints=256, nms_radius=1) for im in (img0, img1)]
    (jkp0, _, jd0), (jkp1, _, jd1) = [jdefault_descriptor(max_keypoints=256)(im, nms_radius=1) for im in (img0, img1)]
    np.testing.assert_allclose(kp0.numpy(), np.asarray(jkp0), atol=1e-4)
    m0, s0 = matcher(d0, kp0, img0.shape, d1, kp1, img1.shape)
    jm0, js0 = jam.LearnedMatcher(jmodel, jparams)(jd0, np.asarray(jkp0), img0.shape, jd1, np.asarray(jkp1),
                                                   img1.shape)
    assert (m0 == jm0).mean() >= 0.99
    np.testing.assert_allclose(s0, js0, atol=1e-4)

    # the descriptor-dimension guard: a 128-d matcher cannot take Harris patches (845-d)
    with pytest.raises(SystemExit, match="trained on 128-d"):
        port(argv + ["--detector", "harris", "--matcher", "learned"])
    kw = _captured_mapper_call(monkeypatch, argv + ["--detector", "harris", "--matcher", "auto"])
    assert kw["matcher"] is None and kw["detector"] is None and kw["match_kw"] == dict(min_score=0.5, ratio=0.98)
    kw = _captured_mapper_call(monkeypatch, argv + ["--detector", "dense"])  # auto takes the matching matcher
    assert isinstance(kw["matcher"], tam.LearnedMatcher)


def test_new_subcommands_default_to_the_card(tmp_path, monkeypatch, object_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["demo", "--frames", "1"],
                 ["track", "--object_path", str(object_dir), "--query", str(tmp_path), "--out_dir", str(tmp_path)],
                 ["visualize", "--object_path", str(object_dir), "--poses", str(tmp_path / "p.pkl")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
