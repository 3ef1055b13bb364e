"""The port's evaluation metrics, frame IO, configuration and visualization
against the JAX package's on the same inputs (host code: numpy, cv2, yaml),
mirroring tests/test_eval_viz.py, tests/test_viz_tools.py and the config / IO
cases of tests/test_config_cli.py.

Tolerances: metrics and drawn images equal the JAX package's exactly (the
metrics are copied numpy code, and the drawings go through the same cv2
calls at projections that round to the same pixels); projections 1e-4.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as SR

from pixtrack_tpu.eval import metrics as jmetrics
from pixtrack_tpu_torch.eval import metrics as tmetrics
from pixtrack_tpu_torch.geometry import Camera, Pose

torch.set_num_threads(2)


# ---------------------------------------------------------------- metrics --
def _trajectory(rng, n=10):
    gt, est = [], []
    for i in range(n):
        R = SR.from_euler("y", 3 * i, degrees=True).as_matrix()
        t = np.array([0.01 * i, 0, 1.0])
        gt.append((R, t))
        Rn = SR.from_euler("yx", [3 * i + rng.uniform(-2, 2), rng.uniform(-4, 4)], degrees=True).as_matrix()
        est.append((Rn, t + rng.normal(size=3) * 0.02))
    return est, gt


def test_pose_errors_and_threshold_accuracy_match(rng):
    R1 = SR.from_euler("y", 5, degrees=True).as_matrix()
    r, t = tmetrics.pose_errors(R1, [0, 0, 0.02], np.eye(3), [0, 0, 0])
    assert r == pytest.approx(5.0, abs=1e-4) and t == pytest.approx(0.02)
    assert (r, t) == jmetrics.pose_errors(R1, [0, 0, 0.02], np.eye(3), [0, 0, 0])
    et, er = rng.uniform(0, 0.1, 50), rng.uniform(0, 10, 50)
    assert tmetrics.threshold_accuracy(et, er, 0.05, 5.0) == jmetrics.threshold_accuracy(et, er, 0.05, 5.0)
    assert tmetrics.threshold_accuracy([0.01, 0.06, 0.02], [2.0, 1.0, 9.0], 0.05, 5.0) == pytest.approx(1 / 3)


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_recovers_similarity_and_matches(rng, with_scale):
    src = rng.normal(size=(40, 3))
    R = SR.from_euler("zx", [25, -40], degrees=True).as_matrix()
    s, t = (1.7 if with_scale else 1.0), np.array([1.0, -2.0, 0.5])
    dst = s * src @ R.T + t
    s2, R2, t2 = tmetrics.umeyama_alignment(src, dst, with_scale=with_scale)
    assert s2 == pytest.approx(s, rel=1e-6)
    np.testing.assert_allclose(R2, R, atol=1e-8)
    np.testing.assert_allclose(t2, t, atol=1e-8)
    sj, Rj, tj = jmetrics.umeyama_alignment(src, dst, with_scale=with_scale)
    assert s2 == sj and np.array_equal(R2, Rj) and np.array_equal(t2, tj)


@pytest.mark.parametrize("align", [False, True])
def test_evaluate_trajectory_matches(rng, align):
    est, gt = _trajectory(rng)
    pts = rng.normal(size=(64, 3)) * 0.1
    out = tmetrics.evaluate_trajectory(est, gt, model_points=pts, align=align, add_auc_threshold=0.1)
    ref = jmetrics.evaluate_trajectory(est, gt, model_points=pts, align=align, add_auc_threshold=0.1)
    assert out == ref
    assert {"mean_r_deg", "median_t", "acc_5cm5deg", "acc_3cm3deg", "success_10cm10deg", "n_frames", "mean_add",
            "mean_add_s", "add_auc", "add_s_auc"} <= set(out)
    assert 0 <= out["add_auc"] <= 1.0 and out["n_frames"] == 10 and (align or out["add_auc"] > 0)
    assert "add_auc" not in tmetrics.evaluate_trajectory(est, gt)


def test_eval_package_exports_match():
    import pixtrack_tpu.eval as je
    import pixtrack_tpu_torch.eval as te

    assert sorted(je.__all__) == sorted(te.__all__)
    assert all(callable(getattr(te, n)) for n in te.__all__)


# -------------------------------------------------------------- config, IO --
def test_config_yaml_and_shell_match(tmp_path):
    pytest.importorskip("yaml")
    from pixtrack_tpu.utils import config as jcfg
    from pixtrack_tpu_torch.utils import config as tcfg
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.features import HandcraftedExtractor
    from pixtrack_tpu_torch.tracking.tracker import TrackerConfig

    sh = tmp_path / "obj.sh"
    sh.write_text('export OBJECT=mug\nexport OBJ_AABB="[[0.1, 0.2, 0.3], [0.7, 0.8, 0.9]]"\n'
                  "export UPRIGHT_REF_IMG='mapping/0001.png'\nexport OBJECT_ID=5\nexport OBJ_CENTER=\"(0.1, 0.2, 0.3)\"\n")
    jo, to = jcfg.ObjectConfig.from_shell_config(sh), tcfg.ObjectConfig.from_shell_config(sh)
    assert dataclasses.asdict(jo) == dataclasses.asdict(to) and to.object_id == 5 and to.aabb[1][2] == 0.9
    run = tcfg.RunConfig(reference_scale=0.3, num_iters=77, cold_multiscale=(2, 1), extractor="handcrafted")
    tcfg.save_config(to, run, tmp_path / "cfg.yaml")
    jo2, jr2 = jcfg.load_config(tmp_path / "cfg.yaml")  # the JAX package reads what the port wrote
    to2, tr2 = tcfg.load_config(tmp_path / "cfg.yaml")
    assert dataclasses.asdict(jo2) == dataclasses.asdict(to2) == dataclasses.asdict(to)
    assert dataclasses.asdict(jr2) == dataclasses.asdict(tr2)
    assert tcfg.load_config(sh)[0].name == "mug"
    # tracker_config, align_config and make_extractor make the port's own objects with the JAX package's values
    tc, ac = tr2.tracker_config(to2), tr2.align_config()
    assert isinstance(tc, TrackerConfig) and isinstance(ac, AlignConfig)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jr2.tracker_config(jo2))
    assert ac.num_iters == 77 and dataclasses.asdict(ac) == {
        f.name: getattr(jr2.align_config(), f.name) for f in dataclasses.fields(ac)}
    ex = tr2.make_extractor(device="cpu")
    assert isinstance(ex.model, HandcraftedExtractor) and ex.resize == 1024 and ex.device.type == "cpu"
    unet = tcfg.RunConfig(extractor="unet").make_extractor(device="cpu")
    again = tcfg.RunConfig(extractor="unet").make_extractor(device="cpu")
    w1, w2 = next(unet.model.parameters()), next(again.model.parameters())
    assert torch.equal(w1, w2)  # random weights, but from a fixed seed


def test_frame_iterators_and_readers_match(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    from pixtrack_tpu.utils import io as jio
    from pixtrack_tpu_torch.utils import io as tio

    imgs = [rng.integers(0, 256, (20, 30, 3)).astype(np.uint8) for _ in range(3)]
    for i, im in enumerate(imgs):
        cv2.imwrite(str(tmp_path / f"f_{i:03d}.png"), im[..., ::-1])
    cv2.imwrite(str(tmp_path / "g.png"), imgs[0][..., 0])                       # gray
    cv2.imwrite(str(tmp_path / "h.png"), np.dstack([imgs[1], imgs[2][..., :1]]))  # with alpha
    cv2.imwrite(str(tmp_path / "j.jpg"), imgs[2])                              # another format: a library reads it
    for cls in ("ImagePathIterator", "ImageIterator"):
        a, b = list(getattr(jio, cls)(tmp_path, max_frames=5)), list(getattr(tio, cls)(tmp_path, max_frames=5))
        assert len(a) == len(b) == 5 and len(getattr(tio, cls)(tmp_path)) == 6
        for (pa, ia), (pb, ib) in zip(a, b):
            assert pa == pb and ib.dtype == np.uint8
            np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(tio._read_rgb(tmp_path / "f_001.png"), imgs[1])
    with pytest.raises(FileNotFoundError):
        tio._read_rgb(tmp_path / "missing.png")
    assert tio.YCB_CLASS_MAP == jio.YCB_CLASS_MAP
    for spec in ("7/:20", "5:8", ":3", "4:", "", "0002/10:50"):
        assert tio.parse_frame_range(spec, 100) == jio.parse_frame_range(spec, 100)


def test_ycb_video_iterator_matches(tmp_path, rng):
    """A two-frame YCB-Video folder (colour PNG + meta.mat): the same paths,
    images, poses and cameras as the JAX iterator, as the port's types."""
    cv2 = pytest.importorskip("cv2")
    from scipy.io import savemat

    from pixtrack_tpu.utils.io import YCBVideoIterator as JIter
    from pixtrack_tpu_torch.utils.io import YCBVideoIterator

    folder = tmp_path / "data" / "0007"
    folder.mkdir(parents=True)
    K = np.array([[1066.8, 0, 312.99], [0, 1067.5, 241.31], [0, 0, 1]])
    for i in range(1, 3):
        cv2.imwrite(str(folder / f"{i:06d}-color.png"), rng.integers(0, 256, (48, 64, 3)).astype(np.uint8))
        poses = np.zeros((3, 4, 2))
        for k in range(2):
            poses[:, :3, k] = SR.from_euler("xyz", rng.uniform(-40, 40, 3), degrees=True).as_matrix()
            poses[:, 3, k] = rng.uniform(-0.2, 0.2, 3) + [0, 0, 0.9]
        # the second frame does not show the object: it is skipped
        savemat(str(folder / f"{i:06d}-meta.mat"),
                {"poses": poses, "cls_indexes": np.array([[2], [5 if i == 1 else 9]]), "intrinsic_matrix": K})
    a = list(JIter(tmp_path, "7", "006_mustard_bottle"))
    it = YCBVideoIterator(tmp_path, "7", "006_mustard_bottle", device="cpu")
    b = list(it)
    assert len(it) == 2 and len(a) == len(b) == 1
    (pa, ia, Ta, ca), (pb, ib, Tb, cb) = a[0], b[0]
    assert pa == pb and isinstance(Tb, Pose) and isinstance(cb, Camera)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(np.asarray(Ta.R), Tb.R.numpy())
    np.testing.assert_array_equal(np.asarray(Ta.t), Tb.t.numpy())
    for k in ("size", "f", "c", "k"):
        np.testing.assert_allclose(np.asarray(getattr(ca, k)), getattr(cb, k).numpy(), atol=1e-6)
    assert len(YCBVideoIterator(tmp_path, "7", 5, frames=[0], device="cpu")) == 1


# -------------------------------------------------------------------- viz --
def _cams():
    from pixtrack_tpu.geometry import Camera as JCamera
    from pixtrack_tpu.geometry import Pose as JPose

    args = (100.0, 100.0, 79.5, 59.5, 160, 120)
    R = SR.from_euler("xyz", [12, -20, 7], degrees=True).as_matrix().astype(np.float32)
    t = np.array([0.02, -0.03, 1.0], np.float32)
    return (JCamera.pinhole(*args), JPose.from_Rt(R, t)), (Camera.pinhole(*args), Pose.from_Rt(R, t))


def test_draw_overlays_match():
    pytest.importorskip("cv2")
    from pixtrack_tpu.viz import overlay as jov
    from pixtrack_tpu_torch.viz import overlay as tov

    (jc, jT), (tc, tT) = _cams()
    pts = np.random.default_rng(1).uniform(-0.2, 0.2, (20, 3))
    np.testing.assert_allclose(jov._project(jc, jT, pts), tov._project(tc, tT, pts), atol=1e-4)
    img = np.zeros((120, 160, 3), np.uint8)
    ja = jov.draw_pose_axes(img, jc, jT, length=0.2)
    ta = tov.draw_pose_axes(img, tc, tT, length=0.2)
    assert ta.sum() > 0 and img.sum() == 0  # drawn on a copy
    steps = [("draw_object_center", (np.zeros(3),), {}), ("draw_aabb_box", ([-0.2] * 3, [0.2] * 3), {}),
             ("draw_error_text", None, {})]
    for name, args, _ in steps:
        if args is None:
            ja, ta = getattr(jov, name)(ja, 0.03, 2.5), getattr(tov, name)(ta, 0.03, 2.5)
        else:
            ja, ta = getattr(jov, name)(ja, jc, jT, *args), getattr(tov, name)(ta, tc, tT, *args)
        np.testing.assert_array_equal(ja, ta, err_msg=name)
    assert tov.AXIS_COLORS == jov.AXIS_COLORS
    bg = np.full_like(img, 100)
    np.testing.assert_array_equal(tov.blend_images(np.zeros_like(img), bg), bg)  # black passes the query through
    fg = np.random.default_rng(2).integers(0, 256, img.shape).astype(np.uint8)
    np.testing.assert_array_equal(tov.blend_images(fg, bg, 0.3), jov.blend_images(fg, bg, 0.3))


def test_render_pose_overlays_end_to_end(tmp_path):
    """poses.pkl -> re-render through the port's Testbed (the distilled blob
    field) -> overlays on disk -> video."""
    cv2 = pytest.importorskip("cv2")
    from pathlib import Path

    from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
    from pixtrack_tpu_torch.nerf.distill import load_distilled
    from pixtrack_tpu_torch.nerf.testbed import Testbed
    from pixtrack_tpu_torch.viz.overlay import render_pose_overlays, write_video
    from smoke_worlds import look_at_w2c

    tb = Testbed(device="cpu")
    tb.set_baked_field(load_distilled(Path(__file__).resolve().parents[1] / "assets" / "bench_field.npz", device="cpu"))
    tb.render_aabb.min, tb.render_aabb.max = [0.3] * 3, [0.7] * 3
    tb.n_coarse, tb.n_fine = 24, 0
    camera = Camera.pinhole(70.0, 70.0, 31.5, 31.5, 64, 64)
    gt = [look_at_w2c(1.6 * np.array([np.sin(a), 0.0, np.cos(a)])) for a in (0.0, 0.1)]
    query = np.full((64, 64, 3), 60, np.uint8)
    cv2.imwrite(str(tmp_path / "frame_0000.png"), query)
    poses = {}
    for i, T in enumerate(gt):
        name = f"frame_{i:04d}.png"
        poses[name] = {
            "T_refined": T.to_4x4().numpy(),
            "camera": {k: getattr(camera, k).numpy() for k in ("size", "f", "c", "k")},
            "query_path": str(tmp_path / name),  # the second is not on disk: render only
        }
    with open(tmp_path / "poses.pkl", "wb") as f:
        pickle.dump(poses, f)
    gt_poses = {"frame_0001.png": (gt[0].R.numpy(), gt[0].t.numpy())}
    paths = render_pose_overlays(tmp_path / "poses.pkl", None, tb, NerfTransform.identity(), tmp_path / "results",
                                 object_center=np.zeros(3), aabb_sfm=([-0.3] * 3, [0.3] * 3), gt_poses=gt_poses, spp=2)
    assert [os.path.basename(p) for p in paths] == ["result_frame_0000.jpg", "result_frame_0001.jpg"]
    blended, alone = cv2.imread(paths[0]), cv2.imread(paths[1])
    assert blended.shape == alone.shape == (64, 64, 3)
    assert abs(int(blended[2, 2, 0]) - 60) <= 3 and alone[2, 2].max() <= 3  # the query shows behind the first only
    assert alone[20:44, 20:44].max() > 100  # the object is drawn
    write_video(paths, tmp_path / "overlay.mp4", fps=5)
    assert (tmp_path / "overlay.mp4").exists()


@pytest.fixture()
def folders(tmp_path):
    cv2 = pytest.importorskip("cv2")
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    for i in range(3):
        ia, ib = np.zeros((32, 32, 3), np.uint8), np.zeros((32, 32, 3), np.uint8)
        ia[8:16, 8:16] = (200, 0, 0)
        ib[12:20, 12:20] = (0, 200, 0)
        cv2.imwrite(str(a / f"f_{i:03d}.png"), ia[..., ::-1])
        cv2.imwrite(str(b / f"f_{i:03d}.png"), ib[..., ::-1])
    return str(a), str(b), tmp_path


def _read_all(paths):
    import cv2

    return [cv2.imread(p) for p in paths]


@pytest.mark.parametrize("mode", ["max", "blend"])
def test_merge_and_blend_folders_match(folders, mode):
    from pixtrack_tpu.viz import tools as jtools
    from pixtrack_tpu_torch.viz import tools as ttools

    a, b, tmp = folders
    out_t = ttools.merge_image_folders([a, b], str(tmp / "mt"), mode=mode)
    out_j = jtools.merge_image_folders([a, b], str(tmp / "mj"), mode=mode)
    assert len(out_t) == 3
    for x, y in zip(_read_all(out_t), _read_all(out_j)):
        np.testing.assert_array_equal(x, y)
    if mode == "max":
        img = _read_all(out_t)[0][..., ::-1]
        assert img[10, 10, 0] > 150 and img[14, 14, 1] > 150  # both patches kept
    bl_t = ttools.blend_render_and_query_folders(a, b, str(tmp / "bt"), alpha=0.5)
    bl_j = jtools.blend_render_and_query_folders(a, b, str(tmp / "bj"), alpha=0.5)
    for x, y in zip(_read_all(bl_t), _read_all(bl_j)):
        np.testing.assert_array_equal(x, y)
    img = _read_all(bl_t)[0][..., ::-1]
    assert 80 < img[10, 10, 0] < 130 and img[18, 18, 1] > 150


def test_axes_and_video_and_multi_match(folders):
    from pixtrack_tpu.viz import tools as jtools
    from pixtrack_tpu_torch.viz import tools as ttools

    a, b, tmp = folders
    rec = {"T_refined": np.eye(4, dtype=np.float32),
           "camera": {"size": np.array([32.0, 32.0]), "f": np.array([40.0, 40.0]), "c": np.array([15.5, 15.5]),
                      "k": np.array([0.0])}}
    rec["T_refined"][2, 3] = 2.0  # the object in front of the camera
    pkl = tmp / "poses.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({f"f_{i:03d}.png": dict(rec) for i in range(3)}, f)
    out_t = ttools.add_pose_axes_to_folder(str(pkl), a, str(tmp / "at"), length=0.3)
    out_j = jtools.add_pose_axes_to_folder(str(pkl), a, str(tmp / "aj"), length=0.3)
    assert len(out_t) == 3 and (_read_all(out_t)[0].sum(axis=-1) > 0).sum() > 10
    for x, y in zip(_read_all(out_t), _read_all(out_j)):
        np.testing.assert_array_equal(x, y)
    ttools.make_video_from_folder(a, str(tmp / "out.mp4"), fps=5)
    assert os.path.getsize(tmp / "out.mp4") > 0

    def render_fn(rec):
        img = np.zeros((16, 16, 3), np.uint8)  # another size: resized onto the query
        img[2:5, 2:5] = (0, 0, 220)
        return img

    outs_t = ttools.render_overlays_multi([str(pkl), str(pkl)], [render_fn, render_fn], a, str(tmp / "mot"))
    outs_j = jtools.render_overlays_multi([str(pkl), str(pkl)], [render_fn, render_fn], a, str(tmp / "moj"))
    assert len(outs_t) == 3 and _read_all(outs_t)[0][..., ::-1][6, 6, 2] > 100
    for x, y in zip(_read_all(outs_t), _read_all(outs_j)):
        np.testing.assert_array_equal(x, y)
