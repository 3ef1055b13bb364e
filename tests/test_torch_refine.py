"""The port's SfM refinement against the JAX package's, on the CPU: the
multi-view mean of observations, dense bundle adjustment, featuremetric
keypoint / point / bundle adjustment, the cubic upsampling of KA, and
photometric track refinement; then the chain BA -> KA -> featuremetric BA.

Inputs are numpy arrays fed to both packages: a synthetic rig (6 cameras,
60 points, pixel noise, two gross outliers, one point behind a camera), and
the model that both packages' posed-view SfM build from five 160 x 160
renders of the mesh world's house (tests/test_torch_mapping.py's views).

Bundle adjustment leaves one gauge free: the scale about camera 0's centre
(camera 0 is fixed, the damping absorbs the rest). In f32 the normal
equations' rounding drives steps along it, so the two packages' scales part
(measured on the 42-view rig: 1.0339 and 1.0380 from 1.0354) while the shape
agrees. Poses and points are therefore compared with the scale removed
(``_gauge_free``): rotations as they are, camera centres and points mapped
so that camera 0's centre and the mean distance of the centres from it are
the start's. Tolerances, each measured here:
- aggregate_observations 1e-6 (measured 1.2e-7);
- BA's final state: rotations 1e-3 deg (measured 1.4e-4 on the synthetic
  rig, 3.3e-5 on the small model; 2.3e-3 on the 42-view rig, which
  chip_smoke.py holds), centres and points without the gauge 1e-4 scene
  units (measured 2.1e-6 and 1.6e-6), the robust cost 1e-4 relative;
- KA keypoints 1e-3 px (the segment sums add in another order: measured
  2.3e-5; 6.1e-5 upsampled by 2); the cubic upsampling equals cv2 on uint8
  at scale 2 and lies within one grey level at scale 3 (cv2's own
  coefficient rounding), within 3e-6 on float images;
- PA points 1e-5 (measured 2.4e-7);
- featuremetric BA: rotations 0.02 deg and translations 2e-4, the pose
  LM's tolerance in tests/test_torch_align.py (measured 2.9e-4 deg and
  5.9e-7); points 2e-4 (measured 8.0e-5);
- normals 1e-9 (both are the same numpy), refined keypoints 1e-3 px
  (measured 7.6e-6, 53 observations moved in both);
- the chain: rotations 0.02 deg (measured 1.7e-4), centres 2e-4 (8.0e-5),
  points CHAIN_POINT_TOL (5.3e-4).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pixtrack_tpu.align.observations import aggregate_observations as j_aggregate
from pixtrack_tpu.features import FeatureExtractor as JExtractor
from pixtrack_tpu.features import HandcraftedExtractor as JHandcrafted
from pixtrack_tpu.geometry import Camera as JCamera
from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu.mapping import bundle as jbundle
from pixtrack_tpu.mapping import featuremetric as jfm
from pixtrack_tpu.mapping import track_refine as jtr
from pixtrack_tpu.sfm.scene import SceneModel as JScene
from pixtrack_tpu_torch.align.observations import aggregate_observations
from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.mapping import bundle as tbundle
from pixtrack_tpu_torch.mapping import featuremetric as tfm
from pixtrack_tpu_torch.mapping import track_refine as ttr
from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
from pixtrack_tpu_torch.pipelines import assets as tassets
from pixtrack_tpu_torch.sfm import colmap_io as tcolmap
from pixtrack_tpu_torch.sfm.scene import SceneModel

from smoke_worlds import look_at_w2c

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
RES = 160
CPU = "cpu"
ROT_DEG, GAUGE_TOL = 1e-3, 1e-4
# The chain's points: KA and featuremetric BA run on each package's BA
# output, whose scales part (see above), and PA's position prior and step
# clamp are in scene units, so the gauge does not factor out of them
# (measured 5.3e-4 on a house of diameter 0.44).
CHAIN_POINT_TOL = 1e-3


def _rot_deg(R1, R2):
    """Angles (deg) between rotation stacks, from the chord ||R1 - R2||_F =
    2 sqrt(2) sin(angle / 2): no arccos floor near 0 (f32 matrices put one
    at ~0.02 deg)."""
    return np.rad2deg(2.0 * np.arcsin(np.minimum(np.linalg.norm(R1 - R2, axis=(-2, -1)) / (2.0 * np.sqrt(2.0)), 1.0)))


def _gauge_free(R, t, X, ref_R, ref_t):
    """Camera centres and points with BA's scale gauge removed: scaled about
    camera 0's centre so that the centres' mean distance from it is the
    reference poses'."""
    def centres(R, t):
        return -np.einsum("pji,pj->pi", R, t)

    c, c_ref = centres(R, t), centres(ref_R, ref_t)
    s = np.linalg.norm(c_ref - c_ref[0], axis=1).mean() / np.linalg.norm(c - c[0], axis=1).mean()
    return c[0] + (c - c[0]) * s, c[0] + (X - c[0]) * s


def _scene_arrays(scene):
    """(R (P, 3, 3), t (P, 3), xyz (N, 3)) of either package's scene, f64."""
    R = Rotation.from_quat(np.roll(scene.qvecs, -1, axis=1)).as_matrix()
    return R, scene.tvecs.astype(np.float64), scene.xyz.astype(np.float64)


# ------------------------------------------------------------- fixtures --
@pytest.fixture(scope="module")
def rig():
    """6 cameras on an arc around 60 points; observations with 0.5 px noise,
    two gross outliers, the start perturbed, and point 7 moved behind
    camera 2, so that its observations pay the invisible-observation cap in
    every cost."""
    rng = np.random.default_rng(0)
    P, N = 6, 60
    X_true = rng.normal(size=(N, 3)) * 0.1
    poses = [look_at_w2c(np.array([np.sin(0.25 * i), 0.3, np.cos(0.25 * i)]) * 0.8, target=np.zeros(3))
             for i in range(P)]
    R = np.stack([T.R.numpy() for T in poses]).astype(np.float32)
    t = np.stack([T.t.numpy() for T in poses]).astype(np.float32)
    cam = (300.0, 300.0, 159.5, 119.5, 320, 240)
    camera = Camera.pinhole(*cam)
    cam_idx, pt_idx, uv = [], [], []
    for i in range(P):
        p2d, vis = camera.project(torch.as_tensor(X_true @ R[i].T + t[i], dtype=torch.float32))
        for j in np.nonzero(vis.numpy())[0]:
            cam_idx.append(i)
            pt_idx.append(j)
            uv.append(p2d[j].numpy())
    uv = np.asarray(uv, np.float32) + rng.normal(size=(len(uv), 2)).astype(np.float32) * 0.5
    uv[3] += 40.0
    uv[50] -= 35.0
    R0, t0 = R.copy(), t.copy()
    for i in range(1, P):
        w = rng.normal(size=3) * 0.01
        R0[i] = (torch.linalg.matrix_exp(torch.as_tensor(
            [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=torch.float64)).numpy() @ R[i]
        ).astype(np.float32)
        t0[i] += (rng.normal(size=3) * 0.01).astype(np.float32)
    X0 = (X_true + rng.normal(size=X_true.shape) * 0.005).astype(np.float32)
    c2 = -R[2].T @ t[2]
    X0[7] = c2 - 0.05 * (R[2].T @ np.array([0.0, 0.0, 1.0]))  # 5 cm behind camera 2, out of the others' view
    return dict(R0=R0, t0=t0, X0=X0, cam=cam, cam_idx=np.asarray(cam_idx, np.int32),
                pt_idx=np.asarray(pt_idx, np.int32), uv=uv, w=np.ones(len(uv), np.float32))


@pytest.fixture(scope="module")
def small_model(tmp_path_factory):
    """(port scene, JAX scene of the same files, {image_id: image}): the
    posed-view SfM of five 160 x 160 views of the house, written once and
    read by both packages."""
    mesh = load_obj(REPO / "assets" / "mesh_world" / "src" / "house.obj")
    center = mesh["vertices"].mean(axis=0)
    camera = Camera.pinhole(RES * 1.2, RES * 1.2, (RES - 1) / 2, (RES - 1) / 2, RES, RES)
    images, poses = {}, {}
    for i in range(5):
        ang = 0.15 * i
        T = look_at_w2c(center + 0.6 * np.array([np.sin(ang), 0.35, np.cos(ang)]), target=center)
        poses[i + 1] = T
        images[i + 1] = render_mesh(mesh, T, camera)
    rec = tcolmap.CameraRecord(1, "PINHOLE", RES, RES, np.array([RES * 1.2, RES * 1.2, RES / 2, RES / 2]))
    scene = tassets.reconstruct_from_posed_views(images, poses, rec, names={i: f"v{i}.png" for i in images},
                                                 max_keypoints=512, device=CPU)
    path = tmp_path_factory.mktemp("small_model")
    scene.save(path)
    return SceneModel.load(path), JScene.load(path), images


def _extractors():
    return JExtractor(JHandcrafted(), resize=None), FeatureExtractor(HandcraftedExtractor(device=CPU), resize=None)


# ------------------------------------------------------------------ tests --
def test_aggregate_observations_matches_jax():
    rng = np.random.default_rng(1)
    f = rng.normal(size=(5, 40, 8)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=(5, 40)).astype(np.float32)
    v = rng.uniform(size=(5, 40)) > 0.3
    v[:, 0] = False  # a point seen by no view
    fj, wj, vj = j_aggregate(f, w, v)
    ft, wt, vt = aggregate_observations(torch.as_tensor(f), torch.as_tensor(w), torch.as_tensor(v))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6)


@pytest.mark.parametrize("iters", [10, 20])
def test_bundle_adjust_synthetic_rig_matches_jax(rig, iters):
    """The final state. The first steps are not compared: at the start's
    damping (1e-4) the normal equations are ill-conditioned along the scale
    gauge, and the packages' f32 solves part there; on this rig JAX rejects
    its first step and the port accepts its own (robust cost 3090 -> 479),
    and the runs meet again after a few iterations (measured rotation
    differences: 0.81 deg after 1, 6.1e-3 after 5, 2.1e-4 after 10, 1.4e-4
    after 20)."""
    r = rig
    args = (r["cam_idx"], r["pt_idx"], r["uv"], r["w"])
    pj, Xj = jbundle.bundle_adjust(JPose.from_Rt(r["R0"], r["t0"]), r["X0"], *args, JCamera.pinhole(*r["cam"]),
                                   iters=iters)
    pt, Xt = tbundle.bundle_adjust(Pose.from_Rt(r["R0"], r["t0"]), torch.as_tensor(r["X0"]),
                                   *(torch.as_tensor(a) for a in args), Camera.pinhole(*r["cam"]), iters=iters)
    Rj, tj, Xj = (np.asarray(a, np.float64) for a in (pj.R, pj.t, Xj))
    Rt, tt, Xt = (a.numpy().astype(np.float64) for a in (pt.R, pt.t, Xt))
    # point 7's camera-2 observation is behind the camera at the start and at the end
    for R, t, X in ((r["R0"], r["t0"], r["X0"]), (Rt, tt, Xt)):
        assert (R[2] @ X[7] + t[2])[2] < 0
    assert _rot_deg(Rt, Rj).max() <= ROT_DEG
    np.testing.assert_array_equal(Rt[0], r["R0"][0])  # camera 0 is fixed
    cj, Yj = _gauge_free(Rj, tj, Xj, r["R0"], r["t0"])
    ct, Yt = _gauge_free(Rt, tt, Xt, r["R0"], r["t0"])
    np.testing.assert_allclose(ct, cj, atol=GAUGE_TOL)
    # a point no camera sees (point 7 and any other whose every observation
    # is invisible) has a zero column and stays where it started, outside the gauge
    still = np.abs(Xj - r["X0"]).max(axis=1) == 0
    assert still[7] and still.sum() < 5
    np.testing.assert_array_equal(Xt[still], Xj[still])
    np.testing.assert_allclose(Yt[~still], Yj[~still], atol=GAUGE_TOL)
    # the robust reprojection cost fell, to the same value in both
    def cost(R, t, X):
        pc = np.einsum("mij,mj->mi", R[r["cam_idx"]], X[r["pt_idx"]]) + t[r["cam_idx"]]
        uv = pc[:, :2] / pc[:, 2:] * 300.0 + np.array([159.5, 119.5])
        vis = (pc[:, 2] > 1e-4) & np.all((uv >= 0) & (uv <= np.array([319.0, 239.0])), axis=1)
        e2 = ((uv - r["uv"]) ** 2).sum(1)
        return float(np.sum(np.where(vis, 4.0 * np.log1p(np.minimum(e2, 1e6) / 4.0), 0.0)))
    c0, cj_, ct_ = cost(r["R0"], r["t0"], r["X0"]), cost(Rj, tj, Xj), cost(Rt, tt, Xt)
    assert ct_ < c0
    assert abs(ct_ - cj_) <= 1e-4 * cj_


def test_bundle_adjust_scene_matches_jax(small_model):
    ts, js, _ = small_model
    oj = jbundle.bundle_adjust_scene(js, iters=10)
    ot = tbundle.bundle_adjust_scene(ts, iters=10, device=CPU)
    assert list(ot.point_ids) == list(oj.point_ids) and ot.names == oj.names
    Rj, tj, Xj = _scene_arrays(oj)
    Rt, tt, Xt = _scene_arrays(ot)
    R0, t0, X0 = _scene_arrays(ts)
    assert _rot_deg(Rt, Rj).max() <= ROT_DEG
    cj, Yj = _gauge_free(Rj, tj, Xj, R0, t0)
    ct, Yt = _gauge_free(Rt, tt, Xt, R0, t0)
    np.testing.assert_allclose(ct, cj, atol=GAUGE_TOL)
    np.testing.assert_allclose(Yt, Yj, atol=GAUGE_TOL)
    assert np.abs(Xt - X0).max() > 1e-6  # it moved


def test_ka_solve_random_table_matches_jax():
    rng = np.random.default_rng(2)
    from scipy.ndimage import gaussian_filter

    sizes = [(30, 40), (25, 35), (30, 40)]
    maps = [gaussian_filter(rng.normal(size=(h, w, 6)), (2, 2, 0)).astype(np.float32) for h, w in sizes]
    flat = np.concatenate([m.reshape(-1, 6) for m in maps])
    offs = np.cumsum([0] + [h * w for h, w in sizes])[:-1]
    n_tracks = 25
    obs = [(k, i) for k in range(n_tracks) for i in range(1 + k % 3, 4) if i - 1 < 3]
    track_idx = np.asarray([k for k, _ in obs], np.int32)
    img = np.asarray([i - 1 for _, i in obs])
    Hv = np.asarray([sizes[i][0] for i in img], np.int32)
    Wv = np.asarray([sizes[i][1] for i in img], np.int32)
    p0 = np.stack([rng.uniform([2, 2], [Wv[b] - 3, Hv[b] - 3]) for b in range(len(obs))]).astype(np.float32)
    pj = jfm._ka_solve(flat, offs[img].astype(np.int32), Wv, Hv, p0, track_idx, np.float32(1e-2), np.float32(4.0),
                       iters=10, n_tracks=n_tracks)
    pt = tfm._ka_solve(torch.as_tensor(flat), torch.as_tensor(offs[img]), torch.as_tensor(Wv).long(),
                       torch.as_tensor(Hv).long(), torch.as_tensor(p0), track_idx, 1e-2, 4.0, iters=10,
                       n_tracks=n_tracks)
    assert np.abs(np.asarray(pj) - p0).max() > 0.1
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)


def test_keypoint_adjustment_matches_jax(small_model):
    ts, _, images = small_model
    kps = {int(i): ts.images[int(i)].xys.copy() for i in ts.image_ids}
    tracks = [[(int(i), int(k)) for i, k in zip(p.image_ids, p.point2D_idxs)] for p in ts.points3D.values()]
    rng = np.random.default_rng(3)
    noisy = {i: kp + rng.uniform(-1.0, 1.0, size=kp.shape) for i, kp in kps.items()}
    jex, tex = _extractors()
    cfg_j, cfg_t = jfm.FeatureMetricConfig(num_iters=10), tfm.FeatureMetricConfig(num_iters=10)
    oj = jfm.keypoint_adjustment(images, noisy, tracks, jex, cfg_j)
    ot = tfm.keypoint_adjustment(images, noisy, tracks, tex, cfg_t)
    moved = max(np.abs(oj[i] - noisy[i]).max() for i in oj)
    assert moved > 0.1
    for i in oj:
        np.testing.assert_allclose(ot[i], oj[i], atol=1e-3)


@pytest.mark.parametrize("upsample", [1, 2])
def test_refine_scene_keypoints_matches_jax(small_model, upsample):
    ts, js, images = small_model
    jex, tex = _extractors()
    oj = jfm.refine_scene_keypoints(js, images, jex, jfm.FeatureMetricConfig(num_iters=8), upsample=upsample)
    ot = tfm.refine_scene_keypoints(ts, images, tex, tfm.FeatureMetricConfig(num_iters=8), upsample=upsample)
    moved = max(np.abs(oj.images[i].xys - js.images[i].xys).max() for i in oj.images)
    assert moved > 0.01
    for i in oj.images:
        np.testing.assert_allclose(ot.images[i].xys, oj.images[i].xys, atol=1e-3)


@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resize_cubic_matches_cv2(scale, dtype):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, size=(37, 53, 3)).astype(np.uint8)
    if dtype == "float32":
        img = img.astype(np.float32) / 255.0
    ref = cv2.resize(img, None, fx=scale, fy=scale, interpolation=cv2.INTER_CUBIC)
    out = tfm.resize_cubic(img, scale, device=CPU).numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if dtype == "uint8":
        d = np.abs(out.astype(np.int64) - ref)
        assert d.max() <= (0 if scale == 2 else 1)
    else:
        np.testing.assert_allclose(out, ref, atol=3e-6)
    # a grey image (H, W) too
    g = img[..., 0]
    np.testing.assert_allclose(tfm.resize_cubic(g, scale, device=CPU).numpy().astype(np.float64),
                               cv2.resize(g, None, fx=scale, fy=scale, interpolation=cv2.INTER_CUBIC),
                               atol=1 if dtype == "uint8" else 3e-6)


def test_point_adjustment_matches_jax(small_model):
    ts, js, images = small_model
    jex, tex = _extractors()
    xj = jfm.point_adjustment(js, images, jex, jfm.FeatureMetricConfig(num_iters=8), max_views=4)
    xt = tfm.point_adjustment(ts, images, tex, tfm.FeatureMetricConfig(num_iters=8), max_views=4)
    assert np.abs(np.asarray(xj) - js.xyz).max() > 1e-4
    np.testing.assert_allclose(xt, np.asarray(xj), atol=1e-5)


def test_featuremetric_ba_matches_jax(small_model):
    ts, js, images = small_model
    jex, tex = _extractors()
    cfg_j, cfg_t = jfm.FeatureMetricConfig(num_iters=6), tfm.FeatureMetricConfig(num_iters=6)
    oj = jfm.featuremetric_ba(js, images, jex, rounds=1, pose_iters=20, cfg=cfg_j)
    ot = tfm.featuremetric_ba(ts, images, tex, rounds=1, pose_iters=20, cfg=cfg_t)
    Rj, tj, Xj = _scene_arrays(oj)
    Rt, tt, Xt = _scene_arrays(ot)
    R0, _, _ = _scene_arrays(ts)
    assert _rot_deg(Rj, R0).max() > 1e-3  # the pose block moved
    assert _rot_deg(Rt, Rj).max() <= 0.02
    np.testing.assert_allclose(tt, tj, atol=2e-4)
    np.testing.assert_allclose(Xt, Xj, atol=2e-4)


def test_estimate_normals_matches_jax():
    rng = np.random.default_rng(5)
    xyz = np.concatenate([np.c_[rng.uniform(-1, 1, (50, 2)), 0.001 * rng.normal(size=50)],
                          rng.normal(size=(20, 3))])
    nj, pj = jtr.estimate_normals(xyz, 8, return_planarity=True)
    nt, pt = ttr.estimate_normals(xyz, 8, return_planarity=True)
    np.testing.assert_allclose(np.abs(nt), np.abs(nj), atol=1e-9)
    np.testing.assert_allclose(pt, pj, atol=1e-9)
    assert np.median(np.abs(nt[:50, 2])) > 0.95 and np.median(pt[:50]) < 0.15


def test_refine_tracks_photometric_matches_jax(small_model):
    ts, js, images = small_model
    # every observation moved by up to 1 px, the same draw in both: the refinement has work to do
    shift = {i: np.random.default_rng(i).uniform(-1, 1, ts.images[i].xys.shape) for i in ts.images}

    def jitter(scene, scene_cls):
        return scene_cls(scene.cameras, {i: dataclasses.replace(im, xys=im.xys + shift[i])
                                         for i, im in scene.images.items()}, scene.points3D)

    js2, ts2 = jitter(js, JScene), jitter(ts, SceneModel)
    cfg = dict(max_planarity=1.0)
    oj = jtr.refine_tracks_photometric(js2, images, jtr.TrackRefineConfig(**cfg))
    ot = ttr.refine_tracks_photometric(ts2, images, ttr.TrackRefineConfig(**cfg), device=CPU)
    assert ot._track_refine_applied == oj._track_refine_applied > 10
    for i in oj.images:
        np.testing.assert_allclose(ot.images[i].xys, oj.images[i].xys, atol=1e-3)


def test_refinement_chain_matches_jax(small_model):
    """BA -> KA -> featuremetric BA, the mapper's polish order, in both packages."""
    ts, js, images = small_model
    jex, tex = _extractors()
    oj = jbundle.bundle_adjust_scene(js, iters=10)
    oj = jfm.refine_scene_keypoints(oj, images, jex, jfm.FeatureMetricConfig(num_iters=8))
    oj = jfm.featuremetric_ba(oj, images, jex, rounds=1, pose_iters=20, cfg=jfm.FeatureMetricConfig(num_iters=6))
    ot = tbundle.bundle_adjust_scene(ts, iters=10, device=CPU)
    ot = tfm.refine_scene_keypoints(ot, images, tex, tfm.FeatureMetricConfig(num_iters=8))
    ot = tfm.featuremetric_ba(ot, images, tex, rounds=1, pose_iters=20, cfg=tfm.FeatureMetricConfig(num_iters=6))
    Rj, tj, Xj = _scene_arrays(oj)
    Rt, tt, Xt = _scene_arrays(ot)
    R0, t0, _ = _scene_arrays(ts)
    assert _rot_deg(Rt, Rj).max() <= 0.02
    cj, Yj = _gauge_free(Rj, tj, Xj, R0, t0)
    ct, Yt = _gauge_free(Rt, tt, Xt, R0, t0)
    np.testing.assert_allclose(ct, cj, atol=2e-4)
    np.testing.assert_allclose(Yt, Yj, atol=CHAIN_POINT_TOL)


def test_bundle_adjust_cli_round_trip_on_the_cpu(small_model, tmp_path):
    from pixtrack_tpu_torch.pipelines import cli

    ts, _, _ = small_model
    ts.save(tmp_path / "model")
    cli.main(["--device", "cpu", "bundle-adjust", "--model", str(tmp_path / "model"), "--out",
              str(tmp_path / "out"), "--iters", "5"])
    out = SceneModel.load(tmp_path / "out")
    ref = tbundle.bundle_adjust_scene(ts, iters=5, device=CPU)
    np.testing.assert_allclose(out.qvecs, ref.qvecs, atol=1e-12)
    np.testing.assert_allclose(out.xyz, ref.xyz, atol=1e-12)


def test_bundle_adjust_cli_without_a_card_raises_and_writes_nothing(small_model, tmp_path, monkeypatch):
    from pixtrack_tpu_torch.pipelines import cli

    ts, _, _ = small_model
    ts.save(tmp_path / "model")
    before = sorted((p.name, p.stat().st_mtime_ns) for p in (tmp_path / "model").iterdir())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bundle-adjust", "--model", str(tmp_path / "model"), "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    assert sorted((p.name, p.stat().st_mtime_ns) for p in (tmp_path / "model").iterdir()) == before
