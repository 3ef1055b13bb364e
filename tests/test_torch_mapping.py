"""The port's posed-view SfM against the JAX package's, on the CPU: Harris
detection and the patch descriptor, mutual-NN matching, the epipolar
filter, union-find tracks, the batched DLT and its filter, and the rotation
augmentation (tests/test_mapping.py's cases, held to the JAX functions on
the same inputs).

Inputs are numpy arrays fed to both packages: a checkerboard, and views of
the mesh world's house rendered by the port's rasteriser on a close orbit.
Tolerances, each measured:
- keypoints of rendered views: the same count and order, each within 1e-3
  px (measured 1.8e-4 at 448 px, 7.6e-6 at 160), scores 1e-5 relative
  (6e-7), descriptors of the same keypoints 1e-6 (6e-8);
- checkerboard: its corners lie on pixel edges, where 2-4 pixels tie in
  exact arithmetic and the last bits decide how many pass the NMS, so the
  two sets are compared by distance: each keypoint within 0.1 px of the
  other package's (measured 0.076);
- matches, match vectors after the epipolar filter, tracks, kept tracks:
  exactly; match scores 1e-5 (an 845-term f32 dot product: measured 1.3e-6); points 1e-4 in scene units (the f32 normal equations, solved
  by XLA's and PyTorch's LU: measured 2e-7 here, 8e-5 at most on the 12-view
  rig against f64);
- augmented poses 1e-6 (both roll in f32), keypoints 1e-9.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from pixtrack_tpu.geometry import Camera as JCamera
from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu.mapping import augment as jaug
from pixtrack_tpu.mapping import detector as jdet
from pixtrack_tpu.mapping import matcher as jmatch
from pixtrack_tpu.mapping import triangulate as jtri
from pixtrack_tpu.pipelines import assets as jassets
from pixtrack_tpu.sfm import colmap_io as jcolmap
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.mapping import augment as taug
from pixtrack_tpu_torch.mapping import detector as tdet
from pixtrack_tpu_torch.mapping import matcher as tmatch
from pixtrack_tpu_torch.mapping import triangulate as ttri
from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
from pixtrack_tpu_torch.pipelines import assets as tassets
from pixtrack_tpu_torch.sfm import colmap_io as tcolmap

from smoke_worlds import look_at_w2c

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
RES = 160
CPU = "cpu"


def _jpose(T: Pose) -> JPose:
    return JPose.from_Rt(T.R.numpy(), T.t.numpy())


@pytest.fixture(scope="module")
def views():
    """Five views of the house on a close orbit, 160 x 160 (focal 192)."""
    mesh = load_obj(REPO / "assets" / "mesh_world" / "src" / "house.obj")
    center = mesh["vertices"].mean(axis=0)
    camera = Camera.pinhole(RES * 1.2, RES * 1.2, (RES - 1) / 2, (RES - 1) / 2, RES, RES)
    poses, images = [], []
    for i in range(5):
        ang = 0.15 * i
        T = look_at_w2c(center + 0.6 * np.array([np.sin(ang), 0.35, np.cos(ang)]), target=center)
        poses.append(T)
        images.append(render_mesh(mesh, T, camera))
    return camera, poses, images


def _checkerboard():
    img = np.zeros((96, 96), np.float32)
    sq = 12
    for i in range(0, 96, sq):
        for j in range(0, 96, sq):
            if (i // sq + j // sq) % 2 == 0:
                img[i:i + sq, j:j + sq] = 1.0
    return img, sq


def test_detect_checkerboard_matches_jax():
    img, sq = _checkerboard()
    kw = dict(max_keypoints=200, border=8, nms_radius=3)
    kj, _ = jdet.detect_keypoints(img, **kw)
    kt, st = tdet.detect_keypoints(img, device=CPU, **kw)
    kt = kt.numpy()
    assert len(kt) > 20 and len(kt) == len(st)
    rounded = np.abs(kt % sq)
    assert np.median(np.minimum(rounded, sq - rounded).max(axis=1)) < 2.5
    assert cKDTree(kj).query(kt)[0].max() <= 0.1
    assert cKDTree(kt).query(kj)[0].max() <= 0.1


@pytest.mark.parametrize("view", [0, 3])
def test_detect_describe_rendered_view_matches_jax(views, view):
    img = views[2][view]
    kj, sj = jdet.detect_keypoints(img, max_keypoints=256, nms_radius=2)
    kt, st = tdet.detect_keypoints(img, max_keypoints=256, nms_radius=2, device=CPU)
    kt, st = kt.numpy(), st.numpy()
    assert len(kj) == len(kt) > 20
    assert np.mean(np.abs(kj - kt).max(axis=1) <= 1e-3) == 1.0  # the same order, share 1.0 required
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5 * np.abs(sj).max())
    dj = jdet.describe_keypoints(img, kj)
    dt = tdet.describe_keypoints(img, kj, device=CPU).numpy()
    np.testing.assert_allclose(dt, dj, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(dt, axis=1), 1.0, atol=1e-4)
    _, _, d_all = tdet.detect_and_describe(img, max_keypoints=256, nms_radius=2, device=CPU)
    assert d_all.shape == (len(kt), 13 * 13 * 5)


def test_match_vectors_equal_jax(views):
    camera, poses, images = views
    kj0, _, d0 = jdet.detect_and_describe(images[0], max_keypoints=512, nms_radius=2)
    kj1, _, d1 = jdet.detect_and_describe(images[1], max_keypoints=512, nms_radius=2)
    mj, sj = jmatch.match_descriptors(d0, d1)
    mt, st = tmatch.match_descriptors(torch.as_tensor(np.array(d0)), torch.as_tensor(np.array(d1)))
    assert (mj >= 0).sum() > 12
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(st, sj, atol=1e-5)
    # self-matching is the identity, as in tests/test_mapping.py
    ms, _ = tmatch.match_descriptors(torch.as_tensor(np.array(d0)), torch.as_tensor(np.array(d0)), ratio=1.1)
    ok = ms >= 0
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(ms[ok], np.nonzero(ok)[0])
    # the epipolar filter against the known relative pose
    K = camera.K().numpy().astype(np.float64)
    T01 = poses[1] @ poses[0].inv()
    R01, t01 = T01.R.numpy().astype(np.float64), T01.t.numpy().astype(np.float64)
    fj = jmatch.epipolar_filter(kj0, kj1, mj, K, K, R01, t01)
    ft = tmatch.epipolar_filter(kj0, kj1, mt, K, K, R01, t01)
    np.testing.assert_array_equal(ft, fj)
    assert (ft >= 0).sum() > 0.5 * (mt >= 0).sum()
    assert tmatch.exhaustive_pairs(["a", "b", "c"]) == jmatch.exhaustive_pairs(["a", "b", "c"])
    # an empty side
    np.testing.assert_array_equal(tmatch.match_descriptors(d0[:0], d1)[0], np.zeros(0, np.int32))


def test_gated_matching_matches_jax():
    rng = np.random.default_rng(0)
    fine = rng.normal(size=(6, 16)).astype(np.float32)
    fine /= np.linalg.norm(fine, axis=1, keepdims=True)
    f1 = fine + 0.05 * rng.normal(size=fine.shape).astype(np.float32)
    f1[2] = fine[0] + 0.02 * fine[1]  # an alias of keypoint 0 that the gate vetoes
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    coarse = np.eye(6, dtype=np.float32)
    # all six against all six, and keypoint 0 against the alias alone (gated off)
    for a, b, ga, gb in ((fine, f1, coarse, coarse), (fine[:1], f1[2:3], coarse[:1], coarse[1:2])):
        mj, sj = jmatch.match_descriptors_gated(a, b, ga, gb, gate_threshold=0.5)
        mt, st = tmatch.match_descriptors_gated(a, b, ga, gb, gate_threshold=0.5)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(st, sj)
    assert tmatch.match_descriptors_gated(fine, f1, coarse, coarse)[0][0] == 0


def test_build_tracks_equal_jax():
    rng = np.random.default_rng(3)
    kps = {i: np.zeros((40, 2)) for i in range(1, 6)}
    perm = {i: rng.permutation(40) for i in kps}  # where each of 40 points sits in image i
    matches = {}
    for a in range(1, 6):
        for b in range(a + 1, 6):
            m = np.full(40, -1, np.int32)
            pts = rng.choice(40, 25, replace=False)
            m[perm[a][pts]] = perm[b][pts]
            m[rng.integers(40)] = rng.integers(40)  # a wrong link: merges two tracks, maybe inconsistently
            matches[(a, b)] = m
    tj = jtri.build_tracks(kps, matches)
    assert len(tj) > 5
    assert ttri.build_tracks(kps, matches) == tj
    assert ttri.build_tracks(kps, matches, min_track_length=3) == jtri.build_tracks(kps, matches, 3)
    # a track with two observations in one image is dropped
    bad = {(1, 2): np.array([0, -1, -1]), (2, 3): np.array([0, -1, -1])}
    assert ttri.build_tracks(kps, bad) == jtri.build_tracks(kps, bad) == [[(1, 0), (2, 0), (3, 0)]]


def test_triangulated_scene_matches_jax(views):
    """reconstruct_from_posed_views in both packages on the same five views:
    the same matches, tracks and point ids; points within 1e-4."""
    camera, poses, images = views
    rec = (1, "PINHOLE", RES, RES, np.array([RES * 1.2, RES * 1.2, RES / 2, RES / 2]))
    imgs = {i + 1: im for i, im in enumerate(images)}
    names = {i: f"v{i}.png" for i in imgs}
    tp = {i + 1: T for i, T in enumerate(poses)}
    kw = dict(max_keypoints=512)
    jcam = JCamera.pinhole(RES * 1.2, RES * 1.2, (RES - 1) / 2, (RES - 1) / 2, RES, RES)
    kj, mj = jassets.detect_match_views(imgs, {i: _jpose(T) for i, T in tp.items()}, jcam, **kw)
    kt, mt = tassets.detect_match_views(imgs, tp, camera, device=CPU, **kw)
    assert list(mt) == list(mj)
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k])
    for i in kj:
        np.testing.assert_allclose(kt[i], kj[i], atol=1e-3)
    sj = jassets.reconstruct_from_posed_views(imgs, {i: _jpose(T) for i, T in tp.items()},
                                              jcolmap.CameraRecord(*rec), names=names, **kw)
    st = tassets.reconstruct_from_posed_views(imgs, tp, tcolmap.CameraRecord(*rec), names=names, device=CPU, **kw)
    assert len(st.point_ids) == len(sj.point_ids) > 10
    for pid in sj.points3D:
        np.testing.assert_array_equal(st.points3D[pid].image_ids, sj.points3D[pid].image_ids)
        np.testing.assert_array_equal(st.points3D[pid].point2D_idxs, sj.points3D[pid].point2D_idxs)
    np.testing.assert_allclose(st.xyz, sj.xyz, atol=1e-4)
    np.testing.assert_allclose(st.point_errors, sj.point_errors, atol=1e-3)
    np.testing.assert_allclose(st.qvecs, sj.qvecs, atol=1e-6)
    assert np.median(st.point_errors) < 2.0


def test_triangulate_tracks_matches_jax(views):
    """The batched DLT and its filter on noisy tracks, some of them bad."""
    camera, poses, _ = views
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(60, 3)) * 0.05 + np.array([0.0, 0.0, 0.1])
    kps, tracks = {}, []
    for i, T in enumerate(poses):
        p2d, _ = camera.world2image(T, torch.as_tensor(xyz, dtype=torch.float32))
        kps[i] = p2d.numpy().astype(np.float64) + rng.normal(size=p2d.shape) * 0.3
    kps[4][:10] += 30.0  # reprojection outliers
    for k in range(60):
        n = 2 + k % 4
        tracks.append([(i, k) for i in range(n)])
    jc, tc = JCamera.pinhole(RES * 1.2, RES * 1.2, (RES - 1) / 2, (RES - 1) / 2, RES, RES), camera
    cam_for = {i: 1 for i in range(5)}
    xj, kept_j, ej = jtri.triangulate_tracks(tracks, kps, {i: _jpose(T) for i, T in enumerate(poses)}, {1: jc},
                                             cam_for)
    xt, kept_t, et = ttri.triangulate_tracks(tracks, kps, dict(enumerate(poses)), {1: tc}, cam_for, device=CPU)
    assert kept_t == kept_j and 10 < len(kept_t) < 60
    np.testing.assert_allclose(xt, xj, atol=1e-4)
    np.testing.assert_allclose(et, ej, atol=1e-3)


def test_rotate_pose_in_plane_matches_jax(views):
    _, poses, _ = views
    for T in poses[:3]:
        for angle in (30, 90, 210, 330):
            a = jaug.rotate_pose_in_plane(_jpose(T), angle)
            b = taug.rotate_pose_in_plane(T, angle)
            np.testing.assert_allclose(b.R.numpy(), np.asarray(a.R), atol=1e-6)
            np.testing.assert_allclose(b.t.numpy(), np.asarray(a.t), atol=1e-6)
            qa, qb = a.to_quat_t()[0], b.to_quat_t()[0]
            np.testing.assert_allclose(qb.numpy(), np.asarray(qa), atol=1e-6)
    np.testing.assert_array_equal(taug.rotation_affine(90, 100, 80), jaug.rotation_affine(90, 100, 80))
    np.testing.assert_allclose(taug.rotation_affine(90, 100, 80) @ np.array([50, 40, 1.0]), [50, 40], atol=1e-9)
    assert taug.augmented_name("img.png", 90) == jaug.augmented_name("img.png", 90) == "img_rot090.png"


def test_augment_scene_matches_jax():
    """Both packages augment the same JAX-built scene: images, poses,
    keypoints and extended tracks agree; the port's rolled poses reproject
    the points onto the rotated keypoints."""
    from pixtrack_tpu.sfm.scene import SceneModel as JScene
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    from synthetic_world import make_scene

    jcam = JCamera.pinhole(RES * 1.2, RES * 1.2, (RES - 1) / 2, (RES - 1) / 2, RES, RES)
    js = make_scene(jcam, n_refs=4, n_points=200)
    ts = SceneModel(js.cameras, js.images, js.points3D)
    ja = jaug.augment_scene(js, angles=(90, 180, 330))
    ta = taug.augment_scene(ts, angles=(90, 180, 330), device="cpu")
    assert isinstance(ja, JScene) and len(ta.images) == len(ja.images) == 4 * len(js.images)
    np.testing.assert_array_equal(ta.image_ids, ja.image_ids)
    assert ta.names == ja.names
    np.testing.assert_allclose(ta.qvecs, ja.qvecs, atol=1e-6)
    np.testing.assert_allclose(ta.tvecs, ja.tvecs, atol=1e-6)
    for iid in ja.images:
        np.testing.assert_allclose(ta.images[iid].xys, ja.images[iid].xys, atol=1e-9)
        np.testing.assert_array_equal(ta.images[iid].point3D_ids, ja.images[iid].point3D_ids)
    for pid in ja.points3D:
        np.testing.assert_array_equal(ta.points3D[pid].image_ids, ja.points3D[pid].image_ids)
        np.testing.assert_array_equal(ta.points3D[pid].point2D_idxs, ja.points3D[pid].point2D_idxs)
    assert ta.track_lengths.sum() == 4 * ts.track_lengths.sum()
    et, ej = taug.verify_augmentation_consistency(ts, ta, device="cpu"), jaug.verify_augmentation_consistency(js, ja)
    assert et < 1.0 and abs(et - ej) < 1e-3
