"""Parity of the port's tracker lineage (tracking/variants.py) with the JAX
package on the CPU: the in-plane roll algebra, the image warps that stand in
for cv2 (``rotate_image``, ``resize_image``), and r5 / r1 / r6 / r3 / r7 / r8
on the synthetic world against the JAX trackers of the same variant.

Tolerances. Roll algebra: 1e-6 against the JAX functions (f64 numpy on both
sides, rounded to f32 once). ``rotate_image`` against ``cv2.warpAffine``: one
8-bit level on interior pixels of a smooth image (cv2 interpolates in fixed
point with coordinates quantised to 1/32 pixel). Trackers, as
tests/test_variants.py holds the JAX ones against the ground truth: rotation
median under 10 deg (8 for r6) and translation median under 0.3; and between
the packages, per frame: the same success flags and reference ids, costs
within 5e-3 relative (the stepwise tracker test's; plus 1e-6, since the
first frame starts at a mapping view and costs ~1e-13), poses within
0.05 deg and 1e-3 (the fused frame test's).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixtrack_tpu.align.lm import AlignConfig as JAlignConfig
from pixtrack_tpu.features import FeatureExtractor as JExtractor
from pixtrack_tpu.features import HandcraftedExtractor as JHandcrafted
from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu.tracking import variants as jvar
from pixtrack_tpu_torch.align.lm import AlignConfig
from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.tracking import variants as tvar

from synthetic_world import look_at_w2c
from test_torch_world import keep_samples, paired_world, pose_error

torch.set_num_threads(2)


def _tpose(T: JPose) -> Pose:
    return Pose.from_Rt(np.asarray(T.R), np.asarray(T.t))


# ------------------------------------------------------------ roll algebra --
class TestRollMath:
    def test_pre_opt_rotation_matches_cv2_coordinate_map(self):
        """project(pre_opt_rotation(T, a), X) equals cv2's rotation matrix
        applied to project(T, X), and the JAX function's pose (1e-6)."""
        cv2 = pytest.importorskip("cv2")
        cam = Camera.pinhole(140.0, 140.0, 63.5, 63.5, 128, 128)
        Tj = look_at_w2c(np.array([0.4, 0.3, 1.5]))
        T = _tpose(Tj)
        X = torch.as_tensor(np.random.default_rng(0).uniform(-0.2, 0.2, (50, 3)).astype(np.float32))
        p2d = cam.world2image(T, X)[0].numpy()
        for a_deg in (30.0, -72.0, 145.0):
            M = cv2.getRotationMatrix2D((63.5, 63.5), a_deg, 1.0)
            expected = p2d @ M[:, :2].T + M[:, 2]
            T_rot = tvar.pre_opt_rotation(T, np.deg2rad(a_deg))
            np.testing.assert_allclose(cam.world2image(T_rot, X)[0].numpy(), expected, atol=1e-3)
            Tj_rot = jvar.pre_opt_rotation(Tj, np.deg2rad(a_deg))
            np.testing.assert_allclose(np.asarray(Tj_rot.R), T_rot.R.numpy(), atol=1e-6)
            np.testing.assert_allclose(np.asarray(Tj_rot.t), T_rot.t.numpy(), atol=1e-6)

    def test_post_opt_inverts_pre_opt(self):
        T = _tpose(look_at_w2c(np.array([0.4, 0.3, 1.5])))
        for a in (0.3, -1.2):
            dR, dt = pose_error(tvar.post_opt_rotation(tvar.pre_opt_rotation(T, a), a), T)
            assert dR < 1e-4 and dt < 1e-6

    def test_roll_of_pose_upright_is_zero(self):
        T = _tpose(look_at_w2c(np.array([0.0, 0.0, 1.5]), up=np.array([0.0, 1.0, 0.0])))
        assert abs(tvar.roll_of_pose(T, up_world=(0.0, 1.0, 0.0))) < 1e-6

    def test_roll_correction_zeroes_roll(self):
        """Rotating the image by the measured roll leaves zero residual roll;
        the measured roll equals the JAX function's (1e-6)."""
        Tj = look_at_w2c(np.array([0.0, 0.0, 1.5]), up=np.array([0.0, 1.0, 0.0]))
        T = _tpose(Tj)
        for a in (0.4, -0.9):
            T_roll = tvar.pre_opt_rotation(T, a)
            r = tvar.roll_of_pose(T_roll, up_world=(0.0, 1.0, 0.0))
            assert abs(r - jvar.roll_of_pose(jvar.pre_opt_rotation(Tj, a), up_world=(0.0, 1.0, 0.0))) < 1e-6
            assert abs(tvar.roll_of_pose(tvar.pre_opt_rotation(T_roll, r), up_world=(0.0, 1.0, 0.0))) < 1e-5

    def test_rotate_image_rotates_content(self):
        img = np.zeros((64, 64, 3), np.uint8)
        img[10:20, 28:36] = 255  # patch above center
        out = tvar.rotate_image(img, 90.0)  # CCW: the patch moves to the left side
        assert isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.shape == img.shape
        ys, xs = np.nonzero(out[..., 0] > 128)
        assert xs.mean() < 28 and abs(ys.mean() - 31.5) < 4


def _smooth_image(h, w, c, seed):
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(np.random.default_rng(seed).uniform(0, 1, (h, w, c)), (3, 3, 0))
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


@pytest.mark.parametrize("angle,center", [(17.0, None), (-72.5, (40.25, 21.5)), (180.0, None), (0.0, (10.0, 50.0))])
def test_rotate_image_matches_cv2_warp_affine(angle, center):
    """uint8 and float images, the default and an arbitrary centre: interior
    pixels within one 8-bit level of cv2.warpAffine(INTER_LINEAR), and the
    pixels that map from outside the image are black in both."""
    cv2 = pytest.importorskip("cv2")
    img = _smooth_image(60, 90, 3, seed=int(abs(angle)))
    h, w = img.shape[:2]
    c = center or ((w - 1) / 2.0, (h - 1) / 2.0)
    M = cv2.getRotationMatrix2D(tuple(float(v) for v in c), angle, 1.0)
    ref = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR)
    # interior: output pixels whose source lies at least one pixel inside the image
    ys, xs = np.mgrid[:h, :w]
    Minv = cv2.invertAffineTransform(M)
    sx = Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]
    sy = Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]
    interior = (sx >= 1) & (sx <= w - 2) & (sy >= 1) & (sy <= h - 2)
    outside = (sx < -1) | (sx > w) | (sy < -1) | (sy > h)
    assert interior.sum() > 500
    out = tvar.rotate_image(img, angle, center)
    assert out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int))[interior].max() <= 1
    assert (out[outside] == 0).all() and (ref[outside] == 0).all()
    # float image, tensor in and tensor out, and a gray (H, W) image
    f = torch.as_tensor(img.astype(np.float32) / 255.0)
    out_f = tvar.rotate_image(f, angle, center)
    assert isinstance(out_f, torch.Tensor) and out_f.dtype == torch.float32
    ref_f = cv2.warpAffine(f.numpy(), M, (w, h), flags=cv2.INTER_LINEAR)
    assert np.abs(out_f.numpy() - ref_f)[interior].max() <= 1 / 255
    gray = tvar.rotate_image(img[..., 0], angle, center)
    assert gray.shape == (h, w) and np.array_equal(gray, out[..., 0])


def test_resize_image_matches_cv2_resize():
    """The reference_scale resize: cv2.resize(img, None, fx=s, fy=s) within
    one 8-bit level at s = 0.5 (and the size cv2 gives at s = 0.3)."""
    cv2 = pytest.importorskip("cv2")
    img = _smooth_image(96, 128, 3, seed=3)
    ref = cv2.resize(img, None, fx=0.5, fy=0.5)
    out = tvar.resize_image(img, 0.5)
    assert out.shape == ref.shape == (48, 64, 3) and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    assert tvar.resize_image(torch.as_tensor(img), 0.3).shape == cv2.resize(img, None, fx=0.3, fy=0.3).shape


# ---------------------------------------------------------------- trackers --
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return paired_world(tmp_path_factory.mktemp("variants"), res=96, n_frames=4, mapping=True)


def _extractors():
    return (JExtractor(JHandcrafted(), resize=None),
            FeatureExtractor(HandcraftedExtractor(device="cpu"), resize=None))


def _align():
    return JAlignConfig(num_iters=50, robust_c=1.0), AlignConfig(num_iters=50, robust_c=1.0)


def _run_pair(world, jtr, ttr, n=None, covis=10):
    """Run both trackers over the frames; per-frame errors against the
    ground truth of each, with the two held to each other."""
    keep_samples(world)
    frames = world.frames[:n]
    for tr, side in ((jtr, world.j), (ttr, world.t)):
        tr.config.covis_threshold = covis
        tr.config.cost_threshold_min = 0.2
        tr.camera = side.camera
        tr.run(frames)
    errs = []
    for i, (name, _) in enumerate(frames):
        rj, rt = jtr.pose_history[name], ttr.pose_history[name]
        assert rj["success"] == rt["success"], name
        assert list(rj["reference_ids"]) == list(rt["reference_ids"]), name
        np.testing.assert_allclose(rt["cost"], rj["cost"], rtol=5e-3, atol=1e-6, err_msg=name)
        Tj = JPose.from_4x4(jnp.asarray(rj["T_refined"], jnp.float32))
        Tt = Pose.from_4x4(rt["T_refined"])
        dR, dt = pose_error(Tt, _tpose(Tj))
        assert dR < 0.05 and dt < 1e-3, (name, dR, dt)
        errs.append(pose_error(Tt, world.t.gt[i]))
    assert jtr.relocalization_count == ttr.relocalization_count
    return errs[1:]


def test_r5_static_disk_refs(world):
    jal, tal = _align()
    je, te = _extractors()
    jtr = jvar.make_tracker_r5(world.j.scene, je, world.mapping_dir, align_cfg=jal)
    ttr = tvar.make_tracker_r5(world.t.scene, te, world.mapping_dir, align_cfg=tal)
    errs = _run_pair(world, jtr, ttr)
    assert np.median([e[0] for e in errs]) < 10.0, errs
    assert np.median([e[1] for e in errs]) < 0.3, errs
    # the mapping image came through the port's own PNG reader
    ref = ttr.static_reference(ttr.reference_ids[0])
    assert ref.feats[0].device.type == "cpu" and len(ref.feats) == 3


def test_r1_fixed_reference(world):
    jal, tal = _align()
    je, te = _extractors()
    jtr = jvar.make_tracker_r1(world.j.scene, je, world.mapping_dir, align_cfg=jal)
    ttr = tvar.make_tracker_r1(world.t.scene, te, world.mapping_dir, align_cfg=tal)
    first = list(ttr.reference_ids)
    _run_pair(world, jtr, ttr, n=3)
    assert ttr.reference_ids == first == list(jtr.reference_ids)  # never re-selects


def test_r6_render_at_db_pose(world):
    jal, tal = _align()
    je, te = _extractors()
    jtr = jvar.make_tracker_r6(world.j.scene, je, world.j.testbed, world.j.nerf2sfm, align_cfg=jal)
    ttr = tvar.make_tracker_r6(world.t.scene, te, world.t.testbed, world.t.nerf2sfm, align_cfg=tal)
    errs = _run_pair(world, jtr, ttr)
    assert np.median([e[0] for e in errs]) < 8.0, errs
    assert set(ttr._static_refs) == set(jtr._static_refs)  # memoized per reference id


def test_r7_reference_scale_and_r8_preset(world):
    """r7 renders its references at half size; r8 is the flagship tracker
    without the mask: the presets' configurations equal the JAX ones."""
    import dataclasses

    jal, tal = _align()
    je, te = _extractors()
    jtr = jvar.make_tracker_r7(world.j.scene, je, world.j.testbed, world.j.nerf2sfm, align_cfg=jal)
    ttr = tvar.make_tracker_r7(world.t.scene, te, world.t.testbed, world.t.nerf2sfm, align_cfg=tal)
    assert dataclasses.asdict(jtr.config) == dataclasses.asdict(ttr.config)
    errs = _run_pair(world, jtr, ttr, n=3)
    assert np.median([e[0] for e in errs]) < 10.0, errs
    ref = ttr.static_reference(ttr.reference_ids[0])
    assert float(ref.weights[0].max()) > 0
    j8 = jvar.make_tracker_r8(world.j.scene, je, world.j.testbed, world.j.nerf2sfm)
    t8 = tvar.make_tracker_r8(world.t.scene, te, world.t.testbed, world.t.nerf2sfm)
    assert dataclasses.asdict(j8.config) == dataclasses.asdict(t8.config) and not t8.config.use_mask
    for make in ("make_tracker_r2", "make_tracker_r3"):
        jc = getattr(jvar, make)(world.j.scene, je, world.mapping_dir).config
        tc = getattr(tvar, make)(world.t.scene, te, world.mapping_dir).config
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc) and tc.num_refs == 2
    with pytest.raises(TypeError, match="StaticRefConfig"):
        tvar.StaticRefTracker(world.t.scene, te, None, None, config=t8.config)


def test_r3_roll_tracking(world):
    jal, tal = _align()
    je, te = _extractors()
    kw = dict(up_world=(0.0, 1.0, 0.0))
    jtr = jvar.make_tracker_r3(world.j.scene, je, world.mapping_dir, align_cfg=jal, **kw)
    ttr = tvar.make_tracker_r3(world.t.scene, te, world.mapping_dir, align_cfg=tal, **kw)
    errs = _run_pair(world, jtr, ttr)
    assert np.median([e[0] for e in errs]) < 10.0, errs
    for name, _ in world.frames:
        rj, rt = jtr.pose_history[name], ttr.pose_history[name]
        assert abs(rj["tracked_roll"] - rt["tracked_roll"]) < 1e-3
        assert rj["tracked_center"] == rt["tracked_center"]


def test_r3_follows_a_rolled_query(world):
    """Queries rolled in-plane by a growing angle (the port's rotate_image,
    ground truth through pre_opt_rotation): the tracked roll follows the
    ground-truth roll within 3 deg, in both packages alike (1e-2 rad)."""
    pytest.importorskip("cv2")
    jal, tal = _align()
    je, te = _extractors()
    kw = dict(up_world=(0.0, 1.0, 0.0))
    jtr = jvar.make_tracker_r3(world.j.scene, je, world.mapping_dir, align_cfg=jal, **kw)
    ttr = tvar.make_tracker_r3(world.t.scene, te, world.mapping_dir, align_cfg=tal, **kw)
    angles = np.deg2rad([0.0, 4.0, 8.0, 12.0])
    c = tuple(float(v) for v in world.t.camera.c)
    frames = [(name, tvar.rotate_image(img, np.rad2deg(a), c)) for (name, img), a in zip(world.frames, angles)]
    gt_roll = [tvar.roll_of_pose(tvar.pre_opt_rotation(T, a), (0.0, 1.0, 0.0)) for T, a in zip(world.t.gt, angles)]
    for tr, side in ((jtr, world.j), (ttr, world.t)):
        tr.config.covis_threshold, tr.config.cost_threshold_min = 10, 0.2
        tr.camera = side.camera
        tr.run(frames)
    for (name, _), g in zip(frames[1:], gt_roll[1:]):
        rt, rj = ttr.pose_history[name], jtr.pose_history[name]
        assert rt["success"] and abs(rt["tracked_roll"] - g) < np.deg2rad(3.0), (name, rt["tracked_roll"], g)
        assert abs(rt["tracked_roll"] - rj["tracked_roll"]) < 1e-2
