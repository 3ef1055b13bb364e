"""Parity of the PyTorch alignment port (interpolation, observations, LM)
with the JAX package on the CPU.

Tolerances: interpolation and observations 1e-5 (the same f32 arithmetic;
the corner-packed form 1e-6 against JAX's and exactly the four-gather
form's numbers); the LM on a smooth synthetic problem must take the same
number of iterations and land within 1e-3 degrees and 1e-5 in translation,
with the cost within 1e-3 relative. The traced LM (the classic
evaluate-step-evaluate loop of both packages) is held to the same state
tolerances against JAX's, its per-iteration trace to 1e-3 relative on the
costs and on the steps (plus 1e-5: dR is an arccos of an f32 trace), and its final pose to the deferred-accept
``align_level``'s within 0.02 deg and 2e-4: the two loops stop by different
rules, so they agree to the convergence tolerance, not to the last bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from pixtrack_tpu.align.interpolate import interpolate_features as j_interp
from pixtrack_tpu.align.interpolate import interpolate_packed as j_interp_packed
from pixtrack_tpu.align.interpolate import pack_fmap as j_pack_fmap
from pixtrack_tpu.align.lm import AlignConfig as JAlignConfig
from pixtrack_tpu.align.lm import LevelData as JLevelData
from pixtrack_tpu.align.lm import align_level as j_align_level
from pixtrack_tpu.align.lm import align_level_traced as j_align_level_traced
from pixtrack_tpu.align.lm import align_pyramid as j_align_pyramid
from pixtrack_tpu.align.observations import observe_points as j_observe
from pixtrack_tpu.features.pyramid import FeaturePyramid as JPyramid
from pixtrack_tpu.geometry import Camera as JCamera
from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu_torch.align.interpolate import interpolate_features, interpolate_packed, pack_fmap
from pixtrack_tpu_torch.align.lm import AlignConfig, LevelData, align_level, align_level_traced, align_pyramid
from pixtrack_tpu_torch.align.observations import observe_points
from pixtrack_tpu_torch.features.pyramid import FeaturePyramid
from pixtrack_tpu_torch.geometry import Camera, Pose

torch.set_num_threads(2)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _field(rng, H, W, C, sigma=6.0):
    f = gaussian_filter(rng.normal(size=(H, W, C)).astype(np.float32), (sigma, sigma, 0))
    return (f / np.abs(f).max()).astype(np.float32)


def test_interpolate_features():
    rng = np.random.default_rng(0)
    fmap = rng.normal(size=(20, 30, 5)).astype(np.float32)
    pts = rng.uniform(-2, 32, size=(200, 2)).astype(np.float32)
    vj, gj, okj = j_interp(jnp.asarray(fmap), jnp.asarray(pts))
    vt, gt, okt = interpolate_features(_t(fmap), _t(pts))
    np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
    np.testing.assert_allclose(np.asarray(vj), vt.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gj), gt.numpy(), atol=1e-5)


def _problem(seed, H=120, W=160, C=8, n=256, with_conf=False):
    rng = np.random.default_rng(seed)
    fmap = _field(rng, H, W, C)
    conf = np.clip(_field(rng, H, W, 1)[..., 0] + 0.7, 0, 1).astype(np.float32) if with_conf else None
    p3d = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    p3d[:, 2] = rng.uniform(1.5, 2.5, size=n)
    w_gt = np.deg2rad([2.0, -1.0, 0.5]).astype(np.float32)
    t_gt = np.array([0.02, -0.01, 0.0], np.float32)
    cam = (150.0, 150.0, (W - 1) / 2, (H - 1) / 2, W, H)
    T_gt = JPose.from_aa_t(w_gt, t_gt)
    p2d, vis = JCamera.pinhole(*cam).project(T_gt.transform(jnp.asarray(p3d)))
    f_ref, _, inmap = j_interp(jnp.asarray(fmap), p2d)
    # noise keeps the optimum's cost far above f32 rounding, where
    # accept/reject decisions would otherwise be decided by rounding
    f_ref = np.asarray(f_ref) + 0.02 * rng.normal(size=f_ref.shape).astype(np.float32)
    mask = np.asarray(vis & inmap)
    w_ref = rng.uniform(0.5, 1.0, size=n).astype(np.float32)
    return cam, fmap, conf, p3d, f_ref, w_ref, mask, np.asarray(T_gt.R), t_gt


def _levels(prob, scale=(1.0, 1.0)):
    cam, fmap, conf, p3d, f_ref, w_ref, mask, _, _ = prob
    jl = JLevelData(p3d=jnp.asarray(p3d), f_ref=jnp.asarray(f_ref), w_ref=jnp.asarray(w_ref),
                    mask=jnp.asarray(mask), fmap=jnp.asarray(fmap),
                    conf=None if conf is None else jnp.asarray(conf), scale=jnp.asarray(scale, jnp.float32))
    tl = LevelData(p3d=_t(p3d), f_ref=_t(f_ref), w_ref=_t(w_ref), mask=_t(mask, torch.bool),
                   fmap=_t(fmap), conf=None if conf is None else _t(conf), scale=_t(scale))
    return jl, tl


def _check_state(sj, st, iter_slack=0):
    assert abs(int(sj.num_iters) - int(st.num_iters)) <= iter_slack
    assert bool(sj.converged) == bool(st.converged)
    assert int(sj.num_valid) == int(st.num_valid)
    # the chordal form: at 1e-3 deg, arccos of an f32 trace is all rounding
    chord = np.linalg.norm(np.asarray(sj.T.R, np.float64) - st.T.R.double().numpy())
    ang = np.rad2deg(2 * np.arcsin(min(chord / (2 * np.sqrt(2)), 1.0)))
    assert ang < 1e-3, ang
    np.testing.assert_allclose(np.asarray(sj.T.t), st.T.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(sj.cost), float(st.cost), rtol=1e-3)


@pytest.mark.parametrize("with_conf", [False, True])
def test_align_level_matches(with_conf):
    prob = _problem(1, with_conf=with_conf)
    cam = prob[0]
    jl, tl = _levels(prob)
    T0j, T0t = JPose.from_Rt(np.eye(3, dtype=np.float32), np.zeros(3, np.float32)), \
        Pose.from_Rt(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    for n_it in (5, 60):  # budget-bound and converged
        sj = j_align_level(T0j, jl, JCamera.pinhole(*cam), JAlignConfig(num_iters=n_it))
        st = align_level(T0t, tl, Camera.pinhole(*cam), AlignConfig(num_iters=n_it))
        _check_state(sj, st)
    # it converged towards the ground truth
    assert np.abs(st.T.t.numpy() - prob[-1]).max() < 5e-3


def test_align_pyramid_with_arbitration_matches():
    fine, coarse = _problem(2), _problem(3, H=60, W=80)
    jf, tf = _levels(fine)
    jc, tc = _levels(coarse, scale=(0.5, 0.5))
    cam = fine[0]
    delta = np.array([0.01, -0.02, 0.01, 0.02, 0.0, -0.01], np.float32)
    T0j = JPose.from_Rt(fine[-2], fine[-1]).retract(jnp.asarray(delta))
    T0t = Pose.from_Rt(fine[-2], fine[-1]).retract(_t(delta))
    cfg = dict(num_iters=40)
    fj, sjs = j_align_pyramid(T0j, (jf, jc), JCamera.pinhole(*cam), JAlignConfig(**cfg))
    ft, sts = align_pyramid(T0t, (tf, tc), Camera.pinhole(*cam), AlignConfig(**cfg))
    # the coarse level runs in lockstep; the fine one reaches the optimum,
    # where candidates' costs differ from the best by f32 rounding only, so
    # accept/stall decisions there may stop the two a few iterations apart
    _check_state(sjs[0], sts[0])
    _check_state(sjs[1], sts[1], iter_slack=3)


def test_observe_points_matches():
    rng = np.random.default_rng(4)
    levels = [rng.normal(size=(48, 64, 4)).astype(np.float32), rng.normal(size=(12, 16, 6)).astype(np.float32)]
    confs = [rng.uniform(0, 1, size=lv.shape[:2]).astype(np.float32) for lv in levels]
    scales = ((1.0, 1.0), (0.25, 0.25))
    p3d = rng.uniform(-0.3, 0.3, size=(100, 3)).astype(np.float32)
    p3d[:, 2] += 1.5
    mask = rng.uniform(size=100) > 0.2
    cam = (60.0, 60.0, 31.5, 23.5, 64, 48)
    T = ([0.99, 0.05, -0.05, 0.0], [0.01, 0.0, 0.05])
    oj = j_observe(JPyramid(levels=tuple(map(jnp.asarray, levels)), scales=scales,
                            confidences=tuple(map(jnp.asarray, confs))),
                   JPose.from_quat_t(*map(np.float32, map(np.asarray, T))), JCamera.pinhole(*cam),
                   jnp.asarray(p3d), jnp.asarray(mask))
    ot = observe_points(FeaturePyramid(levels=tuple(map(_t, levels)), scales=scales,
                                       confidences=tuple(map(_t, confs))),
                        Pose.from_quat_t(*T), Camera.pinhole(*cam), _t(p3d), _t(mask, torch.bool))
    for aj, at in zip(oj, ot):
        for a, b in zip(aj, at):
            np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(), atol=1e-5)


@pytest.mark.parametrize("compute_grad", [True, False])
def test_pack_fmap_and_interpolate_packed(compute_grad):
    """The corner-packed pair against JAX's pair (1e-6) and against the
    port's four-gather form (the same numbers), points off the map included."""
    rng = np.random.default_rng(5)
    fmap = rng.normal(size=(20, 30, 5)).astype(np.float32)
    pts = rng.uniform(-2, 32, size=(300, 2)).astype(np.float32)
    pj, pt = j_pack_fmap(jnp.asarray(fmap)), pack_fmap(_t(fmap))
    assert tuple(pt.shape) == (20, 30, 20)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    vj, gj, okj = j_interp_packed(pj, jnp.asarray(pts), compute_grad=compute_grad)
    vt, gt, okt = interpolate_packed(pt, _t(pts), compute_grad=compute_grad)
    np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
    np.testing.assert_allclose(np.asarray(vj), vt.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(gj), gt.numpy(), atol=1e-6)
    v4, g4, ok4 = interpolate_features(_t(fmap), _t(pts), compute_grad=compute_grad)
    ok = ok4.numpy()
    assert 0 < ok.sum() < len(ok)
    np.testing.assert_array_equal(ok, okt.numpy())
    np.testing.assert_array_equal(v4.numpy()[ok], vt.numpy()[ok])
    np.testing.assert_array_equal(g4.numpy()[ok], gt.numpy()[ok])


@pytest.mark.parametrize("with_conf", [False, True])
def test_align_level_traced_matches(with_conf):
    prob = _problem(1, with_conf=with_conf)
    cam = prob[0]
    jl, tl = _levels(prob)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    n_it = 40
    sj, trj = j_align_level_traced(JPose.from_Rt(eye, zero), jl, JCamera.pinhole(*cam), JAlignConfig(num_iters=n_it))
    st, trt = align_level_traced(Pose.from_Rt(eye, zero), tl, Camera.pinhole(*cam), AlignConfig(num_iters=n_it))
    _check_state(sj, st)
    assert set(trt) == {"cost", "dt", "dR", "accepted", "active"}
    active = np.asarray(trj["active"])
    assert all(tuple(v.shape) == (n_it,) for v in trt.values())
    assert 1 <= active.sum() < n_it  # it stopped early: the tail is masked
    np.testing.assert_array_equal(active, trt["active"].numpy())
    # the last active iteration steps by ~1e-7 at the optimum, where f32
    # rounding decides whether its cost is lower: its flag is not compared
    last = int(active.sum()) - 1
    np.testing.assert_array_equal(np.delete(np.asarray(trj["accepted"]), last),
                                  np.delete(trt["accepted"].numpy(), last))
    for k, tol in (("cost", dict(rtol=1e-3)), ("dt", dict(rtol=1e-3, atol=1e-5)), ("dR", dict(rtol=1e-3, atol=1e-5))):
        a, b = np.asarray(trj[k]), trt[k].numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isnan(b[~active]).all()
        np.testing.assert_allclose(a[active], b[active], **tol)
    # the accepted costs do not increase
    acc = trt["cost"].numpy()[trt["accepted"].numpy()]
    assert (np.diff(acc) <= 1e-7).all()
    # the deferred-accept loop from the same start lands at the same optimum
    s2 = align_level(Pose.from_Rt(eye, zero), tl, Camera.pinhole(*cam), AlignConfig(num_iters=60))
    dR, dt = (st.T @ s2.T.inv()).magnitude()
    assert float(dR) < 0.02 and float(dt) < 2e-4, (float(dR), float(dt))
    np.testing.assert_allclose(float(st.cost), float(s2.cost), rtol=1e-3)
