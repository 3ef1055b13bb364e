"""The port's unposed SfM (``pixtrack_tpu_torch/mapping/incremental.py``)
against the JAX package's, on the CPU: the two-view E / H RANSACs and the
relative pose, PnP, both Gauss-Newton polishes, the chain initialisation and
structure-guided matching, and the whole mapper on two rigs.

Random draws: both packages draw RANSAC hypotheses with their own
generators. The tests record JAX's draws (each RANSAC wrapped in the JAX
module, ``jax.random.randint(key, (n_hyp, k), 0, N)`` in call order) and
replay them to the port through its ``_draw_indices``, checking each call's
(n_hyp, k, N). The port chooses no sample that repeats a correspondence
(``incremental._repeats``: such a sample leaves the minimal solver a null
space of two or more dimensions, and its model is whatever the SVD library
returns; the JAX package scores it as any other, and LAPACK builds differ
on it). The two-view, PnP and chain tests hold the port to the JAX
package's RANSACs as shipped: their data has no padding, and each test
asserts that no JAX call there chose a repeated sample
(``jax_best_repeats``), so the rule leaves JAX's choice. The mapper pads
the verification's correspondences cyclically to a power of two, and there
23-53 % of the 2048 draws per pair repeat one (the 6-view arc: JAX's
best-scoring sample one of them in 4 of its 15 pairs, JAX and the port
choosing apart in 5 pairs with them and in none without;
scripts_dev/ransac_repeats.py). Without the rule on either side (JAX's
RANSACs as shipped, the port's rule taken out) the port's mapper on the
6-view arc lies 8.7 deg and 11 % of the points from JAX's on the same
draws. So the mapper tests run JAX's RANSACs with the port's one rule added
(``_jax_ransac_port_rule``: JAX's own solvers, scoring and refits) on the
same draws; what the rule does to the outcome over seeds, in each package,
is scripts_dev/repeat_rule.py's. The rule has a test of its own. Inputs are
numpy arrays fed to both.

Tolerances, each measured here:
- two-view data (tests/test_incremental_sfm.py::TestTwoView's motion, 200
  points, 2e-4 normalised noise, a quarter of view 1 replaced by junk; and
  the motion over a tilted plane): inlier masks and counts exactly; E, H
  (scaled to unit norm) and P equal up to sign to 1e-4 (measured 1.3e-6,
  5.0e-7, 5.1e-7); the relative pose to 1e-4 (2.3e-7), its candidates the
  same set with the same support (the plane's two branches: 1.2e-7 and
  3.8e-7); the Sampson polish after its 30 steps 1e-4 (1.8e-7), the
  reprojection polish after 30 steps 1e-4 (6e-8, robust 1.2e-7);
- the chain initialisation on a synthetic 5-view rig 1e-4 (measured
  2.6e-6), guided matching exactly;
- the mapper (``_compare``): the same registered views, every view's
  rotation relative to the first within ROT_TOL_DEG, camera centres (the
  largest gap) and points (the median gap to the nearest) within GAUGE_TOL
  of the scene's size once each model is similarity-aligned to the truth,
  point counts within COUNT_TOL, and the JAX tests' gates on the port's
  model. The mapper's thresholds (inlier gates, the 6 px triangulation
  gate, the cull gate) turn last-bit differences into different decisions,
  and the port takes its SVDs in f64 (``incremental._svd``) where JAX takes
  them in f32. Measured (rotation, centres, points, counts): the 5-view KA
  rig 3.9e-4 deg, 4.5e-6, 2.7e-4, 103 and 103 points; the 6-view partial
  arc 0.61 deg, 6.0e-3, 1.8e-2, 184 and 186 (with f32 SVDs it agreed to
  0.003 deg); tests/test_torch_reconstruct.py's PnP strategy 3.7e-3 deg,
  4.8e-5, 1.3e-4, 129 and 129, and ``reconstruct --no-featuremetric``
  through both CLIs 0.85 deg, 6.9e-4, 2.5e-3, 115 and 120. Both models pass
  the JAX test's gates.
"""

import functools
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixtrack_tpu.geometry import Camera as JCamera
from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu.mapping import incremental as jinc
from pixtrack_tpu.sfm import colmap_io as jcolmap
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.mapping import incremental as tinc
from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
from pixtrack_tpu_torch.sfm import colmap_io as tcolmap

from smoke_worlds import look_at_w2c, make_cube_obj

torch.set_num_threads(2)
CPU = "cpu"
ROT_TOL_DEG, GAUGE_TOL, COUNT_TOL = 1.5, 0.06, 0.05


# ----------------------------------------------------------- draw replay --
def _jax_repeats(*rows):
    k = rows[0].shape[1]
    same = jnp.ones((rows[0].shape[0], k, k), bool)
    for r in rows:
        same = same & jnp.all(r[:, :, None, :] == r[:, None, :, :], axis=-1)
    return jnp.any(same & ~jnp.eye(k, dtype=bool), axis=(1, 2))


@functools.partial(jax.jit, static_argnames=("kind", "n_hyp", "lo_iters"))
def _jax_ransac_port_rule(a, b, key, kind, n_hyp, thresh, lo_iters):
    """One of the JAX package's three RANSACs, its own minimal solver,
    scoring and refits, with the port's one rule added: a sample that
    repeats a correspondence is not chosen (``incremental._repeats``)."""
    k = {"E": 8, "H": 4, "P": 6}[kind]
    idx = jax.random.randint(key, (n_hyp, k), 0, a.shape[0])
    if kind == "E":
        M = jinc._eight_point(a[idx], b[idx])
        inl = jinc._sampson(M, a, b) < thresh
    elif kind == "H":
        M = jinc._four_point_h(a[idx], b[idx])
        inl = jinc._h_transfer(M, a, b) < thresh
    else:
        M = jinc._dlt_pnp(a[idx], b[idx])
        inl = jinc._score_P(M, a, b[None], thresh)
    best = jnp.argmax(jnp.where(_jax_repeats(a[idx], b[idx]), -1, inl.sum(axis=1)))
    M, inl = M[best], inl[best]
    for _ in range(lo_iters):
        w = inl.astype(jnp.float32)
        if kind == "E":
            M = jinc._eight_point_weighted(a, b, w)
            inl = jinc._sampson(M[None], a, b)[0] < thresh
        elif kind == "H":
            one, zero = jnp.ones_like(a[:, 0]), jnp.zeros_like(a[:, 0])
            r1 = jnp.stack([a[:, 0], a[:, 1], one, zero, zero, zero, -b[:, 0] * a[:, 0], -b[:, 0] * a[:, 1], -b[:, 0]],
                           axis=-1) * w[:, None]
            r2 = jnp.stack([zero, zero, zero, a[:, 0], a[:, 1], one, -b[:, 1] * a[:, 0], -b[:, 1] * a[:, 1], -b[:, 1]],
                           axis=-1) * w[:, None]
            _, _, vt = jnp.linalg.svd(jnp.concatenate([r1, r2], axis=0), full_matrices=True)
            M = vt[-1].reshape(3, 3)
            inl = jinc._h_transfer(M[None], a, b)[0] < thresh
        else:
            M = jinc._dlt_pnp_weighted(a, b, w)
            inl = jinc._score_P(M, a, b, thresh)
    return M, inl, inl.sum()


def record_jax_draws(monkeypatch, port_rule: bool = False) -> list:
    """Wrap the JAX module's three RANSACs: each call appends its hypothesis
    indices to the returned list, then runs the original, or with
    ``port_rule`` ``_jax_ransac_port_rule`` on the same draws."""
    draws = []
    for name, k, kind in (("_essential_ransac", 8, "E"), ("_homography_ransac", 4, "H"), ("_pnp_ransac", 6, "P")):
        orig = getattr(jinc, name)
        params = inspect.signature(orig).parameters

        def wrapped(p0, p1, key, *args, _orig=orig, _k=k, _kind=kind, _params=params, **kw):
            call = {n: kw.get(n, args[i] if i < len(args) else _params[n].default)
                    for i, n in enumerate(("n_hyp", "thresh", "lo_iters"))}
            draws.append((call["n_hyp"], _k, p0.shape[0],
                          np.asarray(jax.random.randint(key, (call["n_hyp"], _k), 0, p0.shape[0])),
                          _kind, np.asarray(p0, np.float32), np.asarray(p1, np.float32), call["thresh"]))
            if not port_rule:
                return _orig(p0, p1, key, *args, **kw)
            with jax.default_matmul_precision("float32"):
                return _jax_ransac_port_rule(jnp.asarray(p0, jnp.float32), jnp.asarray(p1, jnp.float32), key,
                                             _kind, **call)

        monkeypatch.setattr(jinc, name, wrapped)
    return draws


def jax_best_repeats(draw) -> bool:
    """Whether the best-scoring sample of a recorded JAX RANSAC call (the
    one JAX's ``argmax`` chooses) draws one correspondence twice."""
    _, _, _, idx, kind, a, b, thresh = draw
    if kind == "E":
        inl = jinc._sampson(jinc._eight_point(a[idx], b[idx]), a, b) < thresh
    elif kind == "H":
        inl = jinc._h_transfer(jinc._four_point_h(a[idx], b[idx]), a, b) < thresh
    else:
        inl = jinc._score_P(jinc._dlt_pnp(a[idx], b[idx]), a, b[None], thresh)
    return bool(_jax_repeats(a[idx], b[idx])[int(jnp.argmax(inl.sum(axis=1)))])


def replay_draws(monkeypatch, draws: list, stats: dict = None) -> list:
    """The port's ``_draw_indices`` pops ``draws`` in order and asserts each
    call's (n_hyp, k, N); the returned list is what is left.

    With ``stats`` (the mapper), a call whose N differs from JAX's (the two
    verifications kept different matches, see ``_compare``) takes JAX's
    indices modulo its N, a call past JAX's last or of another (n_hyp, k)
    draws from a seeded generator, and ``stats`` counts both."""
    left = list(draws)
    gen = torch.Generator().manual_seed(0)

    def draw(generator, n_hyp, k, n, device):
        if stats is None:
            want = left.pop(0)
            assert (n_hyp, k, n) == want[:3], f"draw ({n_hyp}, {k}, {n}) where JAX drew {want[:3]}"
            return torch.as_tensor(want[3].astype(np.int64)).to(device)
        stats["calls"] = stats.get("calls", 0) + 1
        if not left or left[0][:2] != (n_hyp, k):
            stats["fresh"] = stats.get("fresh", 0) + 1
            return torch.randint(0, n, (n_hyp, k), generator=gen).to(device)
        want = left.pop(0)
        if want[2] != n:
            stats["other_n"] = stats.get("other_n", 0) + 1
        return torch.as_tensor(want[3].astype(np.int64) % n).to(device)

    monkeypatch.setattr(tinc, "_draw_indices", draw)
    return left


def _up_to_sign(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(min(np.abs(a - b).max(), np.abs(a + b).max()))


def _unit(M) -> np.ndarray:
    M = np.asarray(M, np.float64)
    return M / np.linalg.norm(M)


# ------------------------------------------------------------ two-view --
@pytest.fixture(scope="module")
def two_view():
    """TestTwoView's scene: 200 points 3 units ahead, a known motion, the
    projections with 1e-3 normalised noise and a quarter replaced by junk;
    and the matching 2D-3D set of view 1 in pixels for PnP."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.0, 1.0, (200, 3)).astype(np.float32)
    X[:, 2] = X[:, 2] * 0.5 + 3.0
    T1 = Pose.from_aa_t(np.asarray([0.05, 0.25, -0.1], np.float32), np.asarray([0.8, 0.1, 0.05], np.float32))
    x1 = T1.transform(torch.as_tensor(X)).numpy()
    p0 = X[:, :2] / X[:, 2:]
    p1 = x1[:, :2] / x1[:, 2:]
    p0 = (p0 + rng.normal(size=p0.shape) * 2e-4).astype(np.float32)
    p1 = (p1 + rng.normal(size=p1.shape) * 2e-4).astype(np.float32)
    junk = rng.choice(200, 50, replace=False)
    p1[junk] = rng.uniform(-0.3, 0.3, (50, 2)).astype(np.float32)
    # the same motion over a tilted plane: the homography's two branches
    Xp = X.copy()
    Xp[:, 2] = 3.0 + 0.3 * Xp[:, 0]
    xp = T1.transform(torch.as_tensor(Xp)).numpy()
    planar = [(x[:, :2] / x[:, 2:] + rng.normal(size=(200, 2)) * 2e-4).astype(np.float32) for x in (Xp, xp)]
    return {"X": X, "T1": T1, "p0": p0, "p1": p1, "junk": junk, "planar": planar}


def test_essential_homography_pnp_ransac(two_view, monkeypatch):
    p0, p1, X = two_view["p0"], two_view["p1"], two_view["X"]
    draws = record_jax_draws(monkeypatch)  # the JAX package's RANSACs as shipped
    key = jax.random.PRNGKey(3)
    Ej, inlEj, nEj = jinc._essential_ransac(p0, p1, key, n_hyp=512, thresh=2.5e-5)
    Hj, inlHj, nHj = jinc._homography_ransac(p0, p1, key, n_hyp=256, thresh=4e-6)
    Pj, inlPj, nPj = jinc._pnp_ransac(X, p1, key, n_hyp=256, thresh=3e-3)
    assert len(draws) == 3
    assert not any(jax_best_repeats(d) for d in draws)  # so the port's rule leaves the choice as JAX's
    left = replay_draws(monkeypatch, draws)
    t = [torch.as_tensor(a) for a in (p0, p1, X)]
    Et, inlEt, nEt = tinc._essential_ransac(t[0], t[1], None, n_hyp=512, thresh=2.5e-5)
    Ht, inlHt, nHt = tinc._homography_ransac(t[0], t[1], None, n_hyp=256, thresh=4e-6)
    Pt, inlPt, nPt = tinc._pnp_ransac(t[2], t[1], None, n_hyp=256, thresh=3e-3)
    assert not left
    np.testing.assert_array_equal(inlEt.numpy(), np.asarray(inlEj))
    np.testing.assert_array_equal(inlHt.numpy(), np.asarray(inlHj))
    np.testing.assert_array_equal(inlPt.numpy(), np.asarray(inlPj))
    assert (int(nEt), int(nHt), int(nPt)) == (int(nEj), int(nHj), int(nPj))
    assert 100 < int(nEt) < 200 and int(nPt) > 100  # the junk is out, the rest in
    assert _up_to_sign(_unit(Et.numpy()), _unit(Ej)) < 1e-4
    assert _up_to_sign(_unit(Ht.numpy()), _unit(Hj)) < 1e-4
    assert _up_to_sign(Pt.numpy(), Pj) < 1e-4
    # the homography decomposition is the same numpy
    for (Ra, ta, na), (Rb, tb, nb) in zip(tinc.decompose_homography(Ht.numpy()), jinc.decompose_homography(Hj)):
        assert max(np.abs(Ra - Rb).max(), np.abs(ta - tb).max(), np.abs(na - nb).max()) < 1e-4


def test_repeated_samples_are_not_chosen(two_view):
    """``_repeats`` flags the samples that draw one correspondence twice
    (by value: the padding repeats rows under other indices), and the
    RANSAC passes over such a sample even when it comes first and scores
    best (its E is the SVD library's pick from a two-dimensional null
    space)."""
    p0, p1 = torch.as_tensor(two_view["p0"]), torch.as_tensor(two_view["p1"])
    good = np.setdiff1d(np.arange(200), two_view["junk"])
    pad0, pad1 = torch.cat([p0, p0[:56]]), torch.cat([p1, p1[:56]])  # rows 200-255 repeat rows 0-55
    draws = np.stack([good[[0, 1, 2, 3, 4, 5, 6, 6]], np.r_[good[:7], 200 + good[0]], good[10:18], good[20:28]])
    rep = tinc._repeats(pad0[draws], pad1[draws]).tolist()
    assert rep == [True, True, False, False]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinc, "_draw_indices", lambda g, n_hyp, k, n, device: torch.as_tensor(draws[:n_hyp]))
        _, inl, n = tinc._essential_ransac(pad0, pad1, None, n_hyp=4, thresh=2.5e-5, lo_iters=0)
        E_clean = tinc._eight_point(pad0[draws[2:3]], pad1[draws[2:3]])
        E_first = tinc._eight_point(pad0[draws[3:4]], pad1[draws[3:4]])
        s2, s3 = (int((tinc._sampson(E, pad0, pad1) < 2.5e-5).sum()) for E in (E_clean, E_first))
        assert int(n) == max(s2, s3)  # the better of the two clean samples


def test_triangulate_pair_batched(two_view):
    T1 = two_view["T1"]
    p0, p1 = two_view["p0"], two_view["p1"]
    Xj, z0j, z1j = jinc._triangulate_pair(np.asarray(T1.R), np.asarray(T1.t), p0, p1)
    R2 = torch.stack([T1.R, T1.R.T])
    t2 = torch.stack([T1.t, -T1.t])
    Xt, z0t, z1t = tinc._triangulate_pair(R2, t2, torch.as_tensor(p0), torch.as_tensor(p1))
    good = np.setdiff1d(np.arange(200), two_view["junk"])
    np.testing.assert_allclose(Xt[0].numpy()[good], np.asarray(Xj)[good], atol=1e-4)
    np.testing.assert_allclose(z1t[0].numpy()[good], np.asarray(z1j)[good], atol=1e-4)
    X1, _, _ = tinc._triangulate_pair(T1.R, T1.t, torch.as_tensor(p0), torch.as_tensor(p1))
    np.testing.assert_array_equal(X1.numpy(), Xt[0].numpy())  # a batch row is the unbatched call


@pytest.mark.parametrize("scene", ["general", "planar"])
@pytest.mark.parametrize("return_candidates", [False, True])
def test_estimate_relative_pose(two_view, monkeypatch, return_candidates, scene):
    p0, p1, T1 = two_view["p0"], two_view["p1"], two_view["T1"]
    if scene == "planar":
        p0, p1 = two_view["planar"]
    draws = record_jax_draws(monkeypatch)
    out_j = jinc.estimate_relative_pose(p0, p1, jax.random.PRNGKey(1), n_hyp=1024, thresh_px=1.0, focal=300.0,
                                        return_candidates=return_candidates)
    assert not any(jax_best_repeats(d) for d in draws)
    left = replay_draws(monkeypatch, draws)
    out_t = tinc.estimate_relative_pose(p0, p1, None, n_hyp=1024, thresh_px=1.0, focal=300.0,
                                        return_candidates=return_candidates, device=CPU)
    assert not left
    if not return_candidates:
        out_j, out_t = [(0, *out_j)], [(0, *out_t)]
    assert len(out_t) == len(out_j)
    for s_t, T_t, inl_t in out_t:
        # the candidates as a set: each of the port's matches one of JAX's by rotation
        match = [c for c in out_j if np.abs(np.asarray(c[1].R) - T_t.R.numpy()).max() < 1e-4]
        assert len(match) == 1
        s_j, T_j, inl_j = match[0]
        assert s_t == s_j
        np.testing.assert_array_equal(inl_t, np.asarray(inl_j))
        np.testing.assert_allclose(T_t.t.numpy(), np.asarray(T_j.t), atol=1e-4)
    assert len(out_t) == (2 if scene == "planar" and return_candidates else 1)
    dR, _ = (out_t[0][1] @ T1.inv()).magnitude()
    assert float(dR) < 0.5


def test_refine_relative_pose_sampson(two_view):
    p0, p1, T1 = two_view["p0"], two_view["p1"], two_view["T1"]
    w = np.ones(200, np.float32)
    w[two_view["junk"]] = 0.0
    t_unit = T1.t / torch.linalg.norm(T1.t)
    T0 = Pose(T1.R, t_unit).retract(torch.tensor([0.02, -0.01, 0.015, 0.05, -0.03, 0.02]))
    Tj = jinc.refine_relative_pose_sampson(JPose.from_Rt(T0.R.numpy(), T0.t.numpy()), p0, p1, w)
    Tt = tinc.refine_relative_pose_sampson(T0, torch.as_tensor(p0), torch.as_tensor(p1), torch.as_tensor(w))
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-4)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-4)
    dR, _ = (Tt @ Pose(T1.R, t_unit).inv()).magnitude()
    assert float(dR) < 0.1


@pytest.mark.parametrize("robust_c_px", [0.0, 4.0])
def test_refine_pose_reprojection(robust_c_px):
    """TestTwoView::test_pose_polish's case, with 10 % of the observations
    thrown 30 px off for the robust run."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-0.3, 0.3, (100, 3)).astype(np.float32)
    cam_j = JCamera.pinhole(140.0, 140.0, 63.5, 63.5, 128, 128)
    cam_t = Camera.pinhole(140.0, 140.0, 63.5, 63.5, 128, 128)
    T_gt = look_at_w2c(np.array([0.3, 0.2, 1.6]))
    uv, _ = cam_t.world2image(T_gt, torch.as_tensor(X))
    uv = uv.numpy() + rng.normal(size=(100, 2)).astype(np.float32) * 0.3
    if robust_c_px:
        uv[:10] += 30.0
    T0 = T_gt.retract(torch.tensor([0.03, -0.02, 0.01, 0.02, 0.01, -0.03]))
    Tj = jinc.refine_pose_reprojection(JPose.from_Rt(T0.R.numpy(), T0.t.numpy()), X, uv, np.ones(100, np.float32),
                                       cam_j, iters=30, robust_c_px=robust_c_px)
    Tt = tinc.refine_pose_reprojection(T0, torch.as_tensor(X), torch.as_tensor(uv), torch.ones(100), cam_t,
                                       iters=30, robust_c_px=robust_c_px)
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-4)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-4)
    dR, _ = (Tt @ T_gt.inv()).magnitude()
    assert float(dR) < 0.2


def test_orthogonalize_is_the_same_numpy():
    P = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32)
    for a, b in zip(tinc._orthogonalize(torch.as_tensor(P)), jinc._orthogonalize(P)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- chain and guided matching --
@pytest.fixture(scope="module")
def small_rig():
    """5 views on an arc around 150 points, observations with 0.3 px noise,
    the matches of every pair (view-ordered, i < j) from the shared point
    index with 10 % of each pair's matches scrambled; random unit
    descriptors, the same point's close across views."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(150, 3)) * 0.15
    cam = Camera.pinhole(200.0, 200.0, 95.5, 95.5, 192, 192)
    poses = {i + 1: look_at_w2c(0.9 * np.array([np.sin(0.3 * i), 0.35, np.cos(0.3 * i)])) for i in range(5)}
    base = rng.normal(size=(150, 64))
    kps, descs = {}, {}
    for i, T in poses.items():
        uv, _ = cam.world2image(T, torch.as_tensor(X, dtype=torch.float32))
        kps[i] = (uv.numpy() + rng.normal(size=(150, 2)) * 0.3 + 0.5).astype(np.float32)  # corner convention
        d = base + rng.normal(size=base.shape) * 0.2
        descs[i] = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    matches = {}
    for a in range(1, 6):
        for b in range(a + 1, 6):
            m = np.arange(150)
            bad = rng.choice(150, 15, replace=False)
            m[bad] = rng.permutation(m[bad])
            matches[(a, b)] = m
    cam_rec = tcolmap.CameraRecord(1, "PINHOLE", 192, 192, np.array([200.0, 200.0, 96.0, 96.0]))
    return {"X": X, "cam": cam, "cam_rec": cam_rec, "poses": poses, "kps": kps, "descs": descs, "matches": matches}


def test_chain_initialize(small_rig, monkeypatch):
    r = small_rig
    cam_j = JCamera.from_colmap("PINHOLE", r["cam_rec"].params, 192, 192)
    kp_n = {i: jinc._normalize(cam_j, kp - 0.5) for i, kp in r["kps"].items()}
    kp_n_t = {i: tinc._normalize(Camera.from_colmap("PINHOLE", r["cam_rec"].params, 192, 192), kp - 0.5)
              for i, kp in r["kps"].items()}
    for i in kp_n:
        np.testing.assert_array_equal(kp_n_t[i], kp_n[i])
    ids = sorted(r["kps"])
    draws = record_jax_draws(monkeypatch)
    pj = jinc._chain_initialize(ids, r["matches"], kp_n, 200.0, jax.random.PRNGKey(0))
    assert not any(jax_best_repeats(d) for d in draws)
    left = replay_draws(monkeypatch, draws)
    pt = tinc._chain_initialize(ids, r["matches"], kp_n_t, 200.0, None, device=CPU)
    assert not left and list(pt) == list(pj)
    for i in pj:
        np.testing.assert_allclose(pt[i].R.numpy(), np.asarray(pj[i].R), atol=1e-4)
        np.testing.assert_allclose(pt[i].t.numpy(), np.asarray(pj[i].t), atol=1e-4)


def test_structure_guided_matches(small_rig):
    from pixtrack_tpu_torch.mapping.triangulate import build_tracks

    r = small_rig
    tracks = build_tracks(r["kps"], {(1, 2): r["matches"][(1, 2)], (2, 3): r["matches"][(2, 3)]})
    xyz = {t: r["X"][tr[0][1]] for t, tr in enumerate(tracks) if len(tr) == 3 and tr[0][1] == tr[1][1] == tr[2][1]}
    kp_ic = {i: kp.astype(np.float64) - 0.5 for i, kp in r["kps"].items()}
    cam_j = JCamera.from_colmap("PINHOLE", r["cam_rec"].params, 192, 192)
    cam_t = Camera.from_colmap("PINHOLE", r["cam_rec"].params, 192, 192)
    pj = {i: JPose.from_Rt(T.R.numpy(), T.t.numpy()) for i, T in r["poses"].items()}
    for descs in (r["descs"], {}):
        gj = jinc._structure_guided_matches(pj, cam_j, r["kps"], kp_ic, descs, tracks, xyz)
        gt = tinc._structure_guided_matches(r["poses"], cam_t, r["kps"], kp_ic, descs, tracks, xyz)
        assert sorted(gj) == sorted(gt)
        for p in gj:
            np.testing.assert_array_equal(gt[p], gj[p])
        assert sum(int((m >= 0).sum()) for m in gt.values()) > 300
    assert tinc._structure_guided_matches(r["poses"], cam_t, r["kps"], kp_ic, {}, tracks, {}) is None


# ----------------------------------------------------------- the mapper --
def arc_views(tmp: Path, n_views: int, res: int, step_deg: float, wobble: bool = True):
    """The JAX tests' partial arcs of the textured cube, rendered once by the
    port: ({id: image}, {id: (R, t)}, the PINHOLE record of each package)."""
    mesh = load_obj(make_cube_obj(tmp))
    camera = Camera.pinhole(res * 1.1, res * 1.1, (res - 1) / 2, (res - 1) / 2, res, res)
    views, truth = {}, {}
    for i in range(n_views):
        ang = np.deg2rad(step_deg) * i
        lift = 0.4 + 0.1 * np.sin(2 * ang) if wobble else 0.4
        T = look_at_w2c(0.9 * np.array([np.sin(ang), lift, np.cos(ang)]))
        views[i + 1] = render_mesh(mesh, T, camera)
        truth[i + 1] = (T.R.numpy().astype(np.float64), T.t.numpy().astype(np.float64))
    params = np.array([res * 1.1, res * 1.1, res / 2.0, res / 2.0])
    return (views, truth, jcolmap.CameraRecord(1, "PINHOLE", res, res, params),
            tcolmap.CameraRecord(1, "PINHOLE", res, res, params))


def test_smoke_worlds_cube_is_the_jax_fixture(tmp_path):
    """chip_smoke's cube (``smoke_worlds.make_cube_obj``, written by the
    port's PNG writer) and the JAX tests' (``make_cube_obj`` through
    cv2.imwrite, which takes the array as BGR): the same OBJ and MTL text
    and the same texture pixels as read back."""
    from pixtrack_tpu_torch.mapping.mesh_render import read_png
    from test_mesh_render import make_cube_obj as jax_cube

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    a, b = jax_cube(tmp_path / "jax"), make_cube_obj(tmp_path / "port")
    assert a.read_text() == b.read_text()
    assert (tmp_path / "jax" / "cube.mtl").read_text() == (tmp_path / "port" / "cube.mtl").read_text()
    np.testing.assert_array_equal(read_png(tmp_path / "port" / "tex.png"), read_png(tmp_path / "jax" / "tex.png"))
    assert load_obj(b)["vertices"].shape == (8, 3)


def run_both(views, jrec, trec, **kw):
    """JAX's mapper with its draws recorded, then the port's on them."""
    from pixtrack_tpu.mapping import featuremetric as jfm
    from pixtrack_tpu.sfm.scene import SceneModel as JScene

    with pytest.MonkeyPatch.context() as mp:
        draws = record_jax_draws(mp, port_rule=True)
        # JAX's point_adjustment on chunks of points (the same numbers; whole,
        # its double vmap materialises every feature map per point)
        mp.syspath_prepend(str(Path(__file__).resolve().parents[1] / "scripts_dev"))
        from refine_mesh_jax import chunked

        mp.setattr(jfm, "point_adjustment", chunked(jfm.point_adjustment, JScene))
        rec_j = jinc.incremental_sfm(views, jrec, **kw)
    stats = {"jax": len(draws)}
    with pytest.MonkeyPatch.context() as mp:
        replay_draws(mp, draws, stats)
        rec_t = tinc.incremental_sfm(views, trec, device=CPU, **kw)
    return rec_j, rec_t, stats


def _model(rec):
    ids = sorted(int(i) for i in rec.image_ids)
    R = np.stack([_quat_R(rec.images[i].qvec) for i in ids])
    t = np.stack([rec.images[i].tvec for i in ids])
    return ids, R, t, rec.xyz.astype(np.float64)


def _quat_R(q):
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat(np.roll(np.asarray(q, np.float64), -1)).as_matrix()


def _aligned(R, t, X, truth_ids, truth):
    """Camera centres and points mapped onto the truth's frame by the
    similarity that best aligns the centres (Umeyama)."""
    c = -np.einsum("pji,pj->pi", R, t)
    cg = np.stack([-truth[i][0].T @ truth[i][1] for i in truth_ids])
    mc, mg = c.mean(0), cg.mean(0)
    U, S, Vt = np.linalg.svd((cg - mg).T @ (c - mc))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    Ra = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((c - mc) ** 2).sum()
    return s * (c - mc) @ Ra.T + mg, s * (X - mc) @ Ra.T + mg


def _compare(rec_j, rec_t, truth):
    """The port's model against JAX's: registered views, rotations, aligned
    centres and points, counts. Returns the measured gaps."""
    from scipy.spatial import cKDTree

    ids_j, Rj, tj, Xj = _model(rec_j)
    ids_t, Rt, tt, Xt = _model(rec_t)
    assert ids_t == ids_j
    # the gauge: compare relative rotations to the first registered view
    rel_j = np.einsum("pij,kj->pik", Rj, Rj[0])
    rel_t = np.einsum("pij,kj->pik", Rt, Rt[0])
    rot = np.rad2deg(2 * np.arcsin(np.minimum(np.linalg.norm(rel_j - rel_t, axis=(1, 2)) / (2 * np.sqrt(2)), 1.0)))
    cj, Xja = _aligned(Rj, tj, Xj, ids_j, truth)
    ct, Xta = _aligned(Rt, tt, Xt, ids_t, truth)
    size = np.linalg.norm(Xja - Xja.mean(0), axis=1).max()
    cen = np.linalg.norm(cj - ct, axis=1).max() / size
    near = np.median(cKDTree(Xja).query(Xta)[0]) / size
    count = abs(len(Xt) - len(Xj)) / len(Xj)
    gaps = {"rot_deg": float(rot.max()), "centre": float(cen), "point_median": float(near), "count": count,
            "points": (len(Xj), len(Xt))}
    print("JAX vs port:", gaps)
    assert rot.max() < ROT_TOL_DEG, gaps
    assert cen < GAUGE_TOL and near < GAUGE_TOL, gaps
    assert count <= COUNT_TOL, gaps
    return gaps


def _gates(rec, truth, min_registered, min_points, pairwise_deg, global_deg, centre_frac, reproj_px):
    """tests/test_incremental_sfm.py::_check_rig_reconstruction's gates."""
    from chip_smoke import rig_outcome

    out = rig_outcome(rec, {f"view_{i:04d}.png": v for i, v in truth.items()})
    assert out["registered"] >= min_registered and out["points"] > min_points, out
    assert out["pairwise_deg"] < pairwise_deg and out["global_deg"] < global_deg, out
    assert out["centre_frac"] < centre_frac and out["reproj_px"] < reproj_px, out
    return out


@pytest.fixture(scope="module")
def partial_arc(tmp_path_factory):
    """test_reconstructs_partial_arc_fast's call: 6 views, 22-degree steps, 160 px."""
    views, truth, jrec, trec = arc_views(tmp_path_factory.mktemp("arc6"), 6, 160, 22.0)
    rec_j, rec_t, stats = run_both(views, jrec, trec, max_keypoints=512, nms_radius=1,
                                  match_kw=dict(min_score=0.5, ratio=0.98))
    return rec_j, rec_t, stats, truth


@pytest.fixture(scope="module")
def ka_arc(tmp_path_factory):
    """test_reconstruct_with_featuremetric_ka's call: 5 views, 17-degree
    steps, 144 px, KA and one featuremetric BA round."""
    views, truth, jrec, trec = arc_views(tmp_path_factory.mktemp("arc5"), 5, 144, 17.0, wobble=False)
    rec_j, rec_t, stats = run_both(views, jrec, trec, max_keypoints=448, nms_radius=1,
                                  match_kw=dict(min_score=0.5, ratio=0.98), featuremetric_ka=True,
                                  featuremetric_ba_rounds=1)
    return rec_j, rec_t, stats, truth


def test_mapper_partial_arc(partial_arc):
    rec_j, rec_t, stats, truth = partial_arc
    print("draws:", stats)
    _compare(rec_j, rec_t, truth)
    _gates(rec_t, truth, 5, 80, 5.0, 8.0, 0.25, 1.0)


def test_mapper_featuremetric_ka_arc(ka_arc):
    rec_j, rec_t, stats, truth = ka_arc
    print("draws:", stats)
    _compare(rec_j, rec_t, truth)
    assert len(rec_t.images) >= 4 and len(rec_t.points3D) > 20 and np.mean(rec_t.point_errors) < 2.0


def test_mapper_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = tcolmap.CameraRecord(1, "PINHOLE", 32, 32, np.array([30.0, 30.0, 16.0, 16.0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinc.incremental_sfm({1: np.zeros((32, 32, 3), np.uint8)}, rec)
