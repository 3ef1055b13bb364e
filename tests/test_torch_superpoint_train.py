"""Parity of the port's MagicPoint trainer (``mapping/train_superpoint.py``)
with the JAX package's on the CPU: the scenes, homographies and warps on
JAX's draws (rebuilt from its key tree), the targets and losses, the texture
label bank with JAX's homographies fed through its hook, the trainer's
3-step trajectory from JAX's initial parameters on JAX's draws, the JAX
tests' own gates on the port's draws, and both repeatability gates.

Tolerances, and the gaps measured:
- ``random_scene`` and ``make_batch`` on JAX's draws: the validity flags and
  the labels equal; corners within 1e-4 px (measured 7.6e-6: sin/cos and the
  2 x 2 products' last bits at ~100 px); images within 1e-5 on >= 99.9 % of
  the pixels (measured: every pixel within 2.4e-7; a pixel over 1e-5 may
  only be one whose half-plane or ellipse test lies within 1e-4 px of its
  boundary, or within the blur's 3 px of one, and ``_flip_zone`` checks
  that, from the draws in f64); H within 1e-5 relative (measured 1.2e-7: the two LU solves);
  warps of one image under one H within 1e-5 (measured 8.8e-6: H^-1's last
  bits move the bilinear weights);
- the reused key: JAX's angle uniforms are the first n of its axes'
  flattened uniforms, and the port's angles are made from those;
- ``cell_labels`` equal to JAX's, with corners built to share cells (the
  last corner wins), off the image and invalid;
- the detector and descriptor losses on the same inputs within 1e-6
  relative;
- ``make_bank_batch`` on JAX's draws as ``make_batch``;
- ``build_texture_label_bank`` with JAX's homographies: the images within
  1e-6, every label within 1e-6 px of JAX's (the votes are integer counts
  at integer pixels; measured: the same labels);
- the trainer, 3 steps from JAX's ``init_superpoint`` parameters on JAX's
  draws, in f32 (JAX's step cannot run under x64: its blur kernel is f32):
  the logged losses within 1e-5 relative (measured 2.6e-6), the parameters
  within 0.05 lr on 99.9 % of the entries and 2 lr on all (measured 0.017
  lr and 1.15 lr; see LOSS_RTOL);
- ``repeatability`` (2 pairs) and ``mesh_repeatability`` (1 scene) of the
  candidate weights and of Harris: means within 0.02 of JAX's, each count
  within 1;
- JAX's initial parameters carried across (``superpoint_from_flax``) equal
  to the bit, saved by the port and read back by JAX's loader equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pixtrack_tpu.mapping import superpoint as jsp
from pixtrack_tpu.mapping import train_superpoint as jts
from pixtrack_tpu_torch.mapping import superpoint as tsp
from pixtrack_tpu_torch.mapping import train_superpoint as ts

torch.set_num_threads(2)
U, N = jax.random.uniform, jax.random.normal
CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
CANDIDATE = REPO / "assets" / "superpoint_candidate.npz"
SMALL = dict(size=64, grid=2, batch=2, bank_batch=2)
IMG_TOL, IMG_SHARE = 1e-5, 0.999
# The 3-step f32 trajectory. Measured: the first loss equal, the second and
# third 1.4e-6 and 2.6e-6 relative apart; parameters within 1.7e-5 = 0.017
# lr on 99.9 % of the 1,300,865 entries and 1.15e-3 = 1.15 lr on all (after
# one step: 1.3e-5 on all, 111 entries over 1e-6). Adam's first steps are
# ~lr * sign(g), so an entry whose f32 gradient is near 0 (sum-order noise)
# takes a step of the other sign or size.
LR = 1e-3
LOSS_RTOL, PARAM_BULK, PARAM_SHARE, PARAM_ALL = 1e-5, 5e-2 * LR, 0.999, 2 * LR


def _t(x):
    return torch.as_tensor(np.array(x))


def jax_scene_draws(key, cfg) -> dict:
    """``random_scene``'s draws from its key, as the JAX function splits it
    (the angles' key is the axes' key: the port takes their uniforms from
    ``ell``)."""
    n = cfg.grid ** 2
    k_ang, _, k_typ, k_gray, k_bg, k_noise, k_ell, k_blur, k_keep = jax.random.split(key, 9)
    k_wh, k_sh, k_rot = jax.random.split(k_ang, 3)
    k_frac, k_bern = jax.random.split(k_keep)
    k_sign, k_mag = jax.random.split(k_gray)
    d = {"wh": U(k_wh, (n, 2)), "shear": U(k_sh, (n,)), "rot": U(k_rot, (n,)), "type": U(k_typ, (n,)),
         "ell": U(k_ell, (n, 2)), "keep_frac": U(k_frac, ()), "keep": U(k_bern, (n,)), "bg": U(k_bg, ()),
         "sign": U(k_sign, (n,)), "mag": U(k_mag, (n,)), "amp": U(k_blur, ()),
         "noise": N(k_noise, (cfg.size, cfg.size))}
    return {k: _t(v) for k, v in d.items()}


def jax_pair_draws(key, cfg) -> dict:
    """A pair's draws: the JAX package splits its key into the scene's and
    the homography's."""
    k_s, k_h = jax.random.split(key)
    return {"scene": jax_scene_draws(k_s, cfg), "homography": _t(U(k_h, (4, 2)))}


def stack_draws(draws: list):
    """A list of draws (nested dicts of tensors) stacked along a new axis 0."""
    if isinstance(draws[0], dict):
        return {k: stack_draws([d[k] for d in draws]) for k in draws[0]}
    return torch.stack(draws)


def jax_batch_draws(key, cfg) -> dict:
    return stack_draws([jax_pair_draws(k, cfg) for k in jax.random.split(key, cfg.batch)])


def jax_bank_draws(key, cfg, n_images: int, res: int) -> dict:
    """``make_bank_batch``'s draws from its key."""
    out = []
    for k in jax.random.split(key, cfg.bank_batch):
        k_i, k_c, k_b, k_n, k_h = jax.random.split(k, 5)
        k_g, k_o = jax.random.split(k_b)
        out.append({"index": _t(jax.random.randint(k_i, (), 0, n_images)).long(),
                    "offset": _t(jax.random.randint(k_c, (2,), 0, res - cfg.size + 1)).long(),
                    "gain": _t(U(k_g, ())), "bias": _t(U(k_o, ())), "noise": _t(N(k_n, (cfg.size, cfg.size))),
                    "homography": _t(U(k_h, (4, 2)))})
    return stack_draws(out)


def jax_homography_uniforms(key_int: int):
    """The corner uniforms of ``random_homography(PRNGKey(key_int), ...)``."""
    return _t(U(jax.random.PRNGKey(key_int), (4, 2)))


def _flip_zone(d, cfg, size, radius=3, tol=1e-4):
    """Pixels within ``radius`` (the blur's) of a pixel centre whose shape
    test a last bit can flip: within ``tol`` px of a drawn quad's edge line
    or of a drawn ellipse's boundary. From the scene's draws ``d`` in f64,
    every slot's quad and ellipse (a slot's type and keep draw only pick
    one of them)."""
    import scipy.ndimage as ndi

    n, cell = cfg.grid ** 2, size / cfg.grid
    dd = {k: np.asarray(v, np.float64) for k, v in d.items()}
    wh = 0.40 * cell + dd["wh"] * 0.22 * cell
    sh = -0.15 * cell + dd["shear"] * 0.30 * cell
    phi, th = dd["rot"] * np.pi, dd["ell"].ravel()[:n] * np.pi
    ab = 0.18 * cell + dd["ell"] * 0.24 * cell
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    near = np.zeros((size, size), bool)
    square = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
    for q in range(n):
        c = np.array([(q % cfg.grid + 0.5) * cell, (q // cfg.grid + 0.5) * cell])
        rot = np.array([[np.cos(phi[q]), -np.sin(phi[q])], [np.sin(phi[q]), np.cos(phi[q])]])
        v = c + square @ (rot @ np.array([[wh[q, 0], sh[q]], [0.0, wh[q, 1]]])).T
        for a, b in zip(v, np.roll(v, -1, axis=0)):
            e = b - a
            near |= np.abs(e[0] * (yy - a[1]) - e[1] * (xx - a[0])) / np.linalg.norm(e) < tol
        u = np.cos(th[q]) * (xx - c[0]) + np.sin(th[q]) * (yy - c[1])
        w = -np.sin(th[q]) * (xx - c[0]) + np.cos(th[q]) * (yy - c[1])
        f = np.sqrt((u / ab[q, 0]) ** 2 + (w / ab[q, 1]) ** 2)
        near |= np.abs(f - 1.0) * ab[q].min() < tol
    return ndi.binary_dilation(near, iterations=radius)


def assert_images_close(got, want, zone=None):
    """Within IMG_TOL on IMG_SHARE of the pixels; given a flip zone
    (``_flip_zone``), every pixel beyond it inside the zone."""
    gap = np.abs(np.asarray(got) - np.asarray(want))
    assert (gap <= IMG_TOL).mean() >= IMG_SHARE, gap.max()
    if zone is not None:
        assert not (gap > IMG_TOL)[~zone].any(), np.argwhere((gap > IMG_TOL) & ~zone)[:5]


def test_reused_key_is_kept():
    """JAX draws the ellipses' angles from their axes' key: the angles'
    uniforms are the first n of the axes' flattened ones. The port makes its
    angles from those (an ellipse-only scene compares equal below)."""
    cfg = jts.SPTrainConfig(size=64, grid=2, p_ellipse=1.0)
    key = jax.random.PRNGKey(5)
    k_ell = jax.random.split(jax.random.split(key)[0], 9)[6]
    np.testing.assert_array_equal(np.asarray(U(k_ell, (4,))), np.asarray(U(k_ell, (4, 2))).ravel()[:4])
    d = jax_scene_draws(jax.random.split(key)[0], cfg)
    img, _, valid = ts.random_scene(d, ts.SPTrainConfig(size=64, grid=2, p_ellipse=1.0))
    j_img, _, j_valid = jts.random_scene(jax.random.split(key)[0], cfg)
    assert not valid.any() and not np.asarray(j_valid).any()
    assert_images_close(img.numpy(), j_img)


@pytest.mark.parametrize("size,grid,p_drop_max,seed", [(64, 2, 0.0, 0), (120, 5, 0.7, 2)])
def test_scene_homography_and_warp_match_jax(size, grid, p_drop_max, seed):
    jcfg = jts.SPTrainConfig(size=size, grid=grid, p_drop_max=p_drop_max)
    tcfg = ts.SPTrainConfig(size=size, grid=grid, p_drop_max=p_drop_max)
    k_s, k_h = jax.random.split(jax.random.PRNGKey(seed))
    j_img, j_c, j_v = (np.asarray(a) for a in jts.random_scene(k_s, jcfg))
    d = jax_scene_draws(k_s, jcfg)
    img, c, v = ts.random_scene(d, tcfg)
    np.testing.assert_array_equal(v.numpy(), j_v)
    assert j_v.sum() >= 4
    np.testing.assert_allclose(c.numpy(), j_c, rtol=0, atol=1e-4)
    zone = _flip_zone(d, jcfg, size)
    assert zone.mean() < 0.5
    assert_images_close(img.numpy(), j_img, zone)

    j_H = np.asarray(jts.random_homography(k_h, size, jcfg.max_warp))
    H = ts.random_homography(_t(U(k_h, (4, 2))), size, tcfg.max_warp)
    np.testing.assert_allclose(H.numpy(), j_H, rtol=0, atol=1e-5 * np.abs(j_H).max())
    pts = np.asarray(j_c)
    np.testing.assert_allclose(ts.apply_homography(_t(j_H), _t(pts)).numpy(),
                               np.asarray(jts.apply_homography(jnp.asarray(j_H), jnp.asarray(pts))), atol=1e-4)
    j_w = np.asarray(jts.warp_image(jnp.asarray(j_img), jnp.asarray(j_H)))
    assert_images_close(ts.warp_image(_t(j_img), _t(j_H)).numpy(), j_w)


def test_make_batch_matches_jax():
    jcfg, tcfg = jts.SPTrainConfig(**SMALL), ts.SPTrainConfig(**SMALL)
    key = jax.random.PRNGKey(7)
    j = [np.asarray(a) for a in jts.make_batch(key, jcfg)]
    t = [a.numpy() for a in ts.make_batch(tcfg, jax_batch_draws(key, jcfg))]
    for k in (2, 3):
        np.testing.assert_array_equal(t[k], j[k])
    assert (j[2] < 64).sum() >= 4
    np.testing.assert_allclose(t[4], j[4], rtol=0, atol=1e-5 * np.abs(j[4]).max())
    for k in (0, 1):
        assert_images_close(t[k], j[k])


def test_cell_labels_match_jax_with_shared_cells():
    """Corners built to share cells (the later one wins in both), corners
    off the image (negative, at size, rounding up to size) and invalid
    rows, batched."""
    size = 64
    rng = np.random.default_rng(0)
    base = rng.uniform(2, 60, (6, 24, 2)).astype(np.float32)
    base[:, 1] = base[:, 0] + 0.7          # the same cell as row 0, mostly
    base[:, 2] = base[:, 0] - 0.3
    base[:, 3] = [-0.6, 5.0]               # rounds to -1: off the image
    base[:, 4] = [63.5, 10.0]              # rounds (half to even) to 64: off
    base[:, 5] = [62.5, 10.0]              # rounds to 62: on
    base[:, 6] = [8.5, 7.5]                # 8 and 8 (half to even)
    base[:, 7] = [9.0, 8.0]                # the same cell as row 6
    valid = rng.uniform(size=(6, 24)) < 0.8
    valid[:, :8] = True
    valid[1, 1] = False                    # an invalid row in a shared cell
    j = np.stack([np.asarray(jts.cell_labels(jnp.asarray(b), jnp.asarray(v), size)) for b, v in zip(base, valid)])
    t = ts.cell_labels(_t(base), _t(valid), size).numpy()
    np.testing.assert_array_equal(t, j)
    assert t[0, 1, 1] == 0 * 8 + 1         # row 7 (9, 8) wins its cell over row 6 (8, 8)
    assert (t[0] < 64).sum() >= 10


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    B, Hc, D = 3, 8, 32
    logits = rng.normal(0, 3, (B, Hc, Hc, 65)).astype(np.float32)
    labels = rng.integers(0, 65, (B, Hc, Hc)).astype(np.int32)
    j = float(jts.detector_loss(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(float(ts.detector_loss(_t(logits), _t(labels).long())), j, rtol=1e-6)

    cfg = jts.SPTrainConfig(size=64)
    d0 = rng.normal(size=(B, Hc, Hc, D)).astype(np.float32)
    d1 = d0 + 0.5 * rng.normal(size=d0.shape).astype(np.float32)
    d0, d1 = (d / np.linalg.norm(d, axis=-1, keepdims=True) for d in (d0, d1))
    Hs = np.stack([np.asarray(jts.random_homography(jax.random.PRNGKey(s), 64, 0.15)) for s in range(B)])
    j = np.asarray(jax.vmap(lambda a, b, h: jts.descriptor_loss(a, b, h, 64, cfg))(
        jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(Hs)))
    t = ts.descriptor_loss(_t(d0), _t(d1), _t(Hs), 64, ts.SPTrainConfig(size=64)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6)


@pytest.fixture(scope="module")
def texture_banks():
    """JAX's tiny texture label bank and the port's, JAX's homographies fed
    to the port: 1 scene x 2 views at 96 px, 2 warps."""
    kw = dict(n_scenes=1, res=96, n_views=2, n_warps=2, max_keypoints=48, seed=3)
    return jts.build_texture_label_bank(**kw), ts.build_texture_label_bank(
        **kw, device=CPU, homography_at=jax_homography_uniforms)


def test_texture_label_bank_matches_jax(texture_banks):
    j, t = texture_banks
    np.testing.assert_allclose(t["images"], j["images"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t["valid"], j["valid"])
    assert j["valid"].sum() >= 20
    np.testing.assert_allclose(t["keypoints"], j["keypoints"], rtol=0, atol=1e-6)


def test_make_bank_batch_matches_jax(texture_banks):
    bank, _ = texture_banks
    jcfg, tcfg = jts.SPTrainConfig(**SMALL), ts.SPTrainConfig(**SMALL)
    key = jax.random.PRNGKey(11)
    j = [np.asarray(a) for a in jts.make_bank_batch(key, jcfg, bank["images"], bank["keypoints"], bank["valid"])]
    d = jax_bank_draws(key, jcfg, *bank["images"].shape[:2])
    t = [a.numpy() for a in ts.make_bank_batch(tcfg, ts.bank_tensors(bank, CPU), d)]
    for k in (2, 3):
        np.testing.assert_array_equal(t[k], j[k])
    assert (j[2] < 64).sum() >= 3
    np.testing.assert_allclose(t[4], j[4], rtol=0, atol=1e-5 * np.abs(j[4]).max())
    for k in (0, 1):
        assert_images_close(t[k], j[k])


def _flat(params) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(jax.tree_util.tree_map(np.asarray, params)).items()}


def test_trainer_trajectory_matches_jax(texture_banks):
    """3 steps from JAX's init parameters on JAX's draws (a synthetic batch
    and a bank batch a step), in f32."""
    bank, _ = texture_banks
    cfg = dict(n_steps=3, log_every=1, lr=LR, **SMALL)
    jcfg = jts.SPTrainConfig(**cfg)
    _, params = jsp.init_superpoint(jax.random.PRNGKey(jcfg.seed), 64, 64)
    _, j_params, j_info = jts.train_superpoint(jcfg, params=params, bank=bank)
    draws, key = [], jax.random.PRNGKey(jcfg.seed + 1)
    for _ in range(3):
        k_data, k_bank, key = jax.random.split(key, 3)
        draws.append({"batch": jax_batch_draws(k_data, jcfg),
                      "bank": jax_bank_draws(k_bank, jcfg, *bank["images"].shape[:2])})
    net = tsp.superpoint_from_flax(_flat(params), device=CPU)
    net, t_info = ts.train_superpoint(ts.SPTrainConfig(**cfg), net=net, bank=bank, device=CPU, draws=draws)
    assert [s for s, _ in t_info["history"]] == [s for s, _ in j_info["history"]] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in t_info["history"]], [v for _, v in j_info["history"]],
                               rtol=LOSS_RTOL)
    want = tsp.superpoint_from_flax(_flat(j_params), device=CPU).state_dict()
    gap = torch.cat([(p - want[name]).abs().flatten() for name, p in net.state_dict().items()])
    assert (gap <= PARAM_BULK).double().mean() >= PARAM_SHARE, float((gap <= PARAM_BULK).double().mean())
    assert float(gap.max()) <= PARAM_ALL, float(gap.max())


def test_weights_carry_across_and_back(tmp_path):
    _, params = jsp.init_superpoint(jax.random.PRNGKey(0), 64, 64)
    flat = _flat(params)
    net = tsp.superpoint_from_flax(flat, device=CPU)
    tsp.save_superpoint_weights(tmp_path / "sp.npz", net)
    back = _flat(jts.load_superpoint_weights(tmp_path / "sp.npz"))
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(ValueError):
        tsp.superpoint_from_flax({**flat, "params/extra/kernel": flat[next(iter(flat))]}, device=CPU)


# --- the JAX tests' own gates (tests/test_superpoint.py) on the port's draws ---
def test_corners_land_on_intensity_edges():
    cfg = ts.SPTrainConfig(size=120, noise=0.0)
    img, corners, valid = ts.random_scene(ts.scene_draws(cfg, (), torch.Generator().manual_seed(0)), cfg)
    img = img.numpy()
    mag = np.hypot(*np.gradient(img))
    med = np.median(mag)
    hits = 0
    for (x, y), v in zip(corners.numpy(), valid.numpy()):
        xi, yi = int(round(x)), int(round(y))
        if v and 2 <= xi < 118 and 2 <= yi < 118:
            hits += mag[yi - 2: yi + 3, xi - 2: xi + 3].max() > 4 * med
    n_valid = int(valid.sum())
    assert n_valid >= 8
    assert hits >= 0.9 * n_valid


def test_ellipse_slots_contribute_no_corners():
    cfg = ts.SPTrainConfig(size=120, p_ellipse=1.0)
    _, _, valid = ts.random_scene(ts.scene_draws(cfg, (4,), torch.Generator().manual_seed(1)), cfg)
    assert not valid.any()


def test_descriptor_loss_prefers_true_correspondence():
    cfg = ts.SPTrainConfig(size=64)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 32)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ident = torch.eye(3)
    good = ts.descriptor_loss(_t(d.reshape(8, 8, 32)), _t(d.reshape(8, 8, 32)), ident, 64, cfg)
    bad = ts.descriptor_loss(_t(d.reshape(8, 8, 32)), _t(d[rng.permutation(64)].reshape(8, 8, 32)), ident, 64, cfg)
    assert float(good) < float(bad)


def test_training_loss_decreases():
    cfg = ts.SPTrainConfig(n_steps=12, batch=2, size=64, grid=2, log_every=1, seed=0)
    _, info = ts.train_superpoint(cfg, device=CPU)
    hist = [v for _, v in info["history"]]
    assert all(np.isfinite(hist))
    assert min(hist[-4:]) < hist[0]


# --- the gates against JAX's, candidate weights and Harris ---
@pytest.fixture(scope="module")
def candidate():
    return jts.load_superpoint_weights(CANDIDATE), tsp.load_superpoint_weights(CANDIDATE, device=CPU)


@pytest.mark.parametrize("detector", ["superpoint", "harris"])
def test_repeatability_matches_jax(candidate, detector):
    jp, net = candidate if detector == "superpoint" else (None, None)
    j_rep, j_counts = jts.repeatability(jp, n_pairs=2, detector=detector)
    cfg = jts.SPTrainConfig(size=120, max_warp=0.12, grid=5)
    draws = stack_draws([jax_pair_draws(jax.random.PRNGKey(77 + s), cfg) for s in range(2)])
    rep, counts = ts.repeatability(net, n_pairs=2, detector=detector, draws=draws, device=CPU)
    assert abs(rep - j_rep) <= 0.02, (rep, j_rep)
    assert len(counts) == 2 and all(abs(a - b) <= 1 for a, b in zip(counts, j_counts)), (counts, j_counts)
    assert sum(j_counts) > 0


@pytest.mark.parametrize("detector", ["superpoint", "harris"])
def test_mesh_repeatability_matches_jax(candidate, detector):
    jp, net = candidate if detector == "superpoint" else (None, None)
    j_rep, j_counts = jts.mesh_repeatability(jp, n_scenes=1, detector=detector)
    rep, counts = ts.mesh_repeatability(net, n_scenes=1, detector=detector, device=CPU)
    assert abs(rep - j_rep) <= 0.02, (rep, j_rep)
    assert abs(counts[0] - j_counts[0]) <= 1, (counts, j_counts)
    assert j_counts[0] > 0
