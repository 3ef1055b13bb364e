"""Parity of the port's dense-distillation SuperPoint trainer
(``mapping/train_superpoint_dense.py``) with the JAX package's on the CPU:
the stability votes and the dense pair bank with JAX's homographies and
shape scenes fed through their hooks, the two losses, the batch on JAX's
draws, and the trainer's 3-step trajectory from JAX's initial parameters.

Tolerances, and the gaps measured:
- the bank (1 mesh scene x 3 views and 1 shape scene at 96 px, 2 warps):
  the pairs equal; the images within 1e-5 on 99.9 % of the pixels
  (measured 5.1e-6 on all: the renders are equal, the shape scenes are
  ``random_scene``'s and their warps); the correspondences within 1e-3 px
  and their validity equal on >= 99 % (measured 3.1e-5 px, all equal); the
  votes within 1e-6 on >= 99 % of the pixels and 2 / 3 on all (a truncated
  uint8 warp that flips one Harris response moves one of a pixel's three
  votes); measured: the votes equal, no vote moved (46,080 values, 5,359
  of them non-zero);
- ``stability_votes`` alone on a shape scene, 3 warps: as the bank's votes
  (measured: equal);
- ``dense_detector_loss`` and ``corr_descriptor_loss`` on the same inputs
  within 1e-6 relative; the dense target's cell order is ``cell_labels``'
  class index;
- ``make_dense_batch`` on JAX's draws: images within 1e-5 on 99.9 % of the
  pixels, votes, correspondences and validity equal;
- the trainer, 3 steps from JAX's ``init_superpoint`` parameters on JAX's
  draws, in f32 (JAX's step cannot run under x64): logged losses within
  1e-4 relative (measured 2.1e-7, 1.3e-6 and 2.2e-5: the third step's loss
  rises from 7.93 to 11.27 at lr 1e-3, where the first steps' parameter
  gaps show most), parameters within 0.05 lr on 99.9 % and 2 lr on all (the
  MagicPoint trainer's rule, ``test_torch_superpoint_train.py``; measured
  4.1e-3 lr on 99.9 %, 0.61 lr on all).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixtrack_tpu.mapping import superpoint as jsp
from pixtrack_tpu.mapping import train_superpoint as jts
from pixtrack_tpu.mapping import train_superpoint_dense as jtd
from pixtrack_tpu_torch.mapping import superpoint as tsp
from pixtrack_tpu_torch.mapping import train_superpoint as ts
from pixtrack_tpu_torch.mapping import train_superpoint_dense as td
from test_torch_superpoint_train import (
    LR,
    PARAM_ALL,
    PARAM_BULK,
    PARAM_SHARE,
    _flat,
    _t,
    assert_images_close,
    jax_homography_uniforms,
    jax_pair_draws,
    stack_draws,
)

torch.set_num_threads(2)
U, N = jax.random.uniform, jax.random.normal
CPU = "cpu"
RES = 96
BANK = dict(n_scenes=1, n_views=3, n_shape_scenes=1, res=RES, n_warps=2, max_deg=130.0, seed=2)
VOTE_TOL, VOTE_SHARE, VOTE_ALL = 1e-6, 0.99, 2.0 / 3.0
DENSE_LOSS_RTOL = 1e-4


def _pair_at(key: int) -> dict:
    return jax_pair_draws(jax.random.PRNGKey(key), jts.SPTrainConfig(size=RES, grid=5))


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """JAX's tiny dense pair bank and the port's, JAX's draws fed to the
    port's hooks."""
    j = jtd.build_dense_pair_bank(tmp_path_factory.mktemp("jbank"), **BANK)
    t = td.build_dense_pair_bank(tmp_path_factory.mktemp("tbank"), **BANK, device=CPU,
                                 homography_at=jax_homography_uniforms, pair_at=_pair_at)
    return j, t


def assert_votes_close(got, want):
    gap = np.abs(np.asarray(got) - np.asarray(want))
    assert (gap <= VOTE_TOL).mean() >= VOTE_SHARE, (gap > VOTE_TOL).mean()
    assert gap.max() <= VOTE_ALL + 1e-6, gap.max()


def test_dense_pair_bank_matches_jax(banks):
    j, t = banks
    np.testing.assert_array_equal(t["pairs"], j["pairs"])
    assert len(j["pairs"]) == 6 + 2
    for k in range(len(j["images"])):
        assert_images_close(t["images"][k], j["images"][k])
    np.testing.assert_allclose(t["corr"], j["corr"], rtol=0, atol=1e-3)
    assert (t["corr_valid"] == j["corr_valid"]).mean() >= 0.99
    assert j["corr_valid"].sum() >= 100
    assert_votes_close(t["votes"], j["votes"])
    assert (j["votes"] > 0).mean() > 0.05


def test_stability_votes_match_jax():
    img = np.asarray(jts.random_scene(jax.random.PRNGKey(4), jts.SPTrainConfig(size=RES, grid=5))[0])
    j = jtd.stability_votes(img, n_warps=3, seed=9)
    t = td.stability_votes(img, n_warps=3, seed=9, device=CPU, homography_at=jax_homography_uniforms)
    assert_votes_close(t, j)
    assert (j > 0).sum() > 100


def test_dense_losses_match_jax():
    rng = np.random.default_rng(0)
    B, S, D = 3, 64, 32
    Hc = S // 8
    logits = rng.normal(0, 3, (B, Hc, Hc, 65)).astype(np.float32)
    votes = np.clip(rng.uniform(-1, 1, (B, S, S)), 0, 1).astype(np.float32)
    j = float(jtd.dense_detector_loss(jnp.asarray(logits), jnp.asarray(votes), 0.5))
    np.testing.assert_allclose(float(td.dense_detector_loss(_t(logits), _t(votes), 0.5)), j, rtol=1e-6)

    cfg = jtd.SPDenseConfig(size=S)
    d0 = rng.normal(size=(B, Hc, Hc, D)).astype(np.float32)
    d1 = d0 + 0.5 * rng.normal(size=d0.shape).astype(np.float32)
    d0, d1 = (d / np.linalg.norm(d, axis=-1, keepdims=True) for d in (d0, d1))
    cen = (np.stack(np.meshgrid(np.arange(Hc), np.arange(Hc), indexing="ij")[::-1], -1).reshape(-1, 2) * 8.0 + 3.5)
    corr = (cen[None] + rng.normal(0, 4, (B, Hc * Hc, 2))).astype(np.float32)
    cvalid = rng.uniform(size=(B, Hc * Hc)) < 0.8
    j = np.asarray(jax.vmap(lambda a, b, c, v: jtd.corr_descriptor_loss(a, b, c, v, S, cfg))(
        jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(corr), jnp.asarray(cvalid)))
    t = td.corr_descriptor_loss(_t(d0), _t(d1), _t(corr), _t(cvalid), S, td.SPDenseConfig(size=S)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6)


def test_dense_target_cell_order_is_cell_labels_class():
    """One stable pixel per image: the dense loss's gradient at zero logits
    is most negative at ``cell_labels``' class of that pixel, in its cell."""
    S = 64
    pix = np.array([[13, 21], [60, 5], [0, 63], [7, 8]])  # (x, y)
    votes = torch.zeros(len(pix), S, S)
    votes[torch.arange(len(pix)), pix[:, 1], pix[:, 0]] = 1.0
    logits = torch.zeros(len(pix), S // 8, S // 8, 65, requires_grad=True)
    td.dense_detector_loss(logits, votes, 0.5).backward()
    lab = ts.cell_labels(torch.as_tensor(pix, dtype=torch.float32)[:, None], torch.ones(len(pix), 1, dtype=torch.bool),
                         S)
    for b, (x, y) in enumerate(pix):
        assert int(logits.grad[b, y // 8, x // 8].argmin()) == int(lab[b, y // 8, x // 8]) == (y % 8) * 8 + x % 8


def jax_dense_draws(key, cfg, n_pairs: int) -> dict:
    """``make_dense_batch``'s draws from its key."""
    out = []
    for k in jax.random.split(key, cfg.batch):
        k_i, k_a, k_b = jax.random.split(k, 3)
        views = [jax.random.split(kk, 3) for kk in (k_a, k_b)]
        out.append({"pair": _t(jax.random.randint(k_i, (), 0, n_pairs)).long(),
                    "gain": _t(jnp.stack([U(v[0], ()) for v in views])),
                    "bias": _t(jnp.stack([U(v[1], ()) for v in views])),
                    "noise": _t(jnp.stack([N(v[2], (cfg.size, cfg.size)) for v in views]))})
    return stack_draws(out)


def _jax_bank(bank):
    return (jnp.asarray(bank["images"]), jnp.asarray(bank["votes"]), jnp.asarray(bank["pairs"]),
            jnp.asarray(bank["corr"]), jnp.asarray(bank["corr_valid"]))


def test_make_dense_batch_matches_jax(banks):
    bank, _ = banks
    cfg = dict(size=RES, batch=3)
    key = jax.random.PRNGKey(3)
    j = [np.asarray(a) for a in jtd.make_dense_batch(key, jtd.SPDenseConfig(**cfg), _jax_bank(bank))]
    d = jax_dense_draws(key, jtd.SPDenseConfig(**cfg), len(bank["pairs"]))
    t = [a.numpy() for a in td.make_dense_batch(td.SPDenseConfig(**cfg), td.bank_tensors(bank, CPU), d)]
    for k in (0, 1):
        assert_images_close(t[k], j[k])
    for k in (2, 3, 4, 5):
        np.testing.assert_array_equal(t[k], j[k])


def test_dense_trainer_trajectory_matches_jax(banks):
    """3 steps from JAX's init parameters on JAX's draws, in f32."""
    bank, _ = banks
    cfg = dict(n_steps=3, batch=2, size=RES, log_every=1, lr=LR)
    jcfg = jtd.SPDenseConfig(**cfg)
    _, params = jsp.init_superpoint(jax.random.PRNGKey(jcfg.seed), RES, RES)
    _, j_params, j_info = jtd.train_superpoint_dense(jcfg, bank, params=params)
    draws, key = [], jax.random.PRNGKey(jcfg.seed + 1)
    for _ in range(3):
        k_data, key = jax.random.split(key)
        draws.append(jax_dense_draws(k_data, jcfg, len(bank["pairs"])))
    net = tsp.superpoint_from_flax(_flat(params), device=CPU)
    net, t_info = td.train_superpoint_dense(td.SPDenseConfig(**cfg), bank, net=net, device=CPU, draws=draws)
    assert [s for s, _ in t_info["history"]] == [s for s, _ in j_info["history"]] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in t_info["history"]], [v for _, v in j_info["history"]],
                               rtol=DENSE_LOSS_RTOL)
    want = tsp.superpoint_from_flax(_flat(j_params), device=CPU).state_dict()
    gap = torch.cat([(p - want[name]).abs().flatten() for name, p in net.state_dict().items()])
    assert (gap <= PARAM_BULK).double().mean() >= PARAM_SHARE, float((gap <= PARAM_BULK).double().mean())
    assert float(gap.max()) <= PARAM_ALL, float(gap.max())


def test_dense_training_loss_decreases(banks):
    _, bank = banks
    cfg = td.SPDenseConfig(n_steps=12, batch=2, size=RES, log_every=1)
    _, info = td.train_superpoint_dense(cfg, bank, device=CPU)
    hist = [v for _, v in info["history"]]
    assert all(np.isfinite(hist))
    assert min(hist[-4:]) < hist[0]
