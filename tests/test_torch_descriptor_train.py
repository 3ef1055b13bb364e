"""Parity of the port's dense-descriptor trainer (``mapping/dense_descriptor.py``:
``build_descriptor_bank``, ``infonce_loss``, ``train_descriptor``) with the
JAX package on the CPU.

The JAX trainer draws each step's pair indices and photometric jitter from
its key tree; the tests rebuild those draws (``jax_step_draws``) and feed
them to the port. JAX's loss and gradient are read through its own
``train_descriptor`` with ``optax.adam`` swapped for ``optax.sgd(1.0)`` for
one step (parameters before less after = the gradient).

Tolerances:
- the bank at tests/test_dense_descriptor.py's sizes: images, pairs,
  keypoint validity and correspondence validity equal; keypoints and
  ``pos`` within 1e-4 px on 99.9 % of the entries and 5e-3 on all
  (measured: one keypoint of 3072 1.8e-3 px apart, the sub-pixel
  refinement's last bits, and two ``pos`` entries 6e-4);
- the InfoNCE loss and its gradient at JAX's parameters with JAX's draws,
  both packages in f64 with oneDNN off: the loss to 1e-7 relative (the
  images are uint8 / 255 in f32 in both, measured 4.6e-9), each
  gradient within 5e-5 of its leaf's largest entry (PR 10's rule);
- a 3-step f32 trajectory on JAX's draws: the parameters within 3e-4 on
  99.9 % of the entries and 2 lr a step on all (Adam's first steps are
  sign-like, so an entry whose gradient is near 0 may move by up to lr
  either way in each step; measured: 5.2e-5 at the 99.9 % quantile, 6.0e-4
  at most);
- tests/test_dense_descriptor.py's "the loss falls" gate on the port's own
  draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixtrack_tpu.mapping import dense_descriptor as jdd
from pixtrack_tpu_torch.mapping import dense_descriptor as tdd
from test_torch_feature_train import f64

torch.set_num_threads(2)
U, N = jax.random.uniform, jax.random.normal
CPU = "cpu"
BANK = tdd.DescBankConfig(n_scenes=2, n_views=6, res=160, max_kp=128, seed=321)
CFG = tdd.DescTrainConfig(n_steps=3, batch_pairs=4, log_every=1)


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    root = tmp_path_factory.mktemp("desc_bank")
    jbank = jdd.build_descriptor_bank(root / "jax", jdd.DescBankConfig(**BANK.__dict__))
    tbank = tdd.build_descriptor_bank(root / "port", BANK, device=CPU)
    return jbank, tbank


def test_bank_matches_jax(banks):
    jbank, tbank = banks
    assert sorted(jbank) == sorted(tbank)
    for k in ("pairs", "kvalid", "pvalid", "images"):
        np.testing.assert_array_equal(tbank[k], jbank[k], err_msg=k)
    for k in ("kp", "pos", "angle_deg"):
        err = np.abs(tbank[k] - jbank[k])
        assert err.max() <= 5e-3 and (err <= 1e-4).mean() >= 0.999, (k, err.max())
    assert tbank["pairs"].shape[0] >= 4


def jax_step_draws(key, n_pairs: int, batch: int, size: int):
    """One train step's draws from the step key, as the JAX step splits it."""
    k1, k2 = jax.random.split(key)
    keys = jax.random.split(k2, 2 * batch)
    parts = [jax.random.split(k, 3) for k in keys]
    return {"idx": jax.random.randint(k1, (batch,), 0, n_pairs),
            "gain": jnp.stack([U(a, ()) for a, _, _ in parts]), "bias": jnp.stack([U(b, ()) for _, b, _ in parts]),
            "noise": jnp.stack([N(c, (size, size, 3)) for _, _, c in parts])}


def jax_draws(cfg, n_pairs: int, size: int):
    """Every step's draws of ``train_descriptor`` called with ``params``."""
    key, out = jax.random.PRNGKey(cfg.seed), []
    for _ in range(cfg.n_steps):
        key, k = jax.random.split(key)
        out.append(jax_step_draws(k, n_pairs, cfg.batch_pairs, size))
    return out


def _t(d, dtype=torch.float32):
    return {k: torch.as_tensor(np.asarray(v)) if k == "idx" else torch.as_tensor(np.asarray(v)).to(dtype)
            for k, v in d.items()}


def _flat(params) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _jax_params(size):
    return jdd.DenseDescriptorNet().init(jax.random.PRNGKey(5), jnp.zeros((1, size, size, 3)))


def _port_net(params, tmp_path, dtype=torch.float32):
    np.savez(tmp_path / "desc.npz", **_flat(params))
    return tdd.load_descriptor_weights(tmp_path / "desc.npz", device=CPU).to(dtype)


def _flat_grads(params_before, params_after):
    b, a = _flat(params_before), _flat(params_after)
    return {k: b[k] - a[k] for k in b}


def test_infonce_loss_and_gradient_match_jax(banks, tmp_path, monkeypatch):
    jbank, _ = banks
    S, P = jbank["images"].shape[1], jbank["pairs"].shape[0]
    cfg = tdd.DescTrainConfig(n_steps=1, batch_pairs=2, log_every=1)
    with f64():
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), _jax_params(S))
        monkeypatch.setattr(optax, "adam", lambda lr: optax.sgd(1.0))
        after, info = jdd.train_descriptor(jbank, jdd.DescTrainConfig(**cfg.__dict__), params=params)
        draws = _t(jax_draws(cfg, P, S)[0], torch.float64)
        net = _port_net(params, tmp_path, torch.float64)
        with torch.backends.mkldnn.flags(enabled=False):
            loss = tdd.infonce_loss(net, tdd.bank_tensors(jbank, CPU), draws["idx"], cfg, draws)
            loss.backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss.detach()), info["history"][0][1], rtol=1e-7)
    grads = _flat_grads(params, after)
    for i, conv in enumerate(net.convs()):
        for leaf, g in (("kernel", conv.weight.grad.permute(2, 3, 1, 0)), ("bias", conv.bias.grad)):
            ref = grads[tdd._flax_key(i, leaf)]
            np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=5e-5 * np.abs(ref).max(), err_msg=(i, leaf))


def test_three_steps_match_jax(banks, tmp_path):
    jbank, _ = banks
    S, P = jbank["images"].shape[1], jbank["pairs"].shape[0]
    params = _jax_params(S)
    j_params, j_info = jdd.train_descriptor(jbank, jdd.DescTrainConfig(**CFG.__dict__), params=params)
    net = _port_net(params, tmp_path)
    net, t_info = tdd.train_descriptor(jbank, CFG, net=net, device=CPU, draws=[_t(d) for d in jax_draws(CFG, P, S)])
    assert [s for s, _ in t_info["history"]] == [s for s, _ in j_info["history"]] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in t_info["history"]], [v for _, v in j_info["history"]], rtol=1e-3)
    ref = _flat(j_params)
    for i, conv in enumerate(net.convs()):
        for leaf, p in (("kernel", conv.weight.detach().permute(2, 3, 1, 0)), ("bias", conv.bias.detach())):
            err = np.abs(p.numpy() - ref[tdd._flax_key(i, leaf)])
            assert np.quantile(err, 0.999) <= 3e-4 and err.max() <= 2 * CFG.lr * CFG.n_steps, (i, leaf, err.max())


def test_training_loss_falls(banks):
    """tests/test_dense_descriptor.py's gate on the port's own draws: 25
    steps of 4 pairs, the best of the last three logged losses below the
    first."""
    _, tbank = banks
    net, info = tdd.train_descriptor(tbank, tdd.DescTrainConfig(n_steps=25, batch_pairs=4, log_every=5), device=CPU)
    hist = [v for _, v in info["history"]]
    assert all(np.isfinite(hist))
    assert min(hist[-3:]) < hist[0], hist


def test_heldout_loss_without_jitter_is_deterministic(banks):
    """The held-out InfoNCE (no draws: no jitter) of chip_smoke phase 42 is
    a function of the net and the pairs alone."""
    _, tbank = banks
    net = tdd.init_descriptor(torch.Generator().manual_seed(0), device=CPU)
    bt = tdd.bank_tensors(tbank, CPU)
    idx = torch.arange(min(4, tbank["pairs"].shape[0]))
    with torch.no_grad():
        a, b = tdd.infonce_loss(net, bt, idx, CFG), tdd.infonce_loss(net, bt, idx, CFG)
    assert torch.isfinite(a) and float(a) == float(b) > 0
