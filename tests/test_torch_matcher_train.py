"""Parity of the port's matcher trainers (``mapping/train_matcher.py``:
``make_pair``, ``make_batch``, ``matcher_loss``, ``assignment_nll``,
``train_matcher``, ``train_matcher_on_bank``) and of the optimiser pieces
they use (``nerf/optim.py``) with the JAX package and optax on the CPU.

Tolerances:
- ``make_batch`` on JAX's draws (rebuilt from its key tree): the planted
  validity equal, normalised keypoints within 1e-5, descriptors within 1e-4
  (the textures' sines of f32 phases up to 2 pi * 40 cycles part in their
  last bits between the packages);
- ``matcher_loss`` and ``assignment_nll`` on the same log-probs: 1e-6
  relative;
- the schedule within 1e-7 of optax's value (both in f32), the clip and
  Adam's parameters within 1e-6 of optax's at every step;
- ``train_matcher_on_bank``'s host path for 3 steps, both packages in f64
  on the same numpy draws: logged losses and the held-out NLL to 1e-9
  relative, parameters within 1e-8 = lr * 1e-5 (measured: 1.9e-9 on 2 of
  27,040 entries, where a gradient that sums to near 0 carries the f64
  sum order's relative error into Adam's normalised step; the schedule is
  f32 in the port and f64 in JAX under x64, 6e-8 of lr apart);
- the device-resident path's bank and batch against the host path's at
  the same pairs and draws, and one step's loss and gradient on each: the
  tolerances at KP_ATOL below, with the measured gaps;
- the JAX tests' "the loss falls" gates (tests/test_attention_matcher.py)
  on the port's own draws, and the device-resident path's held-out NLL
  finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixtrack_tpu.mapping import attention_matcher as jam
from pixtrack_tpu.mapping import train_matcher as jtm
from pixtrack_tpu_torch.mapping import attention_matcher as tam
from pixtrack_tpu_torch.mapping import train_matcher as tm
from pixtrack_tpu_torch.nerf.optim import Adam, clip_by_global_norm, matcher_schedule
from test_torch_feature_train import f64

torch.set_num_threads(2)
U, N = jax.random.uniform, jax.random.normal
CPU = "cpu"
SMALL = dict(batch=2, size=96, tex_size=96, n_match=24, n_distract=8)
# the device-resident batch against the host path's (measured: keypoints
# 8.9e-8, descriptors 5.3e-5, loss 6.7e-7 relative, gradients 2.4e-5 of a
# leaf's largest entry outside the attention keys' biases, whose gradient is
# 0 by the softmax's shift invariance and ~1e-9 of noise; one pair's ground
# truth given to another moves the loss by 1.2 %)
KP_ATOL, LOSS_RTOL, GRAD_REL = 1e-6, 1e-5, 1e-4
DESC_F16_ATOL = 2.5e-4  # half of f16's spacing at 1.0: a unit descriptor's entries, rounded once


def jax_pair_draws(key, cfg):
    """``make_pair``'s draws from its key, as the JAX function splits it."""
    k_tex, k_p0, k_r0, k_rel, k_pts, k_d0, k_d1, k_j = jax.random.split(key, 8)
    kf, ka, kp = jax.random.split(k_tex, 3)
    return {"texture": {"freqs": U(kf, (3, 48, 2)), "amps": N(ka, (3, 48)), "phases": U(kp, (3, 48))},
            "pose": jnp.stack([U(k, ()) for k in jax.random.split(k_p0, 3)]), "roll": U(k_r0, ()),
            "rel": U(k_rel, ()), "rel_dir": N(k_rel, (6,)), "points": U(k_pts, (cfg.n_match, 2)),
            "d0": U(k_d0, (cfg.n_distract, 2)), "d1": U(k_d1, (cfg.n_distract, 2)),
            "jitter": N(k_j, (2, cfg.n_match, 2))}


def jax_batch_draws(key, cfg):
    pairs = [jax_pair_draws(k, cfg) for k in jax.random.split(key, cfg.batch)]
    return jax.tree_util.tree_map(lambda *a: torch.as_tensor(np.asarray(jnp.stack(a))), *pairs)


def test_reused_key_is_kept():
    """The direction's first normal is the normal of the magnitude's uniform
    (JAX draws both from ``k_rel``); ``pair_draws`` keeps that."""
    from pixtrack_tpu_torch._draws import _normal_of_uniform

    k = jax.random.PRNGKey(11)
    np.testing.assert_allclose(float(_normal_of_uniform(torch.tensor(float(U(k, ()))))), float(N(k, (6,))[0]),
                               rtol=1e-6)
    d = tm.pair_draws(tm.MatcherTrainConfig(**SMALL), (3,), torch.Generator().manual_seed(0), CPU)
    torch.testing.assert_close(d["rel_dir"][:, 0], _normal_of_uniform(d["rel"]))


def test_make_batch_matches_jax():
    cfg = tm.MatcherTrainConfig(**SMALL)
    key = jax.random.PRNGKey(3)
    j = jtm.make_batch(key, jtm.MatcherTrainConfig(**SMALL))
    t = tm.make_batch(cfg, jax_batch_draws(key, cfg))
    de0, kn0, de1, kn1, vm = (np.asarray(a) for a in j)
    np.testing.assert_array_equal(t[4].numpy(), vm)
    assert vm.sum() > 10
    np.testing.assert_allclose(t[1].numpy(), kn0, atol=1e-5)
    np.testing.assert_allclose(t[3].numpy(), kn1, atol=1e-5)
    np.testing.assert_allclose(t[0].numpy(), de0, atol=1e-4)
    np.testing.assert_allclose(t[2].numpy(), de1, atol=1e-4)


def _logp(rng, B, N0, N1):
    scores = rng.normal(0, 3, (B, N0 + 1, N1 + 1)).astype(np.float32)
    return np.asarray(jam.assignment_log_probs(jnp.asarray(scores)))


def test_matcher_loss_matches_jax():
    rng = np.random.default_rng(0)
    n_match, n_total = 10, 14
    logp = _logp(rng, 3, n_total, n_total)
    vm = rng.uniform(size=(3, n_match)) < 0.7
    j = float(jtm.matcher_loss(jnp.asarray(logp), jnp.asarray(vm), n_match, n_total))
    t = float(tm.matcher_loss(torch.as_tensor(logp), torch.as_tensor(vm), n_match, n_total))
    np.testing.assert_allclose(t, j, rtol=1e-6)


def _fixture():
    """tests/test_attention_matcher.py:110-138's assignment and its shuffle."""
    rng = np.random.default_rng(0)
    N0, N1 = 12, 10
    gt = np.full(N0, -1, np.int32)
    gt[:7] = rng.permutation(N1)[:7]
    valid0 = np.ones(N0, bool)
    valid0[-2:] = False
    valid1 = np.ones(N1, bool)
    scores = np.full((N0 + 1, N1 + 1), -4.0, np.float32)
    for i, j in enumerate(gt):
        if j >= 0:
            scores[i, j] = 6.0
    scores[7:, N1] = 6.0
    logp = np.asarray(jam.assignment_log_probs(jnp.asarray(scores)[None])[0])
    bad = gt.copy()
    bad[:7] = np.roll(gt[:7], 1)
    return logp, gt, bad, valid0, valid1


def test_assignment_nll_matches_jax():
    """On the JAX test's fixture (the ground truth scores lower than its
    shuffle) and on random log-probs whose ground truth points at keypoint 0
    too (where JAX's scatter writes the unmatched rows' False last)."""
    logp, gt, bad, v0, v1 = _fixture()
    vals = []
    for g in (gt, bad):
        j = float(jtm.assignment_nll(jnp.asarray(logp), jnp.asarray(g), jnp.asarray(v0), jnp.asarray(v1)))
        t = float(tm.assignment_nll(torch.as_tensor(logp), torch.as_tensor(g), torch.as_tensor(v0), torch.as_tensor(v1)))
        np.testing.assert_allclose(t, j, rtol=1e-6)
        vals.append(t)
    assert vals[0] < vals[1]

    rng = np.random.default_rng(1)
    B, N0, N1 = 4, 16, 12
    logp = _logp(rng, B, N0, N1)
    gt = np.stack([np.where(rng.uniform(size=N0) < 0.6, rng.permutation(16)[:N0] % N1, -1) for _ in range(B)])
    gt = np.stack([np.where(np.arange(N0) == 3, 0, np.where(g == 0, -1, g)) for g in gt]).astype(np.int32)
    v0, v1 = rng.uniform(size=(B, N0)) < 0.9, rng.uniform(size=(B, N1)) < 0.9
    j = np.asarray(jax.vmap(jtm.assignment_nll)(jnp.asarray(logp), jnp.asarray(gt), jnp.asarray(v0),
                                                jnp.asarray(v1)))
    t = tm.assignment_nll(torch.as_tensor(logp), torch.as_tensor(gt), torch.as_tensor(v0), torch.as_tensor(v1))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6)


@pytest.mark.parametrize("n_steps", [300, 2000])
def test_schedule_clip_and_adam_match_optax(n_steps):
    lr = 2e-4
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, min(200, n_steps // 10), n_steps, 0.05 * lr)
    sched = matcher_schedule(lr, n_steps)
    for k in list(range(0, 40)) + list(range(190, 215)) + [n_steps // 2, n_steps - 1, n_steps, n_steps + 5]:
        np.testing.assert_allclose(sched(k), float(ref(k)), rtol=0, atol=1e-7 * lr, err_msg=k)

    rng = np.random.default_rng(2)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(ref))
    state = opt.init(params)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    adam = Adam(tp, sched)
    for step in range(25):
        scale = 0.05 if step % 2 else 5.0  # below and above the clip
        grads = [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
        upd, state = opt.update([jnp.asarray(g) for g in grads], state, params)
        params = optax.apply_updates(params, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.tensor(g)
        clip_by_global_norm(tp, 1.0)
        adam.step()
        for a, b in zip(tp, params):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=step)


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    """tests/test_attention_matcher.py's tiny mesh-pair bank, built by the port."""
    return tm.build_mesh_pair_bank(tmp_path_factory.mktemp("mbank"), n_scenes=1, n_views=6, res=128, max_kp=96,
                                   min_deg=8.0, max_deg=75.0, device=CPU)


def _replayed_draws(cfg, idx, shape, seed):
    """``device_draws``' dict holding the draws that ``bank_batch`` takes
    from ``default_rng(seed)``, in its order: the rolls, then unit normals
    for the descriptor noise (numpy's normal(0, s) is s times the same
    unit normal)."""
    rng = np.random.default_rng(seed)
    th = [rng.uniform(-np.pi, np.pi, cfg.batch) for _ in range(2)]
    n = [rng.normal(0.0, 1.0, shape) for _ in range(2)]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return {"idx": torch.as_tensor(idx), "th0": f32(th[0]), "th1": f32(th[1]), "n0": f32(n[0]), "n1": f32(n[1])}


def test_device_resident_batch_and_step_match_the_host_path(bank):
    """The device-resident path's bank and batch (``upload_bank``,
    ``device_batch``) against the host path's (``bank_batch``) at the same
    pairs of a training split and the same draws, then one step's loss and
    gradient on each: a pair's descriptors, keypoints, validity and
    ground truth must stay together through the upload and the sampling."""
    cfg = tm.MatcherTrainConfig(batch=4)
    host = {k: np.asarray(v) for k, v in bank.items()}
    tr = np.random.default_rng(0).permutation(host["gt"].shape[0])[1:]
    idx = np.random.default_rng(1).integers(0, len(tr), cfg.batch)
    want = tm.bank_batch(host, tr[idx], cfg, np.random.default_rng(2))
    got = tm.device_batch(tm.upload_bank(host, tr, CPU), cfg, _replayed_draws(cfg, idx, want[0].shape, 2))
    for k in (2, 5, 6):  # valid0, valid1, gt
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for k in (1, 4):  # keypoints: the rolls in f32 here, in f64 there
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=KP_ATOL)
    for k in (0, 3):  # descriptors: f16 on the device
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=DESC_F16_ATOL)

    mcfg = tam.MatcherConfig(d_model=32, n_heads=2, n_layers=1, desc_dim=host["desc0"].shape[-1])
    losses, grads = [], []
    for batch in (got, tuple(torch.as_tensor(a) for a in want)):
        model = tam.init_matcher(mcfg, torch.Generator().manual_seed(0), CPU)
        d0, k0, v0, d1, k1, v1, gt = batch
        loss = tm.assignment_nll(tam.assignment_log_probs(model(d0, k0, v0, d1, k1, v1)), gt, v0, v1).mean()
        loss.backward()
        losses.append(loss.item())
        grads.append([p.grad.numpy() for p in model.parameters()])
    np.testing.assert_allclose(losses[0], losses[1], rtol=LOSS_RTOL)
    scale = max(np.abs(b).max() for b in grads[1])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_REL * scale)


def test_bank_host_path_matches_jax(bank, tmp_path):
    mcfg = jam.MatcherConfig(d_model=32, n_heads=2, n_layers=1, desc_dim=bank["desc0"].shape[-1])
    cfg = dict(n_steps=3, batch=2, log_every=1, lr=1e-3)
    _, params = jam.init_matcher(jax.random.PRNGKey(0), mcfg)
    jam.save_matcher_weights(tmp_path / "m.npz", params, mcfg)
    with f64():
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
        _, j_params, j_info = jtm.train_matcher_on_bank(bank, jtm.MatcherTrainConfig(**cfg), mcfg, params=p64)
        model, _ = tam.load_matcher_weights(tmp_path / "m.npz", device=CPU)
        model, t_info = tm.train_matcher_on_bank(bank, tm.MatcherTrainConfig(**cfg), model=model.double(),
                                                 device=CPU)
    assert [s for s, _ in t_info["history"]] == [s for s, _ in j_info["history"]] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in t_info["history"]], [v for _, v in j_info["history"]], rtol=1e-9)
    np.testing.assert_allclose(t_info["holdout_nll"], j_info["holdout_nll"], rtol=1e-9)
    jam.save_matcher_weights(tmp_path / "j.npz", jax.tree_util.tree_map(np.asarray, j_params), mcfg)
    data = np.load(tmp_path / "j.npz")
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), data[tam._flax_key(name)], rtol=0, atol=1e-8, err_msg=name)


def test_plane_pair_training_loss_falls():
    """tests/test_attention_matcher.py:93-107 on the port's own draws."""
    cfg = tm.MatcherTrainConfig(n_steps=15, log_every=5, lr=1e-3, **SMALL)
    mcfg = tam.MatcherConfig(d_model=64, n_heads=2, n_layers=2)
    _, info = tm.train_matcher(cfg, mcfg, device=CPU)
    hist = info["history"]
    assert all(np.isfinite(v) for _, v in hist)
    assert min(v for _, v in hist[1:]) < hist[0][1], hist


@pytest.mark.parametrize("scan_chunk", [0, 4], ids=["host", "device_resident"])
def test_bank_training_loss_falls(bank, scan_chunk):
    """tests/test_attention_matcher.py:140-172's training gate on the port's
    draws, on both data paths."""
    mcfg = tam.MatcherConfig(d_model=32, n_heads=2, n_layers=1, desc_dim=bank["desc0"].shape[-1])
    cfg = tm.MatcherTrainConfig(n_steps=16, batch=2, log_every=4, lr=1e-3)
    _, info = tm.train_matcher_on_bank(bank, cfg, mcfg, scan_chunk=scan_chunk, device=CPU)
    hist = [v for _, v in info["history"]]
    assert np.isfinite(info["holdout_nll"]) and all(np.isfinite(hist))
    assert min(hist[1:]) < hist[0], hist
