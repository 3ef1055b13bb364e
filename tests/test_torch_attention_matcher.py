"""The port's attention matcher (``mapping/attention_matcher.py``) and
``default_matcher`` against the JAX package's, on the CPU, with JAX's
``init_matcher`` weights carried across (no trained matcher ships).

Tolerances, and what was measured: the assignment log-probabilities of the
valid rows and columns at 1e-4 (measured 1.4e-6 at the full config, 40 and
37 keypoints in a bucket of 64); the same matches on every keypoint
(measured: all). Padding is exact: the valid entries of one pair padded to
32 and to 64 are equal to the bit (measured 0.0), and the padded rows stay
finite, which flax's fill of masked logits (the f32 minimum) gives and a
-inf fill does not. Checkpoints read across packages exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixtrack_tpu.mapping import attention_matcher as jam
from pixtrack_tpu_torch.mapping import attention_matcher as tam

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """JAX's init weights at the full config, in both packages."""
    cfg = jam.MatcherConfig()
    model, params = jam.init_matcher(jax.random.PRNGKey(3), cfg)
    path = tmp_path_factory.mktemp("matcher") / "m.npz"
    jam.save_matcher_weights(path, params, cfg)
    tmodel, tcfg = tam.load_matcher_weights(path, device=CPU)
    assert tcfg == tam.MatcherConfig()
    return model, params, tmodel


def _pair(n0, n1, N, D=845, seed=0):
    rng = np.random.default_rng(seed)
    d0, d1 = rng.normal(size=(2, 1, N, D)).astype(np.float32)
    k0, k1 = rng.uniform(-1, 1, (2, 1, N, 2)).astype(np.float32)
    return d0, k0, np.arange(N)[None] < n0, d1, k1, np.arange(N)[None] < n1


class TestAssignment:
    def test_extract_matches_mutual_and_dustbin(self):
        # 3x3 score block: 0<->0 and 1<->1 strong, 2 prefers the dustbin
        s = np.full((4, 4), -5.0, np.float32)
        s[0, 0] = s[1, 1] = 6.0
        s[2, 3] = 6.0   # row dustbin
        s[3, :] = 0.0   # col dustbin row
        logp = tam.assignment_log_probs(torch.from_numpy(s)[None])[0].numpy()
        np.testing.assert_allclose(logp, np.asarray(jam.assignment_log_probs(jnp.asarray(s)[None])[0]), atol=1e-6)
        m, sc = tam.extract_matches(logp, 3, 3, min_score=0.1)
        assert m.tolist() == [0, 1, -1]
        assert sc[0] > 0.1 and sc[2] == 0.0

    def test_padded_keypoints_only_match_dustbin(self):
        model = tam.init_matcher(generator=torch.Generator().manual_seed(0), device=CPU)
        N = 32
        d = torch.from_numpy(np.random.default_rng(0).normal(size=(1, N, 845)).astype(np.float32))
        k = torch.zeros((1, N, 2))
        v = torch.arange(N)[None, :] < 5  # only 5 real keypoints
        with torch.no_grad():
            scores = model(d, k, v, d, k, v)
        # any real<->padded cell is masked to -1e9
        assert float(scores[0, 0, 10]) < -1e8
        assert float(scores[0, 10, 0]) < -1e8
        # the dustbin stays reachable
        assert float(scores[0, 0, N]) > -1e8


def test_scores_match_flax(carried):
    model, params, tmodel = carried
    inputs = _pair(40, 37, 64)
    ref = np.asarray(jam.assignment_log_probs(model.apply(params, *inputs)))[0]
    with torch.no_grad():
        got = tam.assignment_log_probs(tmodel(*[torch.from_numpy(a) for a in inputs]))[0].numpy()
    ok = np.concatenate([inputs[2][0], [True]])[:, None] & np.concatenate([inputs[5][0], [True]])[None]
    np.testing.assert_allclose(got[ok], ref[ok], atol=1e-4)
    assert np.isfinite(got).all()


def test_valid_outputs_do_not_depend_on_the_bucket(carried):
    """A pair padded to 32 and to 64: the valid entries are equal, and the
    padded query rows (masked everywhere) stay finite."""
    _, _, tmodel = carried
    n0, n1 = 20, 27
    d0, k0, _, d1, k1, _ = _pair(n0, n1, 64, seed=1)
    lm = tam.LearnedMatcher(tmodel, min_score=0.0)
    shape = (160, 160)
    kp0, kp1 = (k0[0, :n0] + 1) * 80, (k1[0, :n1] + 1) * 80
    small = lm.log_probs(d0[0, :n0], kp0, shape, d1[0, :n1], kp1, shape, N=32)
    large = lm.log_probs(d0[0, :n0], kp0, shape, d1[0, :n1], kp1, shape, N=64)
    np.testing.assert_array_equal(small[:n0, :n1], large[:n0, :n1])
    np.testing.assert_array_equal(small[:n0, 32], large[:n0, 64])
    np.testing.assert_array_equal(small[32, :n1], large[64, :n1])
    assert np.isfinite(small).all() and np.isfinite(large).all()
    with torch.no_grad():  # the whole forward of the padded pair is finite, every block included
        v0, v1 = torch.arange(64)[None] < n0, torch.arange(64)[None] < n1
        out = tmodel(torch.from_numpy(d0), torch.from_numpy(k0), v0, torch.from_numpy(d1), torch.from_numpy(k1), v1)
    assert torch.isfinite(out).all()


def test_learned_matcher_matches_jax(carried):
    model, params, tmodel = carried
    rng = np.random.default_rng(2)
    n0, n1 = 45, 38
    d0, d1 = rng.normal(size=(n0, 845)).astype(np.float32), rng.normal(size=(n1, 845)).astype(np.float32)
    d1[:30] = d0[:30] + 0.1 * rng.normal(size=(30, 845)).astype(np.float32)  # some true pairs
    kp0, kp1 = rng.uniform(0, 191, (n0, 2)), rng.uniform(0, 191, (n1, 2))
    jm0, js0 = jam.LearnedMatcher(model, params, min_score=0.0)(d0, kp0, (192, 192), d1, kp1, (192, 192))
    m0, s0 = tam.LearnedMatcher(tmodel, min_score=0.0)(d0, kp0, (192, 192), d1, kp1, (192, 192))
    np.testing.assert_array_equal(m0, jm0)
    np.testing.assert_allclose(s0, js0, atol=1e-5)
    empty = tam.LearnedMatcher(tmodel)(d0[:0], kp0[:0], (192, 192), d1, kp1, (192, 192))
    assert empty[0].shape == (0,)


class TestPersistence:
    def test_save_load_roundtrip(self, tmp_path):
        cfg = tam.MatcherConfig(d_model=32, n_heads=2, n_layers=1)
        model = tam.init_matcher(cfg, torch.Generator().manual_seed(1), device=CPU)
        tam.save_matcher_weights(tmp_path / "m.npz", model, cfg)
        model2, cfg2 = tam.load_matcher_weights(tmp_path / "m.npz", device=CPU)
        assert cfg2 == cfg
        d, k, v = torch.zeros((1, 8, cfg.desc_dim)), torch.zeros((1, 8, 2)), torch.ones((1, 8), dtype=torch.bool)
        with torch.no_grad():
            np.testing.assert_allclose(model(d, k, v, d, k, v).numpy(), model2(d, k, v, d, k, v).numpy(), atol=1e-6)

    def test_checkpoints_read_across_packages(self, tmp_path):
        """The JAX package reads the port's file and the port JAX's: the same
        keys, config and scores."""
        cfg = tam.MatcherConfig(d_model=32, n_heads=2, n_layers=1, desc_dim=16)
        model = tam.init_matcher(cfg, torch.Generator().manual_seed(2), device=CPU)
        tam.save_matcher_weights(tmp_path / "port.npz", model)
        jmodel, jparams, jcfg = jam.load_matcher_weights(tmp_path / "port.npz")
        assert jcfg == jam.MatcherConfig(d_model=32, n_heads=2, n_layers=1, desc_dim=16)
        inputs = _pair(6, 7, 8, D=16, seed=3)
        with torch.no_grad():
            got = model(*[torch.from_numpy(a) for a in inputs]).numpy()
        np.testing.assert_allclose(got, np.asarray(jmodel.apply(jparams, *inputs)), atol=1e-5)
        jam.save_matcher_weights(tmp_path / "jax.npz", jparams, jcfg)
        model2, _ = tam.load_matcher_weights(tmp_path / "jax.npz", device=CPU)
        for (k, a), (k2, b) in zip(model.state_dict().items(), model2.state_dict().items()):
            assert k == k2
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_init_distribution_is_flax():
    """flax's initialisation: lecun-normal kernels over the input axis
    (std sqrt(1 / fan_in)), zero biases, LayerNorm 1 / 0, the dustbin at 1."""
    model = tam.init_matcher(generator=torch.Generator().manual_seed(0), device=CPU)
    blk = model.self0_0.MultiHeadDotProductAttention_0
    for kernel, fan_in in ((model.Dense_0.kernel, 845), (blk.query.kernel, 128), (blk.out.kernel, 128)):
        w = kernel.detach().numpy()
        assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.05, kernel.shape
    assert float(model.dustbin.detach()) == 1.0
    assert float(model.self0_0.LayerNorm_0.scale.detach().min()) == 1.0


class TestDefaultMatcher:
    def test_env_override_and_absence(self, tmp_path, monkeypatch):
        from pixtrack_tpu_torch.mapping import default_matcher

        monkeypatch.setenv("PIXTRACK_MATCHER_WEIGHTS", str(tmp_path / "missing.npz"))
        assert default_matcher(device=CPU) is None

        cfg = tam.MatcherConfig(d_model=32, n_heads=2, n_layers=1, desc_dim=16)
        tam.save_matcher_weights(tmp_path / "m.npz", tam.init_matcher(cfg, torch.Generator().manual_seed(0),
                                                                      device=CPU))
        monkeypatch.setenv("PIXTRACK_MATCHER_WEIGHTS", str(tmp_path / "m.npz"))
        lm = default_matcher(min_score=0.05, device=CPU)
        assert isinstance(lm, tam.LearnedMatcher) and lm.desc_dim == 16
        d0 = np.random.default_rng(0).normal(size=(6, 16)).astype(np.float32)
        k0 = np.random.default_rng(1).uniform(0, 64, (6, 2)).astype(np.float32)
        m0, s0 = lm(d0, k0, (64, 64), d0, k0, (64, 64))
        assert m0.shape == (6,) and s0.shape == (6,)
