"""Parity of the PyTorch render path (distilled field, the plain versions
of K1 and K2, both paths of render_rays, the importance sampler, Testbed)
with the JAX package on the CPU. The CUDA kernels are held against their
plain versions on the card in tests/test_torch_cuda.py.

Tolerances are the JAX package's own (tests/test_fused_mlp.py): 2e-3 on
sigma and 5e-3 on rgb, alpha and depth. Both sides round every dense
layer's operands to bf16 and sum in f32; what differs is the order of the
f32 sums. Trained fields take 5e-3 on 99.9 % of values and 1e-2 on all
(``_assert_trained_close``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixtrack_tpu.nerf.distill import init_distilled, load_distilled as jload_distilled
from pixtrack_tpu.nerf.fused_mlp import fused_distilled_eval as jfused_distilled_eval
from pixtrack_tpu.nerf.fused_mlp import fused_march_render as jfused_march_render
from pixtrack_tpu.nerf.render import RenderConfig as JRenderConfig
from pixtrack_tpu.nerf.render import _sample_importance as j_sample_importance
from pixtrack_tpu.nerf.render import _sample_stratified as j_sample_stratified
from pixtrack_tpu.nerf.render import _to_grid as j_to_grid
from pixtrack_tpu.nerf.render import ray_aabb_intersect as j_ray_aabb
from pixtrack_tpu.nerf.render import render_rays as jrender_rays
from pixtrack_tpu.nerf.testbed import Testbed as JTestbed
from pixtrack_tpu_torch.nerf import fused_mlp
from pixtrack_tpu_torch.nerf.distill import distilled_from_arrays, load_distilled
from pixtrack_tpu_torch.nerf.render import (
    RenderConfig,
    _sample_grid,
    _sample_importance,
    _to_grid,
    march_rays,
    ray_aabb_intersect,
    render_rays,
)
from pixtrack_tpu_torch.nerf.testbed import Testbed

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SIGMA_TOL, RGB_TOL = 2e-3, 5e-3


def _arrays(f):
    """A JAX DistilledField as the npz dict save_distilled writes."""
    out = {"meta": np.asarray([f.octaves, f.geo_features, len(f.trunk), len(f.color)])}
    for name, layers in (("trunk", f.trunk), ("color", f.color)):
        for i, p in enumerate(layers):
            out[f"{name}{i}_k"] = np.asarray(p["kernel"])
            out[f"{name}{i}_b"] = np.asarray(p["bias"])
    out["head_k"], out["head_b"] = np.asarray(f.head["kernel"]), np.asarray(f.head["bias"])
    return out


def _pair(octaves):
    jf = init_distilled(jax.random.PRNGKey(3), octaves=octaves)
    return jf, distilled_from_arrays(_arrays(jf), device="cpu")


def _samples(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=0, keepdims=True)


def _assert_trained_close(a, b):
    """Outputs of the trained fields: 5e-3 on 99.9% of the values and 1e-2
    on all. Their larger weights let a hidden activation that sits on a
    bf16 rounding boundary round the other way on one side."""
    err = np.abs(np.asarray(a) - np.asarray(b))
    assert np.quantile(err, 0.999) <= RGB_TOL and err.max() <= 1e-2, err.max()


def _check_field(jf, tf, trained=False):
    x, d = _samples()
    s0, c0 = jf.field_T(jnp.asarray(x), jnp.asarray(d))
    s1, c1 = tf.field_T(torch.as_tensor(x), torch.as_tensor(d))
    if not trained:
        np.testing.assert_allclose(np.asarray(s0), s1.numpy(), atol=SIGMA_TOL)
        np.testing.assert_allclose(np.asarray(c0), c1.numpy(), atol=RGB_TOL)
        return
    # sigma reaches ~4e3 there, where f32 sums in another order differ by
    # ~1e-6 relative: 2e-3 absolute plus 1e-5 relative
    np.testing.assert_allclose(np.asarray(s0), s1.numpy(), atol=SIGMA_TOL, rtol=1e-5)
    _assert_trained_close(c0, c1.numpy())


@pytest.mark.parametrize("octaves", [8, 10])
def test_distilled_field_random_weights(octaves):
    _check_field(*_pair(octaves))


@pytest.mark.parametrize("rel", ["assets/bench_field.npz", "assets/mesh_world/field.npz"])
def test_distilled_field_shipped_weights(rel):
    tf = load_distilled(REPO / rel, device="cpu")
    assert tf.octaves == {"assets/bench_field.npz": 8}.get(rel, 10)
    _check_field(jload_distilled(REPO / rel), tf, trained=True)


def _rays(R=96, seed=1):
    """Rays around the unit cube's centre, the last 8 pointing away (misses)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.6
    d = -o + 0.3 * rng.normal(size=(R, 3)).astype(np.float32)
    d[-8:] = -d[-8:]
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("octaves", [8, 10])
def test_k1_plain_matches_pallas_and_staged(octaves):
    """K1's plain version against the Pallas kernel in interpret mode and
    the JAX staged render, miss rays included."""
    jf, tf = _pair(octaves)
    o, d = _rays()
    aabb = np.asarray([[0.25] * 3, [0.75] * 3], np.float32)
    S = 6
    cfg = JRenderConfig(n_coarse=S, n_fine=0, perturb=False, fused=False)
    staged = jrender_rays(jf, None, jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), cfg)
    o_g, d_g = j_to_grid(jnp.asarray(o), jnp.asarray(d))
    tn, tfar, hit = j_ray_aabb(o_g, d_g, aabb[0], aabb[1])
    tfar = jnp.where(hit, jnp.maximum(tfar, tn + 1e-4), tn)
    pallas = jfused_march_render(jf, o_g, d_g, tn, tfar, S, cfg.min_transmittance, interpret=True)
    assert int(np.asarray(hit).sum()) < len(o)

    to_g, td_g = _to_grid(torch.as_tensor(o), torch.as_tensor(d))
    ttn, ttf, thit = ray_aabb_intersect(to_g, td_g, torch.as_tensor(aabb[0]), torch.as_tensor(aabb[1]))
    ttf = torch.where(thit, torch.maximum(ttf, ttn + 1e-4), ttn)
    plain = fused_mlp.march_render_reference(tf, to_g, td_g, ttn, ttf, S, cfg.min_transmittance)
    before = fused_mlp.launch_count(fused_mlp.K1)
    port = render_rays(tf, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(aabb),
                       RenderConfig(n_coarse=S, n_fine=0))
    assert fused_mlp.launch_count(fused_mlp.K1) == before  # CPU tensors never reach the kernel
    for k in ("rgb", "alpha", "depth"):
        for ref in (pallas, staged):
            np.testing.assert_allclose(np.asarray(ref[k]), plain[k].numpy(), atol=RGB_TOL, err_msg=k)
            np.testing.assert_allclose(np.asarray(ref[k]), port[k].numpy(), atol=RGB_TOL, err_msg=k)


@pytest.mark.parametrize("octaves", [8, 10])
def test_k2_plain_matches_pallas_and_field(octaves):
    """K2's wrapper on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode and JAX's field_T, N not a multiple of a tile."""
    jf, tf = _pair(octaves)
    x, d = _samples(n=1000)
    s_field, c_field = jf.field_T(jnp.asarray(x), jnp.asarray(d))
    s_pallas, c_pallas = jfused_distilled_eval(jf, jnp.asarray(x), jnp.asarray(d), interpret=True)
    s_port, c_port = fused_mlp.fused_distilled_eval(tf, torch.as_tensor(x), torch.as_tensor(d))
    s_plain, c_plain = fused_mlp.distilled_eval_reference(tf, torch.as_tensor(x), torch.as_tensor(d))
    assert s_port.shape == (1000,) and c_port.shape == (3, 1000)
    np.testing.assert_array_equal(s_port.numpy(), s_plain.numpy())
    np.testing.assert_array_equal(c_port.numpy(), c_plain.numpy())
    for s_ref, c_ref in ((s_field, c_field), (s_pallas, c_pallas)):
        np.testing.assert_allclose(np.asarray(s_ref), s_port.numpy(), atol=SIGMA_TOL)
        np.testing.assert_allclose(np.asarray(c_ref), c_port.numpy(), atol=RGB_TOL)


def test_sample_importance_matches_jax():
    """Inverse-CDF resampling on sorted coarse ts and weights with peaks,
    flat stretches and all-zero rays, against JAX's deterministic sampler."""
    rng = np.random.default_rng(4)
    R, S, n = 64, 64, 32
    t_near = rng.uniform(0.5, 1.5, R).astype(np.float32)
    t_far = t_near + rng.uniform(0.05, 2.0, R).astype(np.float32)
    u = np.sort(rng.uniform(0, 1, (R, S)), axis=1).astype(np.float32)
    t_mid = t_near[:, None] + (t_far - t_near)[:, None] * u
    w = rng.uniform(0, 1, (R, S)).astype(np.float32) ** 8
    w[:8] = 0.0
    w[8:16, 20:24] = 5.0
    ref = j_sample_importance(None, jnp.asarray(t_mid), jnp.asarray(w), jnp.asarray(t_near),
                              jnp.asarray(t_far), n)
    port = _sample_importance(*(torch.as_tensor(a) for a in (t_mid, w, t_near, t_far)), n)
    assert port.shape == (R, n)
    np.testing.assert_allclose(np.asarray(ref), port.numpy(), atol=1e-5)


def _staged_rays():
    """_rays() plus two rays from ~300 units away that cross an edge of the
    [0.25, 0.75]^3 box over less than the 1e-4 floor of an interval: their
    samples lie within a few ulps, so fine samples tie with coarse ones."""
    o, d = _rays()
    o2 = np.array([[0.0, 212.88202, -211.38205], [0.0, 212.882, -211.382065]], np.float32)
    d2 = np.array([[0.0, -1.0, 1.0]] * 2, np.float32) / np.float32(np.sqrt(2.0))
    return np.concatenate([o, o2]), np.concatenate([d, d2])


@pytest.mark.parametrize("weights", [8, 10, "assets/bench_field.npz", "assets/mesh_world/field.npz"])
def test_staged_render_rays_matches_jax(weights, monkeypatch):
    """render_rays with an importance pass (the staged path, K2's plain
    version) against JAX's staged render, miss rays and coarse/fine ties
    included: random weights at 5e-3, trained weights under the trained rule."""
    from pixtrack_tpu_torch.nerf import render as trender

    if isinstance(weights, int):
        jf, tf = _pair(weights)
    else:
        jf, tf = jload_distilled(REPO / weights), load_distilled(REPO / weights, device="cpu")
    o, d = _staged_rays()
    aabb = np.asarray([[0.25] * 3, [0.75] * 3], np.float32)
    n_c, n_f = 12, 6
    jcfg = JRenderConfig(n_coarse=n_c, n_fine=n_f, perturb=False, fused=False)
    staged = jrender_rays(jf, None, jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), jcfg)
    # record the positions of every field evaluation (coarse, fine per chunk)
    calls = []
    monkeypatch.setattr(trender, "fused_distilled_eval",
                        lambda f, x, dd: calls.append(x) or fused_mlp.fused_distilled_eval(f, x, dd))
    cfg = RenderConfig(n_coarse=n_c, n_fine=n_f, chunk=40)  # three chunks, the last ragged
    port = render_rays(tf, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(aabb), cfg)

    assert len(calls) == 6
    xc, xf = calls[4].reshape(3, -1, n_c), calls[5].reshape(3, -1, n_f)  # the last chunk
    tie = (xf[:, :, :, None] == xc[:, :, None, :]).all(0).any(-1).any(-1)
    assert bool(tie[-2:].all())  # the grazing rays hit the box and tie
    _, _, tn, tfar = march_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(aabb))
    assert 0 < int((tfar > tn).sum()) < len(o) and bool((tfar > tn)[-2:].all())
    assert float(np.asarray(staged["alpha"]).max()) > 0.05
    for k in ("rgb", "alpha", "depth"):
        if isinstance(weights, int):
            np.testing.assert_allclose(np.asarray(staged[k]), port[k].numpy(), atol=RGB_TOL, err_msg=k)
        else:
            _assert_trained_close(staged[k], port[k].numpy())


def test_kernels_not_launched_on_cpu():
    """On CPU tensors both render paths take the plain versions: neither
    kernel's launch count moves."""
    _, tf = _pair(8)
    o, d = (torch.as_tensor(a) for a in _rays(16))
    aabb = torch.tensor([[0.25] * 3, [0.75] * 3])
    before = {k: fused_mlp.launch_count(k) for k in (fused_mlp.K1, fused_mlp.K2)}
    for cfg in (RenderConfig(n_coarse=4, n_fine=0), RenderConfig(n_coarse=4, n_fine=4)):
        out = render_rays(tf, o, d, aabb, cfg)
        assert out["alpha"].shape == (16,)
    fused_mlp.fused_distilled_eval(tf, *(torch.as_tensor(a) for a in _samples(n=10)))
    assert before == {k: fused_mlp.launch_count(k) for k in (fused_mlp.K1, fused_mlp.K2)}


def _bf16(w):
    return w.to(torch.bfloat16)


@pytest.mark.parametrize("weights", [8, 10, "assets/bench_field.npz", "assets/mesh_world/field.npz"])
def test_pack_weights_reads_back(weights):
    """The kernels' weight buffer (fused_mlp._pack_weights: column reorder,
    zero padding, 8x8 core-matrix tiling) read back through its inverse
    (_unpack_weights) holds the field's bf16-rounded weights, every padding
    entry exactly zero."""
    tf = _pair(weights)[1] if isinstance(weights, int) else load_distilled(REPO / weights, device="cpu")
    octaves, depth, w, b = fused_mlp._pack_weights(tf, torch.device("cpu"))
    assert (octaves, depth) == (tf.octaves, len(tf.trunk)) and w.dtype == torch.bfloat16 and b.dtype == torch.float32
    mats = fused_mlp._unpack_weights(w, depth)
    assert [tuple(m.shape) for m in mats] == fused_mlp._layer_shapes(depth)

    # first layer: [sin a_0, cos a_0, sin a_1, ...,  x, y, z, zeros]
    n_ang, w1 = 3 * octaves, _bf16(tf.trunk[0]["kernel"])
    cols = fused_mlp._enc_columns(octaves)
    assert sorted(c for c in cols if c >= 0) == list(range(3 + 6 * octaves))
    assert cols[:4] == [3, 3 + n_ang, 4, 4 + n_ang] and cols[2 * n_ang : 2 * n_ang + 3] == [0, 1, 2]
    for c, src in enumerate(cols):
        if src >= 0:
            assert torch.equal(mats[0][:, c], w1[:, src]), c
    pad = [c for c, src in enumerate(cols) if src < 0]
    assert len(pad) == 64 - (3 + 6 * octaves) and not mats[0][:, pad].any()
    # trunk and head as they are
    for m, p in zip(mats[1:depth + 1], tf.trunk[1:] + [tf.head]):
        assert torch.equal(m, _bf16(p["kernel"]))
    # colour 0: a zero column for the raw density, then the field's 31 columns
    c0 = mats[depth + 1]
    assert not c0[:, 0].any() and torch.equal(c0[:, 1:], _bf16(tf.color[0]["kernel"])[:, :31])
    assert torch.equal(mats[depth + 2], _bf16(tf.color[1]["kernel"]))
    # colour 2: 3 rows padded to 8
    assert torch.equal(mats[depth + 3][:3], _bf16(tf.color[2]["kernel"])) and not mats[depth + 3][3:].any()
    # the tiling itself: element (n, k) lies at [k // 8][n // 8][n % 8][k % 8]
    n, k = 77, 45
    assert w[(k // 8) * 128 * 8 + (n // 8) * 64 + (n % 8) * 8 + k % 8] == mats[0][n, k]
    # biases in layer order, the last padded to 8
    layers = tf.trunk + [tf.head] + tf.color
    assert torch.equal(b[:-5], torch.cat([p["bias"].reshape(-1) for p in layers])) and not b[-5:].any()


@pytest.mark.parametrize("weights", [8, 10, "assets/bench_field.npz", "assets/mesh_world/field.npz"])
def test_packed_layout_computes_the_field(weights):
    """The plain version fed through the kernels' matrices and input order
    (encoding columns [sin, cos pairs, xyz, zeros]; colour input [the head's
    16 outputs, raw density included, then 16 SH]) computes field_T. With
    every layer's sums taken in f64 (the exact sum of the bf16 products,
    rounded to f32 once) both orders give bit-equal sigma and rgb; in f32
    the packed order stays within an ulp-scale 1e-6 of field_T itself."""
    from pixtrack_tpu_torch.nerf.field import sh_encoding_deg4_T

    tf = _pair(weights)[1] if isinstance(weights, int) else load_distilled(REPO / weights, device="cpu")
    octaves, depth, w, b = fused_mlp._pack_weights(tf, torch.device("cpu"))
    mats = fused_mlp._unpack_weights(w, depth)
    biases = torch.split(b, [m.shape[0] for m in mats])
    x, d = (torch.as_tensor(a) for a in _samples(n=500))
    cols = torch.as_tensor(fused_mlp._enc_columns(octaves))

    def packed(dtype):
        def dense(i, h):
            return (mats[i].to(dtype) @ _bf16(h).to(dtype) + biases[i][:, None].to(dtype)).float()

        enc = tf.encode_T(x)
        h = torch.where((cols >= 0)[:, None], enc[cols.clamp_min(0)], torch.zeros(()))
        for i in range(depth):
            h = torch.relu(dense(i, h))
        head = dense(depth, h)
        c = torch.cat([head, sh_encoding_deg4_T(d)], dim=0)
        c = torch.relu(dense(depth + 2, torch.relu(dense(depth + 1, c))))
        return torch.expm1(torch.nn.functional.softplus(head[0])), torch.sigmoid(dense(depth + 3, c)[:3])

    def field_f64():
        def dense(p, h):
            return (_bf16(p["kernel"]).double() @ _bf16(h).double() + p["bias"].double()).float()

        h = tf.encode_T(x)
        for p in tf.trunk:
            h = torch.relu(dense(p, h))
        head = dense(tf.head, h)
        c = torch.cat([head[1:], sh_encoding_deg4_T(d)], dim=0)
        c = torch.relu(dense(tf.color[1], torch.relu(dense(tf.color[0], c))))
        return torch.expm1(torch.nn.functional.softplus(head[0])), torch.sigmoid(dense(tf.color[2], c))

    s64, c64 = packed(torch.float64)
    s_ref64, c_ref64 = field_f64()
    assert torch.equal(s64, s_ref64) and torch.equal(c64, c_ref64)
    s32, c32 = packed(torch.float32)
    s_ref, c_ref = tf.field_T(x, d)
    np.testing.assert_allclose(c32.numpy(), c_ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(s32.numpy(), s_ref.numpy(), atol=1e-6, rtol=1e-6)


def test_render_refuses_jittered_samples():
    """Jittered samples were once refused; now they are rendered. What is
    still refused is jitter without a source of noise: ``perturb`` alone
    (no generator) is the deterministic render, as in the JAX package
    without a key, and with a generator the render is the staged one (no
    K1 eligibility), reproducible under its seed and different under another."""
    _, tf = _pair(8)
    o, d = (torch.as_tensor(a) for a in _rays(48))
    aabb = torch.tensor([[0.25] * 3, [0.75] * 3])

    def gen(seed):
        return torch.Generator(device="cpu").manual_seed(seed)

    for n_fine in (0, 4):
        plain = render_rays(tf, o, d, aabb, RenderConfig(n_coarse=6, n_fine=n_fine))
        cfg = RenderConfig(n_coarse=6, n_fine=n_fine, perturb=True)
        same = render_rays(tf, o, d, aabb, cfg)
        a, a2, b = (render_rays(tf, o, d, aabb, cfg, generator=gen(s)) for s in (3, 3, 4))
        for k in plain:
            assert torch.equal(plain[k], same[k]), k
            assert torch.equal(a[k], a2[k]), k
            assert bool(torch.isfinite(a[k]).all())
        assert not torch.equal(a["rgb"], b["rgb"]) and not torch.equal(a["rgb"], plain["rgb"])
    # a generator without perturb: stratified samples stay, the importance u is drawn
    cfg = RenderConfig(n_coarse=6, n_fine=4)
    assert not torch.equal(render_rays(tf, o, d, aabb, cfg, generator=gen(3))["rgb"],
                           render_rays(tf, o, d, aabb, cfg)["rgb"])
    # chunks draw in turn from the one generator: chunking changes the noise, not the statistics
    cfg_c = RenderConfig(n_coarse=6, n_fine=4, perturb=True, chunk=20)
    c1, c2 = (render_rays(tf, o, d, aabb, cfg_c, generator=gen(3)) for _ in range(2))
    assert torch.equal(c1["rgb"], c2["rgb"]) and c1["rgb"].shape == (48, 3)


def test_jittered_samplers_match_jax_on_the_same_noise(monkeypatch):
    """jax.random's bits cannot be reproduced, so both packages are fed the
    same uniform noise (numpy, from a seed): the JAX samplers through a
    patched ``jax.random.uniform``, the port's through their ``noise`` and
    ``u`` arguments. Sample positions within 1e-6 (relative to t ~ 1)."""
    rng = np.random.default_rng(11)
    R, S, n = 48, 16, 8
    t_near = rng.uniform(0.5, 1.5, R).astype(np.float32)
    t_far = t_near + rng.uniform(0.05, 2.0, R).astype(np.float32)
    noise = rng.uniform(0, 1, (R, S)).astype(np.float32)
    u = rng.uniform(0, 1, (R, n)).astype(np.float32)
    w = rng.uniform(0, 1, (R, S)).astype(np.float32) ** 6
    w[:4] = 0.0
    key = jax.random.PRNGKey(0)
    queue = [noise, u]
    monkeypatch.setattr(jax.random, "uniform", lambda k, shape: jnp.asarray(queue.pop(0)).reshape(shape))
    ts_j = j_sample_stratified(key, jnp.asarray(t_near), jnp.asarray(t_far), S, True)
    ts_t = _sample_grid(torch.as_tensor(t_near), torch.as_tensor(t_far), S, torch.as_tensor(noise))
    np.testing.assert_allclose(np.asarray(ts_j), ts_t.numpy(), atol=1e-6, rtol=1e-6)
    assert bool((ts_t[:, 1:] > ts_t[:, :-1]).all())  # jitter stays inside its stratum
    tf_j = j_sample_importance(key, ts_j, jnp.asarray(w), jnp.asarray(t_near), jnp.asarray(t_far), n)
    tf_t = _sample_importance(ts_t, torch.as_tensor(w), torch.as_tensor(t_near), torch.as_tensor(t_far), n,
                              torch.as_tensor(u))
    assert not queue
    np.testing.assert_allclose(np.asarray(tf_j), tf_t.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("weights", [8, "assets/bench_field.npz"])
def test_jittered_render_matches_jax_on_the_same_noise(weights, monkeypatch):
    """The 16 + 8 sample jittered render of both packages on the same noise:
    random weights at 5e-3, trained weights under the trained rule (the
    staged test's tolerances)."""
    from pixtrack_tpu_torch.nerf import render as trender

    if isinstance(weights, int):
        jf, tf = _pair(weights)
    else:
        jf, tf = jload_distilled(REPO / weights), load_distilled(REPO / weights, device="cpu")
    o, d = _rays()
    R, n_c, n_f = len(o), 16, 8
    rng = np.random.default_rng(12)
    noise = rng.uniform(0, 1, (R, n_c)).astype(np.float32)
    u = rng.uniform(0, 1, (R, n_f)).astype(np.float32)
    aabb = np.asarray([[0.25] * 3, [0.75] * 3], np.float32)
    key = jax.random.PRNGKey(0)
    queue = [noise, u]
    monkeypatch.setattr(jax.random, "uniform", lambda k, shape: jnp.asarray(queue.pop(0)).reshape(shape))
    jcfg = JRenderConfig(n_coarse=n_c, n_fine=n_f, perturb=True, fused=False)
    ref = jrender_rays(jf, None, jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), jcfg, key=key)
    assert not queue
    det = render_rays(tf, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(aabb),
                      RenderConfig(n_coarse=n_c, n_fine=n_f))
    monkeypatch.setattr(trender, "_draw_noise", lambda *a: (torch.as_tensor(noise), torch.as_tensor(u)))
    cfg = RenderConfig(n_coarse=n_c, n_fine=n_f, perturb=True, chunk=R)
    port = render_rays(tf, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(aabb), cfg,
                       generator=torch.Generator())
    assert float(np.asarray(ref["alpha"]).max()) > 0.05
    assert not torch.equal(port["rgb"], det["rgb"])  # the noise did move the samples
    for k in ("rgb", "alpha", "depth"):
        if isinstance(weights, int):
            np.testing.assert_allclose(np.asarray(ref[k]), port[k].numpy(), atol=RGB_TOL, err_msg=k)
        else:
            _assert_trained_close(ref[k], port[k].numpy())


def test_testbed_spp_is_deterministic_and_converges():
    """Testbed.render(spp > 1): the same seed gives the same image bit for
    bit, another seed another image; spp == 1 stays the deterministic pass;
    the mean over spp approaches a 32-sample mean as spp grows (mean |error|
    of spp=2 above that of spp=8); Depth mode averages too. The JAX Testbed's
    spp=8 mean, on its own noise, lies within 0.02 in the mean of the port's."""
    jtb, ttb = JTestbed(), Testbed(device="cpu")
    jtb.set_baked_field(jload_distilled(REPO / "assets/bench_field.npz"))
    ttb.set_baked_field(load_distilled(REPO / "assets/bench_field.npz", device="cpu"))
    c2w = np.eye(4)
    c2w[:3, 3] = [0.0, 0.0, 1.3]
    for tb in (jtb, ttb):
        tb.render_aabb.min, tb.render_aabb.max = [0.3] * 3, [0.7] * 3
        tb.n_coarse, tb.n_fine = 12, 6
        tb.override_intrinsics = (26.0, 26.0, 11.5, 8.5)
        tb.set_nerf_camera_matrix(c2w[:3])
    one = ttb.render(24, 18, spp=1)
    assert np.array_equal(one, ttb.render(24, 18, spp=1, seed=5))  # spp == 1 draws nothing
    a, a2, b = ttb.render(24, 18, spp=2, seed=1), ttb.render(24, 18, spp=2, seed=1), ttb.render(24, 18, spp=2, seed=2)
    assert a.shape == (18, 24, 4) and a.dtype == np.float32 and np.isfinite(a).all()
    assert np.array_equal(a, a2) and not np.array_equal(a, b) and not np.array_equal(a, one)
    assert one[..., 3].max() > 0.5  # the object is in view
    ref = ttb.render(24, 18, spp=32, seed=9)
    e2, e8 = (np.abs(ttb.render(24, 18, spp=n, seed=1) - ref).mean() for n in (2, 8))
    assert e8 < e2, (e2, e8)
    rgba_j = jtb.render(24, 18, spp=8, seed=0)
    assert np.abs(rgba_j - ttb.render(24, 18, spp=8, seed=0)).mean() < 0.02
    from pixtrack_tpu_torch.nerf.testbed import RenderMode

    ttb.render_mode = RenderMode.Depth
    depth = ttb.render(24, 18, spp=2, seed=1)
    assert np.isfinite(depth).all() and depth[..., 0].max() > 0.5 and np.array_equal(depth[..., 3], a[..., 3])


@pytest.mark.parametrize("n_coarse,n_fine", [(24, 0), (64, 32)])
def test_testbed_render_and_bounds_match_jax(n_coarse, n_fine):
    """Mesh-world field: occupied-bounds tightening and a Shade + Depth
    render at a small size through both Testbeds, coarse only (K1's path)
    and at the Testbed's 64 coarse + 32 importance samples (K2's path)."""
    import json

    meta = json.loads((REPO / "assets/mesh_world/meta.json").read_text())
    jtb, ttb = JTestbed(), Testbed(device="cpu")
    jtb.set_baked_field(jload_distilled(REPO / "assets/mesh_world/field.npz"))
    ttb.set_baked_field(load_distilled(REPO / "assets/mesh_world/field.npz", device="cpu"))
    c2w = np.eye(4)
    c2w[:3, 3] = [0.0, 0.2, 1.9]
    for tb in (jtb, ttb):
        tb.render_aabb.min = [float(v) for v in meta["aabb"][0]]
        tb.render_aabb.max = [float(v) for v in meta["aabb"][1]]
        tb.n_coarse, tb.n_fine = n_coarse, n_fine
        tb.tighten_render_bounds(res=24)
        tb.override_intrinsics = (30.0, 30.0, 15.5, 11.5)
        tb.set_nerf_camera_matrix(c2w[:3])
    # one grid cell of slack: bf16 sums may flip a borderline cell
    cell = (np.asarray(meta["aabb"][1]) - np.asarray(meta["aabb"][0])) / 24
    np.testing.assert_allclose(jtb.render_aabb.min, ttb.render_aabb.min, atol=cell.max() + 1e-6)
    np.testing.assert_allclose(jtb.render_aabb.max, ttb.render_aabb.max, atol=cell.max() + 1e-6)
    # render through the same bounds so the images are comparable
    ttb.render_aabb.min, ttb.render_aabb.max = list(jtb.render_aabb.min), list(jtb.render_aabb.max)
    ttb._sphere = np.asarray(jtb._sphere)
    rgba_j = jtb.render(32, 24, spp=1)
    rgba_t = ttb.render(32, 24, spp=1)
    assert rgba_j[..., 3].max() > 0.2  # the object is in view
    _assert_trained_close(rgba_j, rgba_t)
    from pixtrack_tpu.nerf.testbed import RenderMode as JMode
    from pixtrack_tpu_torch.nerf.testbed import RenderMode

    jtb.render_mode, ttb.render_mode = JMode.Depth, RenderMode.Depth
    _assert_trained_close(jtb.render(32, 24, spp=1), ttb.render(32, 24, spp=1))
