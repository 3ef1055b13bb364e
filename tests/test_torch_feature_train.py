"""Parity of the port's UNet initialisation and warp-consistency InfoNCE
training (``pixtrack_tpu_torch/features/{unet,train}.py``) with the JAX
package on the CPU, with the UNet in f32 on both sides.

JAX's draws are fed to the port: the test rebuilds JAX's key tree
(``split(key, 4)`` in ``make_loss_fn``, ``split(key, 3)`` in each drawing
function) and passes the canonical draws (``jax.random.uniform`` on [0, 1),
``jax.random.normal``) that the port maps as jax.random maps its own.

Tolerances (measured gaps in brackets): the initialisation cannot share
JAX's bits, so each kernel's standard deviation, pooled over >= 32768
entries (sampling error ~0.4 %), is held within 5 % of flax's at the same
fan-in [0.5 %]; biases and GroupNorm parameters exactly. Textures,
homographies and warps 1e-5 [9.8e-6, 1.9e-6, 4.4e-6]. One loss 1e-5
relative [2.0e-7]; its gradients within 5e-5 of each leaf's largest entry
[1.0e-7], in f64 on both sides: the UNet's f32 InfoNCE gradients are
ill-conditioned (JAX's own f32 gradient lies up to 4 % of a leaf's largest
entry from the f64 one, the port's 0.5 %), and oneDNN's convolution
backward on the CPU adds up to 2e-3, so the gradient test runs torch's own
convolutions (``mkldnn`` off). The checkpoint round trips give equal
parameters, and features within 1e-4 [9.9e-6], the f32 UNet tolerance of
``tests/test_torch_features.py``. The trajectory bounds are
``tests/test_feature_train.py``'s.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixtrack_tpu.features import train as jtrain
from pixtrack_tpu.features.unet import UNetExtractor as JUNet
from pixtrack_tpu.features.unet import init_unet as jinit_unet
from pixtrack_tpu_torch.features.train import (
    FeatureTrainConfig,
    load_unet_weights,
    make_loss_fn,
    random_homographies,
    random_texture_batch,
    save_unet_weights,
    train_features,
    warp_image,
)
from pixtrack_tpu_torch.features.unet import (
    UNetExtractor,
    init_flax_conv_,
    init_unet,
    unet_state_dict_from_flax,
)
from pixtrack_tpu_torch.utils.config import RunConfig

torch.set_num_threads(2)
U, N = jax.random.uniform, jax.random.normal


def _t(tree):
    """numpy / JAX leaves of a nested dict -> torch tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def jax_texture_draws(key, batch, n_modes=24):
    kf, ka, kp = jax.random.split(key, 3)
    return {"freqs": U(kf, (batch, 3, n_modes, 2)), "amps": N(ka, (batch, 3, n_modes)),
            "phases": U(kp, (batch, 3, n_modes))}


def jax_homography_draws(key, batch):
    kr, ks, kt = jax.random.split(key, 3)
    return {"rot": U(kr, (batch,)), "scale": U(ks, (batch,)), "shift": U(kt, (batch, 2))}


def jax_loss_draws(key, cfg):
    """The port's draws of ``make_loss_fn(model, cfg)(params, key)``."""
    k_tex, k_h, k_jit, k_pairs = jax.random.split(key, 4)
    keys = jax.random.split(k_pairs, cfg.batch * 3).reshape(cfg.batch, 3, 2)
    pairs = jnp.stack([jnp.stack([U(jax.random.split(keys[b, lvl])[0], (cfg.n_pairs, 2)) for lvl in range(3)])
                       for b in range(cfg.batch)])
    return {"texture": jax_texture_draws(k_tex, cfg.batch), "homography": jax_homography_draws(k_h, cfg.batch),
            "gain": N(k_jit, (cfg.batch, 1, 1, 3)), "pairs": pairs}


def _port_unet(params, dtype=torch.float32):
    model = UNetExtractor(dtype=dtype)
    model.load_state_dict(unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return model.to(dtype)


@contextlib.contextmanager
def f64():
    """Both packages in f64: JAX with x64 on, torch's default dtype f64."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_default_dtype(old)


def assert_grads_match(model, j_grads, rel=5e-5):
    """Every parameter's gradient within ``rel`` of its leaf's largest entry."""
    ref = unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in model.named_parameters():
        g = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=rel * np.abs(g).max(), err_msg=name)


def _flax_kernels(params):
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    return {".".join(k.key for k in path[:-1]): np.asarray(v) for path, v in flat if path[-1].key == "kernel"}


@pytest.fixture(scope="module")
def flax_init():
    return jinit_unet(jax.random.PRNGKey(0), 32, 32, dtype=jnp.float32)


def _check_flax_initialisation(model, flax_params):
    """Names and shapes of the flax tree; zero biases, GroupNorm 1 / 0; each
    kernel's std within 5 % of flax's at its fan-in (both pooled to >= 32768
    entries), every entry inside the +-2 sigma cut. Re-draws the kernels."""
    sd = model.state_dict()
    ref = unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, flax_params))
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert sd[k].shape == v.shape, k
        if k.endswith("bias") or (k.endswith("weight") and v.ndim == 1):
            np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    init = jax.nn.initializers.variance_scaling(1.0, "fan_in", "truncated_normal")
    gen = torch.Generator().manual_seed(1)
    for name, kern in _flax_kernels(flax_params).items():
        conv = model.get_submodule(name)
        reps = -(-32768 // kern.size)
        ours = [conv.weight.detach().clone()]
        for _ in range(reps - 1):
            init_flax_conv_(conv, gen)
            ours.append(conv.weight.detach().clone())
        ours = torch.stack(ours).numpy()
        # more output channels, the same fan-in
        theirs = np.asarray(init(jax.random.PRNGKey(7), (*kern.shape[:3], kern.shape[3] * reps)))
        assert abs(ours.std() / theirs.std() - 1.0) < 0.05, (name, ours.std(), theirs.std())
        fan_in = kern.shape[0] * kern.shape[1] * kern.shape[2]
        assert np.abs(ours).max() <= 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566 * (1 + 1e-6), name


def test_init_unet_has_flax_initialisation(flax_init):
    _, params = flax_init
    _check_flax_initialisation(init_unet(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32),
                               params)


def test_configured_random_unet_is_init_unet(flax_init):
    """``extractor: unet`` without weights builds its UNet through init_unet
    (a generator seeded 0), as the JAX package's config through
    init_unet(PRNGKey(0))."""
    ex = RunConfig(extractor="unet").make_extractor(device="cpu")
    ref = init_unet(torch.Generator().manual_seed(0), device="cpu")
    for (k, a), b in zip(ex.model.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), k
    _check_flax_initialisation(ex.model, flax_init[1])


def test_textures_homographies_and_warps_match_jax():
    cfg = FeatureTrainConfig(size=64)
    key = jax.random.PRNGKey(3)
    k_tex, k_h = jax.random.split(key)
    j_img = jtrain.random_texture_batch(k_tex, 2, 64)
    t_img = random_texture_batch(2, 64, device="cpu", draws=_t(jax_texture_draws(k_tex, 2)))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-5)
    j_H = jtrain.random_homographies(k_h, 2, cfg)
    t_H = random_homographies(2, cfg, device="cpu", draws=_t(jax_homography_draws(k_h, 2)))
    np.testing.assert_allclose(t_H.numpy(), np.asarray(j_H), rtol=1e-5, atol=1e-5)
    j_w = jax.vmap(jtrain.warp_image)(j_img, j_H)
    t_w = warp_image(_t(j_img), _t(j_H))
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=1e-5)
    # a single image, and the JAX tests' invariants
    np.testing.assert_allclose(warp_image(_t(j_img[0]), _t(j_H[0])).numpy(), np.asarray(j_w[0]), atol=1e-5)
    a = random_texture_batch(2, 64, torch.Generator().manual_seed(0), "cpu").numpy()
    assert a.shape == (2, 64, 64, 3) and 0 <= a.min() and a.max() <= 1 and a.std() > 0.05
    out = warp_image(torch.as_tensor(a[0]), torch.eye(3)).numpy()
    np.testing.assert_allclose(out[:-1, :-1], a[0][:-1, :-1], atol=1e-4)
    H = random_homographies(4, FeatureTrainConfig(size=64, max_shift=0.0), torch.Generator().manual_seed(2), "cpu")
    c = H @ torch.tensor([31.5, 31.5, 1.0])
    np.testing.assert_allclose((c[:, :2] / c[:, 2:3]).numpy(), 31.5, atol=1e-3)


def test_loss_and_gradients_match_jax(flax_init):
    """The loss in f32 on both sides; its gradients in f64 on both sides."""
    cfg = FeatureTrainConfig(batch=2, size=64, n_pairs=64)
    _, params = flax_init
    key = jax.random.PRNGKey(11)
    j_loss = jax.jit(jtrain.make_loss_fn(JUNet(dtype=jnp.float32), cfg))(params, key)
    with torch.no_grad():
        loss = make_loss_fn(_port_unet(params), cfg)(draws=_t(jax_loss_draws(key, cfg)))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    with f64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        _, j_grads = jax.jit(jax.value_and_grad(jtrain.make_loss_fn(JUNet(dtype=jnp.float64), cfg)))(p64, key)
        model = _port_unet(params, torch.float64)
        with torch.backends.mkldnn.flags(enabled=False):
            make_loss_fn(model, cfg)(draws=_t(jax_loss_draws(key, cfg))).backward()
    assert_grads_match(model, j_grads)


def test_training_loss_finite_and_decreases():
    """tests/test_feature_train.py's invariants on the port alone: 16 steps,
    every logged loss finite, the last below the first, and a fixed batch's
    loss lower after training than at the start."""
    cfg = FeatureTrainConfig(n_steps=16, batch=2, size=64, n_pairs=64, log_every=4, lr=2e-3)
    model = init_unet(torch.Generator().manual_seed(0), device="cpu")
    fixed = make_loss_fn(model, cfg).draws(torch.Generator().manual_seed(42))
    with torch.no_grad():
        before = float(make_loss_fn(model, cfg)(draws=fixed))
    model, info = train_features(cfg, seed=0, model=model, device="cpu")
    hist = info["history"]
    assert len(hist) == 5 and all(np.isfinite(v) for _, v in hist)
    assert hist[-1][1] < hist[0][1], hist
    with torch.no_grad():
        assert float(make_loss_fn(model, cfg)(draws=fixed)) < before


def test_weights_cross_the_packages_both_ways(tmp_path, flax_init):
    """The port's checkpoint read by JAX's load_unet_weights and JAX's read
    by the port's: the same parameters, the same features."""
    _, params = flax_init
    model = init_unet(torch.Generator().manual_seed(5), device="cpu", dtype=torch.float32)
    save_unet_weights(tmp_path / "port.npz", model)
    _, jparams = jtrain.load_unet_weights(tmp_path / "port.npz")
    back = unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    x = np.random.default_rng(0).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    j_out = JUNet(dtype=jnp.float32).apply(jparams, jnp.asarray(x))
    with torch.no_grad():
        t_out = model(torch.as_tensor(x))
    for a, b in zip(t_out["feature_maps"], j_out["feature_maps"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    jtrain.save_unet_weights(tmp_path / "jax.npz", params)
    ported = load_unet_weights(tmp_path / "jax.npz", device="cpu", dtype=torch.float32)
    ref = _port_unet(params)
    for (k, a), b in zip(ported.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), k
    # the port writes what JAX writes, key for key
    save_unet_weights(tmp_path / "again.npz", ported)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "again.npz") as b:
        assert str(a["__meta__"]) == str(b["__meta__"])
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_training_entry_points_default_to_the_card(monkeypatch):
    """Without device="cpu" the training and evaluation entry points ask for
    the CUDA card and raise where there is none; none carries on on the CPU."""
    from pixtrack_tpu_torch.features.evaluate import FeatureEvalConfig, evaluate_starts, load_scenes
    from pixtrack_tpu_torch.features.train_basin import BasinTrainConfig, train_basin_features

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_unet(),
                 lambda: train_features(FeatureTrainConfig(n_steps=1)),
                 lambda: train_basin_features(BasinTrainConfig(n_steps=1)),
                 lambda: evaluate_starts(lambda im: None, FeatureEvalConfig(n_scenes=1)),
                 lambda: load_scenes("scripts_dev/evaluate_jax.npz"),
                 lambda: random_texture_batch(1, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
