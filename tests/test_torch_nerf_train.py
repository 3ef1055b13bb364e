"""Parity of the port's hash-grid training, its optimizer, the Testbed over a
hash-grid snapshot, and the kernels' refusal to train, with the JAX package
on the CPU.

One training step is compared on the same batch and the same render noise
(fed to JAX through a patched ``jax.random.uniform``): loss within 1e-5
relative, every gradient within 5e-5 of its largest entry (measured 4.6e-6;
f32 sums in another order, carried through the importance sampler).
Adam matches optax to 1e-5 relative (its moments round in another order),
the schedule to 1e-6. The trajectory tests
hold the port to the JAX tests' own bounds (tests/test_nerf.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixtrack_tpu.nerf.dataset import make_synthetic_dataset as jmake_synthetic
from pixtrack_tpu.nerf.dataset import sphere_scene as jsphere
from pixtrack_tpu.nerf.snapshot import save_snapshot as jsave_snapshot
from pixtrack_tpu.nerf.testbed import Testbed as JTestbed
from pixtrack_tpu.nerf.train import TrainConfig as JTrainConfig
from pixtrack_tpu.nerf.train import make_loss_fn as jmake_loss_fn
from pixtrack_tpu_torch.nerf import fused_mlp
from pixtrack_tpu_torch.nerf import render as trender
from pixtrack_tpu_torch.nerf.dataset import make_synthetic_dataset, sphere_scene
from pixtrack_tpu_torch.nerf.distill import init_distilled
from pixtrack_tpu_torch.nerf.field import init_field
from pixtrack_tpu_torch.nerf.optim import Adam, exponential_decay
from pixtrack_tpu_torch.nerf.render import RenderConfig, render_image, render_rays
from pixtrack_tpu_torch.nerf.testbed import RenderMode, Testbed, initialize_testbed
from pixtrack_tpu_torch.nerf.train import TrainConfig, make_loss_fn, psnr, train

from test_torch_ngp import TINY, pair

torch.set_num_threads(2)
AABB = [[0.2, 0.2, 0.2], [0.8, 0.8, 0.8]]


def feed_uniform(monkeypatch, arrays):
    """Patch jax.random.uniform(key, shape) to return ``arrays`` in turn;
    calls with more arguments (flax's initialisers, which it traces to check
    shapes) go through."""
    queue, orig = list(arrays), jax.random.uniform

    def fake(key, shape=(), *args, **kwargs):
        if args or kwargs:
            return orig(key, shape, *args, **kwargs)
        return jnp.asarray(queue.pop(0)).reshape(shape)

    monkeypatch.setattr(jax.random, "uniform", fake)


def _grads_by_flax_name(field):
    """The port field's gradients keyed as the flax tree's leaves."""
    out = {f"table{l}": g for l, g in enumerate(field.encoding.tables.grad.numpy())}
    for name in ("color_l1", "color_l2", "color_l3", "density_l1", "density_l2"):
        layer = getattr(field, name)
        out[f"{name}/kernel"], out[f"{name}/bias"] = layer.kernel.grad.numpy(), layer.bias.grad.numpy()
    return out


@pytest.mark.parametrize("n_fine", [0, 16])
def test_train_step_loss_and_gradients_match_jax(monkeypatch, n_fine):
    """One photometric loss and its gradient, coarse only and with the
    importance pass (whose samples carry gradient back through the coarse
    weights), on the same 96 rays and the same noise."""
    jf, params, tf = pair(seed=1, scale=0.05, **TINY)
    ds = jmake_synthetic(jsphere, n_views=4, res=16)
    o, d, rgb = ds.all_rays()
    idx = np.random.default_rng(0).choice(len(o), 96, replace=False)
    o, d, rgb = o[idx], d[idx], rgb[idx]
    rng = np.random.default_rng(1)
    noise = rng.uniform(size=(96, 24)).astype(np.float32)
    u = rng.uniform(size=(96, n_fine)).astype(np.float32)
    cfg = JTrainConfig(n_coarse=24, n_fine=n_fine)
    feed_uniform(monkeypatch, [noise, u])
    loss_j, g_j = jax.jit(jax.value_and_grad(jmake_loss_fn(jf, cfg, AABB)))(
        params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(rgb), jax.random.PRNGKey(0))
    monkeypatch.setattr(trender, "_draw_noise", lambda *a: (torch.as_tensor(noise),
                                                            torch.as_tensor(u) if n_fine else None))
    loss_t = make_loss_fn(tf, TrainConfig(n_coarse=24, n_fine=n_fine, batch_rays=96), AABB)(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(rgb), None)
    loss_t.backward()
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-5)
    g_t = _grads_by_flax_name(tf)
    p = g_j["params"]
    flat_j = {**{k: np.asarray(v) for k, v in p["encoding"].items()},
              **{f"{n}/{k}": np.asarray(v) for n in p if n != "encoding" for k, v in p[n].items()}}
    assert set(flat_j) == set(g_t)
    for k, gj in flat_j.items():
        scale = np.abs(gj).max()
        assert scale > 0, k
        np.testing.assert_allclose(g_t[k], gj, rtol=0, atol=5e-5 * scale, err_msg=k)


def test_adam_and_schedule_match_optax():
    """Three updates from the same gradients, at the training's (b2 0.99, eps
    1e-15) and at optax's defaults, with the exponential decay."""
    rng = np.random.default_rng(0)
    shapes = [(4, 7), (7, 1), (3,)]
    for kw in ({"b1": 0.9, "b2": 0.99, "eps": 1e-15}, {}):
        p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
        grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
        opt = optax.adam(optax.exponential_decay(1e-2, 10, 1e-4 / 1e-2), **kw)
        pj = [jnp.asarray(a) for a in p0]
        state = opt.init(pj)
        pt = [torch.tensor(a) for a in p0]
        adam = Adam(pt, lambda k: exponential_decay(1e-2, 10, 1e-4, k), **kw)
        for g in grads:
            upd, state = opt.update([jnp.asarray(a) for a in g], state, pj)
            pj = optax.apply_updates(pj, upd)
            for t, a in zip(pt, g):
                t.grad = torch.tensor(a)
            adam.step()
            for t, j in zip(pt, pj):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    sched = optax.exponential_decay(1e-2, 10, 1e-4 / 1e-2)
    for k in range(12):
        assert exponential_decay(1e-2, 10, 1e-4, k) == pytest.approx(float(sched(k)), rel=1e-6)


def test_train_runs_exactly_n_steps():
    """The single-step loop: n_steps steps, history and callback at every
    multiple of log_every (the JAX CPU scan may overshoot; this may not)."""
    ds = make_synthetic_dataset(sphere_scene, n_views=2, res=8, device="cpu")
    seen = []
    field, info = train(ds, AABB, TrainConfig(n_steps=7, batch_rays=32, n_coarse=8, n_fine=4, log_every=3),
                        field=init_field(1, device="cpu", **TINY), callback=lambda *a: seen.append(a[:2]))
    assert [s for s, _ in info["history"]] == [3, 6] == [s for s, _ in seen]
    assert all(np.isfinite(v) for _, v in info["history"])
    assert TrainConfig().weight_decay == JTrainConfig().weight_decay  # declared, applied by neither


def test_overfit_sphere():
    """tests/test_nerf.py::test_overfit_sphere through the port (150 steps:
    the loss under 0.02 and not above step 50's), and on the same field
    test_trained_depth_hits_sphere's bound (there after 300 steps): the
    depth at the image centre on the sphere's surface."""
    ds = make_synthetic_dataset(sphere_scene, n_views=8, res=32, device="cpu")
    cfg = TrainConfig(n_steps=150, batch_rays=1024, n_coarse=32, n_fine=0, lr=5e-3, log_every=50)
    field, info = train(ds, AABB, cfg, field=init_field(1, device="cpu", **TINY))
    hist = info["history"]
    assert hist[-1][1] < 0.02 and hist[-1][1] <= hist[0][1], hist
    with torch.no_grad():
        out = render_image(field, torch.as_tensor(ds.c2w[0]), ds.fx, ds.fy, ds.cx, ds.cy, ds.width, ds.height,
                           torch.as_tensor(AABB), RenderConfig(n_coarse=48, n_fine=0, chunk=1024))
    center_depth = float(out["depth"][ds.height // 2, ds.width // 2])
    assert 2.2 < center_depth < 3.2, center_depth
    assert psnr(out["rgba"][..., :3].numpy(), ds.images[0]) > 15.0


@pytest.mark.parametrize("bake", [False, True])
def test_testbed_over_a_jax_snapshot_matches_jax(tmp_path, bake):
    """A snapshot written by the JAX package, loaded (and baked) by both
    Testbeds: the Shade and Depth renders (16 + 8 samples) agree within 1e-5
    (measured 7.2e-7)."""
    jf, params, _ = pair(seed=2, scale=0.3, **TINY)
    snap = tmp_path / "w.npz"
    jsave_snapshot(snap, jf, params, extra={"aabb": [[0.25] * 3, [0.75] * 3]})
    tj, tt = JTestbed(), Testbed(device="cpu")
    for tb in (tj, tt):
        tb.load_snapshot(snap, bake=bake)
        assert tb.render_aabb.min == [0.25] * 3
        tb.n_coarse, tb.n_fine = 16, 8
        tb.fov = 40.0
        cam = np.eye(4)
        cam[2, 3] = 1.6
        tb.set_nerf_camera_matrix(cam[:3])
    assert (tt._baked is not None) == bake
    for mode in (RenderMode.Shade, RenderMode.Depth):
        tt.render_mode = mode
        tj.render_mode = type(tj.render_mode)[mode.name]
        a, b = tt.render(24, 20), tj.render(24, 20)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=str(mode))


def test_initialize_testbed_surface(tmp_path):
    """tests/test_nerf.py's facade test through the port, on a port snapshot."""
    from pixtrack_tpu_torch.nerf.snapshot import save_snapshot

    snap = tmp_path / "weights.msgpack"
    save_snapshot(snap, init_field(0, device="cpu", **TINY))
    tb = initialize_testbed(snap, aabb=[[0.2] * 3, [0.8] * 3], device="cpu")
    assert tb.nerf.rendering_min_transmittance == 1e-7 and tb.render_aabb.min == [0.2] * 3
    assert tb.field is not None and tb._baked is not None  # baked on load
    tb.n_coarse, tb.n_fine = 16, 0
    cam = np.eye(4)
    cam[2, 3] = 3.0
    tb.set_nerf_camera_matrix(cam[:3])
    img = tb.render(32, 24)
    assert img.shape == (24, 32, 4) and img.dtype == np.float32 and np.isfinite(img).all()
    tb.render_mode = RenderMode.Depth
    dimg = tb.render(32, 24, spp=2)
    np.testing.assert_allclose(dimg[..., 0], dimg[..., 1])


def test_kernels_refuse_to_train():
    """K1 and K2 have no backward: with grad mode on and a weight or an input
    requiring grad they raise (on the CPU too, so that a path that would
    train through them fails before it reaches the card); under no_grad, or
    with fused=False, the same field renders."""
    field = init_distilled(0, octaves=8, device="cpu")
    for p in field.layers():
        p["kernel"].requires_grad_(True)
    o = torch.tensor([[0.0, 0.0, 3.0]] * 4)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    aabb = torch.tensor([[0.0] * 3, [1.0] * 3])
    for cfg in (RenderConfig(n_coarse=8, n_fine=0), RenderConfig(n_coarse=8, n_fine=4)):
        with pytest.raises(RuntimeError, match="no backward"):
            render_rays(field, o, d, aabb, cfg)
        with torch.no_grad():
            render_rays(field, o, d, aabb, cfg)
        out = render_rays(field, o, d, aabb, RenderConfig(n_coarse=8, n_fine=cfg.n_fine, fused=False))
        out["rgb"].sum().backward()
        assert field.trunk[0]["kernel"].grad is not None


def test_kernel_weights_follow_in_place_updates():
    """The kernels' packed weights are rebuilt after an in-place update of the
    field's tensors (an optimizer step) and after a tensor is replaced."""
    field = init_distilled(0, octaves=10, device="cpu")
    cpu = torch.device("cpu")
    w0 = fused_mlp._pack_weights(field, cpu)[2].clone()
    assert fused_mlp._pack_weights(field, cpu)[2] is fused_mlp._pack_weights(field, cpu)[2]  # cached
    with torch.no_grad():
        field.trunk[1]["kernel"].mul_(2.0)
    w1 = fused_mlp._pack_weights(field, cpu)[2]
    assert not torch.equal(w0, w1)
    field.head["bias"] = field.head["bias"] + 1.0
    b = fused_mlp._pack_weights(field, cpu)[3]
    assert torch.equal(b[128 * 4 : 128 * 4 + 16], field.head["bias"].reshape(-1))


def test_asset_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The asset path's entry points ask for the CUDA card unless a device is
    named, and raise without one."""
    from pixtrack_tpu_torch.nerf.snapshot import load_snapshot, save_snapshot

    ds = make_synthetic_dataset(sphere_scene, n_views=1, res=4, device="cpu")
    save_snapshot(tmp_path / "w.npz", init_field(0, device="cpu", **TINY))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: init_field(0), lambda: make_synthetic_dataset(sphere_scene, n_views=1, res=4), ds.all_rays,
             lambda: load_snapshot(tmp_path / "w.npz"), lambda: train(ds, AABB, TrainConfig(n_steps=1)),
             lambda: init_distilled(0)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
