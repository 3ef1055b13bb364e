"""Parity of the port's basin training
(``pixtrack_tpu_torch/features/train_basin.py`` and
``align/lm.py::_residuals_and_jacobian``) with the JAX package on the CPU,
the UNet in f32 on both sides.

JAX's draws are fed to the port: the test rebuilds JAX's key tree
(``split(key, batch)`` in the loss, ``split(key, 11)`` in ``one_scene``,
``split(key, 7)`` in ``make_eval_scene``, ``split(key, 3)`` / ``(key, 6)`` in
the drawing functions) and passes the canonical draws, which the port maps
as jax.random maps its own. That includes the reference's two reused keys
(a texture's signs from its magnitudes' uniform; the noise's first entry
from the amplitude's uniform), which the port keeps.

Tolerances (measured gaps in brackets): the scene functions 1e-5 on images
in [0, 1] [render 1.8e-6, textures 2.1e-6, blur 8.9e-7, nuisances 1.1e-6];
``_residuals_and_jacobian`` 1e-5 [7.6e-6 on J's entries] and its gradients
into the map, the confidences and the reference features and weights 1e-5
of each leaf's largest entry [1.3e-7]. One basin loss 1e-5 relative
[1.4e-6] in f32; its gradients within 5e-5 of each leaf's largest entry
[2.2e-6], in f64 on both sides. Three optimizer steps from the same init and
draws, in f64 on both sides: losses 1e-6 relative [2.7e-7], parameters
within 3e-4 on 99.9 % of a leaf's entries [1.6e-4] and two learning rates on
all [1.2e-3] (the fine-tune rule of ``tests/test_torch_distill_train.py``:
Adam's first steps are sign-like, so a gradient entry near zero can step
either way, and JAX's heads return f32 even in an f64 model). One
clip-plus-Adam update against optax's 1e-6 [1.5e-8]. The held-out
benchmark's parity is in ``tests/test_torch_feature_eval.py``.

The UNet's f32 gradients are ill-conditioned (``tests/test_torch_feature_train.py``:
JAX's own f32 InfoNCE gradient lies up to 4 % of a leaf's largest entry
from the f64 one; the port's f32 basin gradient 1.3e-4 here), and oneDNN's
convolution backward on the CPU adds up to 2e-3. So the gradient
comparisons run both packages in f64 with oneDNN off, where they hold the
functions to each other rather than two roundings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pixtrack_tpu.features.train_basin as jbasin
from pixtrack_tpu.align.lm import AlignConfig as JAlignConfig
from pixtrack_tpu.align.lm import LevelData as JLevelData
from pixtrack_tpu.align.lm import _residuals_and_jacobian as j_res_jac
from pixtrack_tpu.features.unet import UNetExtractor as JUNet
from pixtrack_tpu.features.unet import init_unet as jinit_unet
from pixtrack_tpu.geometry import Camera as JCamera
from pixtrack_tpu.geometry import Pose as JPose
from pixtrack_tpu_torch.align.lm import AlignConfig, LevelData, _residuals_and_jacobian
from pixtrack_tpu_torch.features.train_basin import (
    BasinTrainConfig,
    _blur_traced,
    _look_at_w2c,
    apply_nuisances,
    clip_by_global_norm,
    make_basin_loss_fn,
    random_texture,
    render_plane,
    train_basin_features,
)
from pixtrack_tpu_torch.features.unet import unet_state_dict_from_flax
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.nerf.optim import Adam
from test_torch_feature_train import _port_unet, _t, assert_grads_match, f64

U, N = jax.random.uniform, jax.random.normal
torch.set_num_threads(2)
SMALL = BasinTrainConfig(batch=1, n_perturb=2, size=48, tex_size=64, n_points=32, k_steps=2, log_every=1)


# ------------------------------------------------------- JAX's key tree ---
def jax_texture_draws(key, n_modes=48):
    kf, ka, kp = jax.random.split(key, 3)
    return {"freqs": U(kf, (3, n_modes, 2)), "amps": N(ka, (3, n_modes)), "phases": U(kp, (3, n_modes))}


def jax_nuisance_draws(key, size, n_occluders):
    kg, kb, kgam, kn, ks, ko = jax.random.split(key, 6)
    pos, sz = [], []
    for _ in range(n_occluders):
        kpos, ksz, ko = jax.random.split(ko, 3)
        pos.append(U(kpos, (2,)))
        sz.append(U(ksz, (2,)))
    return {"gain": N(kg, (3,)), "bias": N(kb, (3,)), "gamma": N(kgam, ()), "sigma": U(ks, ()),
            "noise_amp": U(kn, ()), "noise": N(kn, (size, size, 3)),
            "occ_pos": jnp.stack(pos), "occ_size": jnp.stack(sz)}


def jax_pose_draws(k_pose):
    return jnp.stack([U(k, ()) for k in jax.random.split(k_pose, 3)])


def jax_perturbation_draws(key, n_perturb):
    kw, kv, km = jax.random.split(key, 3)
    return {"w": N(kw, (n_perturb, 3)), "v": N(kv, (n_perturb, 3)), "m": U(km, (n_perturb, 2))}


def jax_scene_draws(key, cfg):
    """The port's draws of ``one_scene(params, key)``."""
    (k_tex, k_bg, k_pose, k_roll, k_pts, k_ref, k_nui, k_pert, k_smooth, k_qbg, k_rbg) = jax.random.split(key, 11)
    return {"texture": jax_texture_draws(k_tex), "clutter": jax_texture_draws(k_bg), "smooth": U(k_smooth, ()),
            "pose": jax_pose_draws(k_pose), "roll": U(k_roll, ()), "ref": N(k_ref, (6,)),
            "points": U(k_pts, (cfg.n_points, 2)), "nuisance": jax_nuisance_draws(k_nui, cfg.size, cfg.n_occluders),
            "perturb": jax_perturbation_draws(k_pert, cfg.n_perturb),
            "qbg": jax.random.randint(k_qbg, (), 0, 4), "rbg": jax.random.randint(k_rbg, (), 0, 2)}


def jax_loss_draws(key, cfg):
    """The port's draws of ``make_basin_loss_fn(model, cfg)(params, key)``."""
    scenes = [jax_scene_draws(k, cfg) for k in jax.random.split(key, cfg.batch)]
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *scenes)


def jax_eval_scene_draws(key, cfg):
    (k_tex, k_bg, k_pose, k_roll, k_pts, k_ref, k_nui) = jax.random.split(key, 7)
    return {"texture": jax_texture_draws(k_tex), "clutter": jax_texture_draws(k_bg), "pose": jax_pose_draws(k_pose),
            "roll": U(k_roll, ()), "ref": N(k_ref, (6,)), "points": U(k_pts, (cfg.n_points, 2)),
            "nuisance": jax_nuisance_draws(k_nui, cfg.size, cfg.n_occluders)}


def _tp(T: JPose) -> Pose:
    return Pose(R=torch.as_tensor(np.array(T.R)), t=torch.as_tensor(np.array(T.t)))


def _cam(size):
    return (size * 1.2, size * 1.2, (size - 1) / 2, (size - 1) / 2, size, size)


# ---------------------------------------------------------------- scenes ---
def test_scene_functions_match_jax():
    cfg = BasinTrainConfig(size=48, tex_size=64)
    key = jax.random.PRNGKey(4)
    k_tex, k_bg, k_nui, k_c = jax.random.split(key, 4)
    # random_texture with a freq_scale, and the sign quirk
    j_tex = jbasin.random_texture(k_tex, 64, freq_scale=0.3)
    d_tex = _t(jax_texture_draws(k_tex))
    t_tex = random_texture(64, freq_scale=torch.tensor(0.3), device="cpu", draws=d_tex)
    np.testing.assert_allclose(t_tex.numpy(), np.asarray(j_tex), atol=1e-5)
    clutter = jbasin.random_texture(k_bg, 48)
    # the look-at and the render, clean (white) and over clutter
    center = jnp.asarray([0.3, -0.4, 1.5])
    j_T = jbasin._look_at_w2c(center, jnp.float32(0.7))
    t_T = _look_at_w2c(torch.tensor([0.3, -0.4, 1.5]), torch.tensor(0.7))
    np.testing.assert_allclose(t_T.R.numpy(), np.asarray(j_T.R), atol=1e-6)
    np.testing.assert_allclose(t_T.t.numpy(), np.asarray(j_T.t), atol=1e-6)
    jc, tc = JCamera.pinhole(*_cam(48)), Camera.pinhole(*_cam(48))
    for bg in (None, clutter):
        j_img = jbasin.render_plane(j_tex, bg, j_T, jc, (48, 48))
        t_img = render_plane(t_tex, None if bg is None else _t(bg), t_T, tc, (48, 48))
        np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-5)
    # a batch of two renders is the two renders
    t2 = render_plane(torch.stack([t_tex, t_tex]), torch.stack([_t(clutter)] * 2),
                      Pose(R=torch.stack([t_T.R, t_T.R]), t=torch.stack([t_T.t, t_T.t])), tc, (48, 48))
    np.testing.assert_allclose(t2[1].numpy(), t_img.numpy(), atol=1e-6)
    # the traced blur and the nuisances
    np.testing.assert_allclose(_blur_traced(t_img, torch.tensor(1.1)).numpy(),
                               np.asarray(jbasin._blur_traced(j_img, jnp.float32(1.1))), atol=1e-5)
    j_q = jbasin.apply_nuisances(k_nui, j_img, clutter, cfg)
    t_q = apply_nuisances(t_img, _t(clutter), cfg, draws=_t(jax_nuisance_draws(k_nui, 48, cfg.n_occluders)))
    np.testing.assert_allclose(t_q.numpy(), np.asarray(j_q), atol=1e-5)


# ------------------------------------------------------------ residuals ---
def _level(seed, H=40, W=48, C=6, n=64):
    rng = np.random.default_rng(seed)
    fmap = rng.normal(size=(H, W, C)).astype(np.float32)
    conf = rng.uniform(0, 1, (H, W)).astype(np.float32)
    p3d = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)), rng.uniform(1.5, 2.5, (n, 1))], 1).astype(np.float32)
    f_ref = rng.normal(size=(n, C)).astype(np.float32)
    w_ref = rng.uniform(0.2, 1.0, n).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    return fmap, conf, p3d, f_ref, w_ref, mask


def test_residuals_and_jacobian_match_jax():
    fmap, conf, p3d, f_ref, w_ref, mask = _level(0)
    scale = np.array([0.5, 0.5], np.float32)
    cam = (60.0, 60.0, 47.5, 39.5, 96, 80)
    w, t = np.array([0.02, -0.01, 0.03], np.float32), np.array([0.01, 0.02, -0.03], np.float32)
    jT, jcam, jcfg = JPose.from_aa_t(w, t), JCamera.pinhole(*cam), JAlignConfig(robust_c=1.0)
    tT, tcam, tcfg = Pose.from_aa_t(w, t), Camera.pinhole(*cam), AlignConfig(robust_c=1.0)

    def jax_fn(fm, cf, fr, wr):
        data = JLevelData(p3d=jnp.asarray(p3d), f_ref=fr, w_ref=wr, mask=jnp.asarray(mask), fmap=fm, conf=cf,
                          scale=jnp.asarray(scale))
        return j_res_jac(jT, data, jcam, jcfg)

    j_out = jax_fn(*map(jnp.asarray, (fmap, conf, f_ref, w_ref)))
    leaves = [torch.as_tensor(a).requires_grad_() for a in (fmap, conf, f_ref, w_ref)]
    data = LevelData(p3d=torch.as_tensor(p3d), f_ref=leaves[2], w_ref=leaves[3], mask=torch.as_tensor(mask),
                     fmap=leaves[0], conf=leaves[1], scale=torch.as_tensor(scale))
    r, J, wt, valid, (e2, w_static) = _residuals_and_jacobian(tT, data, tcam, tcfg)
    assert valid.sum() > 40
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_out[3]))
    for a, b in ((r, j_out[0]), (J, j_out[1]), (wt, j_out[2]), (e2, j_out[4][0]), (w_static, j_out[4][1])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)

    # autograd into the map, the confidences and the reference features and weights
    def scalar(r, J, w):
        return (r * w[:, None]).sum() + (J * J).sum() * 1e-3 + w.sum()

    j_grads = jax.grad(lambda *a: scalar(*[jax_fn(*a)[i] for i in range(3)]), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (fmap, conf, f_ref, w_ref)))
    scalar(r, J, wt).backward()
    for leaf, g in zip(leaves, j_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(leaf.grad.numpy(), g, atol=1e-5 * np.abs(g).max())

    # starts as a batch axis of the pose, and scenes as a batch axis of the data
    deltas = torch.tensor([[0.0] * 6, [0.01, 0.0, -0.02, 0.01, 0.0, 0.0], [0.0, 0.03, 0.0, 0.0, -0.01, 0.02]])
    Ts = Pose.exp(deltas) @ Pose(R=tT.R.expand(3, 3, 3), t=tT.t.expand(3, 3))
    rb, Jb, wb, vb, _ = _residuals_and_jacobian(Ts, data, tcam, tcfg)
    stacked = LevelData(**{k: (v if k == "scale" else torch.stack([v.detach()] * 2))
                           for k, v in vars(data).items()})
    Tss = Pose(R=torch.stack([Ts.R] * 2), t=torch.stack([Ts.t] * 2))
    rs, Js, ws, vs, _ = _residuals_and_jacobian(Tss, stacked, tcam, tcfg)
    for i in range(3):
        one = _residuals_and_jacobian(Pose(R=Ts.R[i], t=Ts.t[i]), data, tcam, tcfg)
        for a, b, c in ((rb[i], rs[1, i], one[0]), (Jb[i], Js[1, i], one[1]), (wb[i], ws[1, i], one[2])):
            np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(), atol=1e-6)
            np.testing.assert_allclose(b.detach().numpy(), c.detach().numpy(), atol=1e-6)


# ------------------------------------------------------------- training ---
@pytest.fixture(scope="module")
def init48():
    return jinit_unet(jax.random.PRNGKey(0), 48, 48, dtype=jnp.float32)


def test_basin_loss_and_gradients_match_jax(init48):
    """The loss in f32 on both sides; its gradients in f64 on both sides."""
    _, params = init48
    key = jax.random.PRNGKey(21)
    j_loss = jax.jit(jbasin.make_basin_loss_fn(JUNet(dtype=jnp.float32), SMALL))(params, key)
    with torch.no_grad():
        loss = make_basin_loss_fn(_port_unet(params), SMALL)(draws=_t(jax_loss_draws(key, SMALL)))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    with f64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        # unrolled: JAX's scan carries an f32 accumulator, which x64 promotes
        unrolled = dataclasses.replace(SMALL, scan_steps=False)
        _, j_grads = jax.jit(jax.value_and_grad(jbasin.make_basin_loss_fn(JUNet(dtype=jnp.float64), unrolled)))(
            p64, key)
        model = _port_unet(params, torch.float64)
        with torch.backends.mkldnn.flags(enabled=False):
            loss = make_basin_loss_fn(model, SMALL)(draws=_t(jax_loss_draws(key, SMALL)))
            loss.backward()
    assert_grads_match(model, j_grads)


def test_train_basin_steps_match_jax(init48, monkeypatch):
    """Three steps of train_basin_features from the same init and draws, in
    f64 on both sides (JAX's trainer builds its model through init_unet,
    patched here to f64)."""
    _, params = init48
    cfg = dataclasses.replace(SMALL, n_steps=3, scan_steps=False)
    monkeypatch.setattr(jbasin, "init_unet", lambda key, h, w: jinit_unet(key, h, w, dtype=jnp.float64))
    with f64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        _, j_params, j_info = jbasin.train_basin_features(cfg, seed=0, params=p64)
        key, draws = jax.random.PRNGKey(1), []
        for _ in range(cfg.n_steps):
            k, key = jax.random.split(key)
            draws.append(_t(jax_loss_draws(k, cfg)))
        with torch.backends.mkldnn.flags(enabled=False):
            model, info = train_basin_features(cfg, model=_port_unet(params, torch.float64), device="cpu",
                                               draws=draws)
    for (_, a), (_, b) in zip(info["history"], j_info["history"]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    ref = unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, j_params))
    for name, p in model.state_dict().items():
        err = np.abs(p.numpy() - ref[name].numpy())
        assert np.quantile(err, 0.999) <= 3e-4 and err.max() <= 2 * cfg.lr, (name, np.quantile(err, 0.999), err.max())
    assert all(np.isfinite(g) for _, g in info["grad_norms"])


def test_clip_and_adam_match_optax():
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    for scale in (0.1, 10.0):   # below and above the clip
        params = [rng.normal(size=s).astype(np.float32) for s in shapes]
        grads = [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
        opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
        state = opt.init(params)
        upd, _ = opt.update([jnp.asarray(g) for g in grads], state, params)
        ref = optax.apply_updates(params, upd)
        tp = [torch.tensor(p, requires_grad=True) for p in params]
        for p, g in zip(tp, grads):
            p.grad = torch.tensor(g)
        norm = clip_by_global_norm(tp, 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        Adam(tp, lambda k: 1e-3).step()
        for a, b in zip(tp, ref):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6)
