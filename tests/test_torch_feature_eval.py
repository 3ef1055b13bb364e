"""Parity of the port's held-out alignment benchmark
(``pixtrack_tpu_torch/features/evaluate.py``) with the JAX package on the
CPU: one held-out scene from JAX's draws (``split(key, 7)`` in
``make_eval_scene``, fed to the port as in ``tests/test_torch_train_basin.py``)
1e-5 [measured 6.1e-6], and ``evaluate_extractor`` on JAX's own scenes at the
``tests/test_learned_features.py`` setting (the shipped UNet in f32 on both
sides, and the handcrafted pyramid): every start's final rotation within
1e-3 deg and translation within 1e-5 of JAX's [3.5e-4 deg, 7.8e-6], the LM
parity of ``tests/test_torch_align.py``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pixtrack_tpu.features.evaluate as jeval
from pixtrack_tpu.align.lm import AlignConfig as JAlignConfig
from pixtrack_tpu.features import FeatureExtractor as JExtractor
from pixtrack_tpu.features import HandcraftedExtractor as JHandcrafted
from pixtrack_tpu.features.train import load_unet_weights as jload_unet
from pixtrack_tpu.features.unet import UNetExtractor as JUNet
from pixtrack_tpu_torch.align.lm import AlignConfig
from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
from pixtrack_tpu_torch.features.evaluate import (
    FeatureEvalConfig,
    converged,
    evaluate_starts,
    make_eval_scene,
    summarize,
)
from pixtrack_tpu_torch.features.unet import load_unet_weights
from pixtrack_tpu_torch.geometry import Camera
from test_torch_feature_train import _t
from test_torch_train_basin import _cam, _tp, jax_eval_scene_draws

torch.set_num_threads(2)
WEIGHTS = Path(__file__).resolve().parents[1] / "assets" / "unet_basin.npz"


def test_eval_scene_matches_jax():
    cfg = FeatureEvalConfig(size=48, tex_size=64, n_points=32)
    key = jax.random.PRNGKey(9)
    j = jeval.make_eval_scene(key, cfg)
    t = make_eval_scene(cfg, device="cpu", draws=_t(jax_eval_scene_draws(key, cfg)))
    for a, b in zip((t[0], t[1], t[4], t[6]), (j[0], j[1], j[4], j[6])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for a, b in ((t[2], j[2]), (t[3], j[3])):
        np.testing.assert_allclose(a.R.numpy(), np.asarray(b.R), atol=1e-5)
        np.testing.assert_allclose(a.t.numpy(), np.asarray(b.t), atol=1e-5)


def test_evaluate_extractor_matches_jax(monkeypatch):
    """JAX's evaluate_extractor at the tests/test_learned_features.py setting,
    its scenes and per-start outcomes recorded, then the port on the same
    scenes: the shipped UNet in f32 on both sides, and the handcrafted
    pyramid."""
    cfg = FeatureEvalConfig(n_scenes=2, n_perturb=2, seed=2000)
    j_acfg, acfg = JAlignConfig(num_iters=60, robust_c=1.0), AlignConfig(num_iters=60, robust_c=1.0)
    scenes, finals = [], []
    make_scene, perturb, align = jeval.make_eval_scene, jeval._perturbations, jeval.align_pyramid

    def rec_scene(key, c):
        out = make_scene(key, c)
        scenes.append({"img_ref": out[0], "img_qry": out[1], "T_ref": out[2], "T_gt": out[3], "p3d": out[4],
                       "camera": out[5]})
        return out

    def rec_perturb(key, c, d):
        scenes[-1]["deltas"] = perturb(key, c, d)
        return scenes[-1]["deltas"]

    def rec_align(T0, levels, camera, c):
        out = align(T0, levels, camera, c)
        finals.append(out[0].T)
        return out

    monkeypatch.setattr(jeval, "make_eval_scene", rec_scene)
    monkeypatch.setattr(jeval, "_perturbations", rec_perturb)
    monkeypatch.setattr(jeval, "align_pyramid", rec_align)
    _, jparams = jload_unet(WEIGHTS)
    j_ex = {"unet": JExtractor(JUNet(dtype=jnp.float32), params=jparams, resize=None),
            "handcrafted": JExtractor(JHandcrafted(), resize=None)}
    t_ex = {"unet": FeatureExtractor(load_unet_weights(WEIGHTS, device="cpu", dtype=torch.float32), resize=None),
            "handcrafted": FeatureExtractor(HandcraftedExtractor(device="cpu"), resize=None)}
    for name in ("unet", "handcrafted"):
        scenes.clear(), finals.clear()
        j_res = jeval.evaluate_extractor(lambda im, ex=j_ex[name]: ex(im), cfg, j_acfg)
        t_scenes = [{"img_ref": _t(s["img_ref"]), "img_qry": _t(s["img_qry"]), "T_ref": _tp(s["T_ref"]),
                     "T_gt": _tp(s["T_gt"]), "p3d": _t(s["p3d"]), "camera": Camera.pinhole(*_cam(cfg.size)),
                     "deltas": _t(s["deltas"])} for s in scenes]
        starts = evaluate_starts(t_ex[name], cfg, acfg, device="cpu", scenes=t_scenes)
        res = summarize(starts)
        j_rot = np.array([float((T @ s["T_gt"].inv()).magnitude()[0]) for T, s in
                          zip(finals, [s for s in scenes for _ in range(cfg.n_perturb)])])
        j_t = np.array([float((T @ s["T_gt"].inv()).magnitude()[1]) for T, s in
                        zip(finals, [s for s in scenes for _ in range(cfg.n_perturb)])])
        np.testing.assert_allclose(starts["rot"], j_rot, atol=1e-3, err_msg=name)
        np.testing.assert_allclose(starts["t"], j_t, atol=1e-5, err_msg=name)
        for k in ("rot_init_mean", "t_init_mean"):
            np.testing.assert_allclose(res[k], j_res[k], rtol=1e-5)
        assert res["convergence_rate"] == j_res["convergence_rate"] and res["n"] == j_res["n"] == 4
        assert converged(starts).dtype == bool
