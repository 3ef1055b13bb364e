"""Feature-quality benchmark: the production aligner's convergence on
held-out nuisance scenes.

Port of ``pixtrack_tpu/features/evaluate.py``: the production LM
(``align.lm.align_pyramid``, early stop and robust weights) runs from
sampled pose perturbations on textured-plane scenes with the tracking
nuisances (``train_basin.apply_nuisances``), and a pyramid is better where
the aligner lands nearer the ground truth from the same starts. The scenes
come from a generator seeded ``cfg.seed``, or are given: the JAX package's
own held-out scenes, stored by ``scripts_dev/evaluate_jax.py``, since the
port's generator cannot draw JAX's numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch._draws import _rand, _randn
from pixtrack_tpu_torch.align.lm import AlignConfig, align_pyramid
from pixtrack_tpu_torch.align.observations import build_level_data, observe_points
from pixtrack_tpu_torch.features.train_basin import (
    BasinTrainConfig,
    _perturbation_deltas,
    _plane_points,
    _scene_poses,
    apply_nuisances,
    nuisance_draws,
    perturbation_draws,
    plane_camera,
    random_texture,
    render_plane,
    texture_draws,
)


@dataclasses.dataclass(frozen=True)
class FeatureEvalConfig:
    n_scenes: int = 16
    n_perturb: int = 4          # starts per scene
    size: int = 192
    tex_size: int = 256
    n_points: int = 512
    rot_deg: Tuple[float, float] = (2.0, 8.0)
    trans_frac: Tuple[float, float] = (0.01, 0.04)
    ref_rot_deg: float = 3.0
    max_blur_sigma: float = 1.5
    max_noise: float = 0.04
    n_occluders: int = 2
    max_occluder_frac: float = 0.3
    seed: int = 1000            # held out from training (the trainer uses seed + 1)


def _nuisance_cfg(cfg: FeatureEvalConfig) -> BasinTrainConfig:
    return BasinTrainConfig(
        size=cfg.size, tex_size=cfg.tex_size, n_points=cfg.n_points,
        max_blur_sigma=cfg.max_blur_sigma, max_noise=cfg.max_noise,
        n_occluders=cfg.n_occluders, max_occluder_frac=cfg.max_occluder_frac,
    )


def eval_scene_draws(cfg: FeatureEvalConfig, generator=None, device=None) -> dict:
    """One held-out scene's draws, as ``train_basin.scene_draws`` names them."""
    return {"texture": texture_draws((), 48, generator, device), "clutter": texture_draws((), 48, generator, device),
            "pose": _rand(generator, device, 3), "roll": _rand(generator, device), "ref": _randn(generator, device, 6),
            "points": _rand(generator, device, cfg.n_points, 2),
            "nuisance": nuisance_draws((), cfg.size, cfg.n_occluders, generator, device)}


def make_eval_scene(cfg: FeatureEvalConfig, generator=None, device=None, draws: Optional[dict] = None):
    """One held-out scene: (img_ref, img_qry, T_ref, T_gt, p3d, camera, d),
    the training scene's construction with a white reference background,
    a clutter query background and ``freq_scale`` 1."""
    device = resolve(device)
    d = draws or eval_scene_draws(cfg, generator, device)
    size = cfg.size
    camera = plane_camera(size, device)
    texture = random_texture(cfg.tex_size, device=device, draws=d["texture"])
    clutter = random_texture(size, device=device, draws=d["clutter"])
    T_gt, T_ref, dist = _scene_poses(d, cfg.ref_rot_deg)
    img_ref = render_plane(texture, None, T_ref, camera, (size, size))
    img_qry = render_plane(texture, clutter, T_gt, camera, (size, size))
    img_qry = apply_nuisances(img_qry, clutter, _nuisance_cfg(cfg), draws=d["nuisance"])
    return img_ref, img_qry, T_ref, T_gt, _plane_points(d["points"]), camera, dist


def _perturbations(cfg: FeatureEvalConfig, d, generator=None, draws: Optional[dict] = None) -> torch.Tensor:
    """(n_perturb, 6) start offsets for a scene at camera distance ``d``."""
    dr = draws or perturbation_draws((), cfg.n_perturb, generator, d.device)
    return _perturbation_deltas(dr, cfg.rot_deg, cfg.trans_frac, torch.as_tensor(d))


def load_scenes(path, device=None) -> list:
    """Held-out scenes stored by ``scripts_dev/evaluate_jax.py`` (the JAX
    package's own draws: ``scene_*`` arrays, images in f16, and the camera's
    fx, fy, cx, cy, width, height) as ``evaluate_starts`` takes them, on
    ``device`` (None is the CUDA card)."""
    device = resolve(device)
    from pixtrack_tpu_torch.geometry import Camera, Pose

    with np.load(path) as z:
        sc = {k[len("scene_"):]: z[k] for k in z.files if k.startswith("scene_")}
        camera = Camera.pinhole(*[float(v) for v in z["camera"]], device=device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return [{"img_ref": t(sc["img_ref"][s]), "img_qry": t(sc["img_qry"][s]),
             "T_ref": Pose(R=t(sc["R_ref"][s]), t=t(sc["t_ref"][s])),
             "T_gt": Pose(R=t(sc["R_gt"][s]), t=t(sc["t_gt"][s])),
             "p3d": t(sc["p3d"][s]), "camera": camera, "deltas": t(sc["deltas"][s])}
            for s in range(len(sc["img_ref"]))]


def evaluate_starts(
    extract: Callable,
    cfg: FeatureEvalConfig = FeatureEvalConfig(),
    align_cfg: Optional[AlignConfig] = None,
    device=None,
    scenes: Optional[Sequence[dict]] = None,
) -> dict:
    """Per start: the initial and final rotation (deg) and translation
    errors, as numpy arrays of length n_scenes x n_perturb. ``extract(img)
    -> FeaturePyramid``. ``scenes``: dicts with img_ref, img_qry, T_ref, T_gt,
    p3d, camera and deltas (n_perturb, 6); else ``cfg.n_scenes`` scenes from
    a generator seeded ``cfg.seed`` on ``device`` (None is the CUDA card)."""
    device = resolve(device)
    acfg = align_cfg or AlignConfig(num_iters=100, robust_c=1.0)
    if scenes is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        scenes = []
        for _ in range(cfg.n_scenes):
            img_ref, img_qry, T_ref, T_gt, p3d, camera, d = make_eval_scene(cfg, gen, device)
            scenes.append({"img_ref": img_ref, "img_qry": img_qry, "T_ref": T_ref, "T_gt": T_gt, "p3d": p3d,
                           "camera": camera, "deltas": _perturbations(cfg, d, gen)})
    errs = []
    for sc in scenes:
        camera, T_gt, p3d = sc["camera"], sc["T_gt"], sc["p3d"]
        pmask = torch.ones(p3d.shape[0], dtype=torch.bool, device=p3d.device)
        f_ref, w_ref, v_ref = observe_points(extract(sc["img_ref"]), sc["T_ref"], camera, p3d, pmask)
        levels = build_level_data(extract(sc["img_qry"]), f_ref, w_ref, v_ref, p3d, pmask)
        for delta in sc["deltas"]:
            T0 = T_gt.retract(delta)
            final, _ = align_pyramid(T0, levels, camera, acfg)
            errs.append(torch.stack([*(T0 @ T_gt.inv()).magnitude(), *(final.T @ T_gt.inv()).magnitude()]))
    e = torch.stack(errs).double().cpu().numpy()
    return {"rot_init": e[:, 0], "t_init": e[:, 1], "rot": e[:, 2], "t": e[:, 3]}


def converged(starts: dict) -> np.ndarray:
    """Final rotation error < 1 deg and < 25 % of the initial one."""
    return (starts["rot"] < 1.0) & (starts["rot"] < 0.25 * np.maximum(starts["rot_init"], 1e-6))


def summarize(starts: dict) -> dict:
    """The JAX package's result dict of per-start errors."""
    fin_R, fin_t = starts["rot"], starts["t"]
    return {
        "rot_err_mean": float(fin_R.mean()),
        "rot_err_median": float(np.median(fin_R)),
        "t_err_mean": float(fin_t.mean()),
        "t_err_median": float(np.median(fin_t)),
        "rot_init_mean": float(starts["rot_init"].mean()),
        "t_init_mean": float(starts["t_init"].mean()),
        "convergence_rate": float(converged(starts).mean()),
        "n": int(fin_R.size),
    }


def evaluate_extractor(
    extract: Callable,
    cfg: FeatureEvalConfig = FeatureEvalConfig(),
    align_cfg: Optional[AlignConfig] = None,
    device=None,
    scenes: Optional[Sequence[dict]] = None,
) -> dict:
    """Benchmark one extractor, ``extract(img) -> FeaturePyramid``: mean and
    median final rotation (deg) and translation errors, the initial means,
    and the convergence rate (final rotation error < 1 deg and < 25 % of
    the initial one), over the starts of :func:`evaluate_starts`."""
    return summarize(evaluate_starts(extract, cfg, align_cfg, device, scenes))
