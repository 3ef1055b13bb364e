"""The JAX package's held-out alignment benchmark, on the CPU, stored for the
card.

``chip_smoke.py`` phase 36 runs the port's ``evaluate_extractor`` on the
card, which has no JAX, so it cannot draw the JAX package's held-out scenes.
This script draws them and records JAX's outcome on them:

- ``jax``: the 12 scenes of ``FeatureEvalConfig(n_scenes=12, n_perturb=4)``
  (seed 1000, the key tree of ``features/evaluate.py::evaluate_extractor``:
  reference and query images stored as f16, T_ref, T_gt, the points, the
  camera, the 4 perturbations of each), then the JAX package's per-start
  outcome on the stored (f16-rounded) images for the shipped UNet
  (``assets/unet_basin.npz``, bf16 as shipped) and the handcrafted pyramid,
  with the production LM (``AlignConfig(num_iters=100, robust_c=1.0)``);
  writes ``scripts_dev/evaluate_jax.npz`` (3.3 MB). About 5 min of CPU.
- ``compare``: the port on the CPU on the stored scenes, both extractors
  (the UNet in bf16, as on the card), start by start against JAX's: the
  share of equal converged flags and the convergence counts, which set
  phase 36's rule. About 1 min of CPU.

    JAX_PLATFORMS=cpu python scripts_dev/evaluate_jax.py jax
    JAX_PLATFORMS=cpu python scripts_dev/evaluate_jax.py compare
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "scripts_dev" / "evaluate_jax.npz"
N_SCENES, N_PERTURB, SEED, NUM_ITERS = 12, 4, 1000, 100
EXTRACTORS = ("unet_basin", "handcrafted")


def converged(rot, rot_init):
    return (rot < 1.0) & (rot < 0.25 * np.maximum(rot_init, 1e-6))


def run_jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pixtrack_tpu.align.lm import AlignConfig, align_pyramid
    from pixtrack_tpu.align.observations import build_level_data, observe_points
    from pixtrack_tpu.features import FeatureExtractor, HandcraftedExtractor
    from pixtrack_tpu.features.evaluate import FeatureEvalConfig, _perturbations, make_eval_scene
    from pixtrack_tpu.features.train import load_unet_weights
    from pixtrack_tpu.geometry import Pose

    cfg = FeatureEvalConfig(n_scenes=N_SCENES, n_perturb=N_PERTURB, seed=SEED)
    key = jax.random.PRNGKey(cfg.seed)
    sc = {k: [] for k in ("img_ref", "img_qry", "R_ref", "t_ref", "R_gt", "t_gt", "p3d", "deltas", "dist")}
    for _ in range(cfg.n_scenes):
        key, k_scene, k_pert = jax.random.split(key, 3)
        img_ref, img_qry, T_ref, T_gt, p3d, camera, d = make_eval_scene(k_scene, cfg)
        for name, v in (("img_ref", np.asarray(img_ref, np.float16)), ("img_qry", np.asarray(img_qry, np.float16)),
                        ("R_ref", T_ref.R), ("t_ref", T_ref.t), ("R_gt", T_gt.R), ("t_gt", T_gt.t), ("p3d", p3d),
                        ("deltas", _perturbations(k_pert, cfg, d)), ("dist", d)):
            sc[name].append(np.asarray(v))
    sc = {k: np.stack(v) for k, v in sc.items()}
    cam = np.array([cfg.size * 1.2, cfg.size * 1.2, (cfg.size - 1) / 2, (cfg.size - 1) / 2, cfg.size, cfg.size],
                   np.float32)

    model, params = load_unet_weights(REPO / "assets" / "unet_basin.npz")
    extractors = {"unet_basin": FeatureExtractor(model, params=params, resize=None),
                  "handcrafted": FeatureExtractor(HandcraftedExtractor(), resize=None)}
    acfg = AlignConfig(num_iters=NUM_ITERS, robust_c=1.0)
    out = {f"scene_{k}": v for k, v in sc.items()}
    out["camera"] = cam
    from pixtrack_tpu.geometry import Camera

    camera = Camera.pinhole(*cam)
    for name, ex in extractors.items():
        t0, errs = time.time(), []
        for s in range(cfg.n_scenes):
            T_ref = Pose(R=jnp.asarray(sc["R_ref"][s]), t=jnp.asarray(sc["t_ref"][s]))
            T_gt = Pose(R=jnp.asarray(sc["R_gt"][s]), t=jnp.asarray(sc["t_gt"][s]))
            p3d = jnp.asarray(sc["p3d"][s])
            pmask = jnp.ones(p3d.shape[0], bool)
            f_ref, w_ref, v_ref = observe_points(ex(sc["img_ref"][s].astype(np.float32)), T_ref, camera, p3d, pmask)
            levels = build_level_data(ex(sc["img_qry"][s].astype(np.float32)), f_ref, w_ref, v_ref, p3d, pmask)
            for delta in sc["deltas"][s]:
                T0 = T_gt.retract(jnp.asarray(delta))
                final, _ = align_pyramid(T0, levels, camera, acfg)
                errs.append([float(v) for v in (*(T0 @ T_gt.inv()).magnitude(), *(final.T @ T_gt.inv()).magnitude())])
        e = np.asarray(errs)
        for i, k in enumerate(("rot_init", "t_init", "rot", "t")):
            out[f"{name}_{k}"] = e[:, i]
        conv = converged(e[:, 2], e[:, 0])
        print(json.dumps({"extractor": name, "converged": int(conv.sum()), "n": len(conv),
                          "rot_median": float(np.median(e[:, 2])), "seconds": round(time.time() - t0, 1)}), flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e6:.2f} MB)")


def jax_starts(name: str) -> dict:
    z = np.load(OUT)
    return {k: z[f"{name}_{k}"] for k in ("rot_init", "t_init", "rot", "t")}


def run_compare():
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
    from pixtrack_tpu_torch.features.evaluate import converged as t_converged
    from pixtrack_tpu_torch.features.evaluate import evaluate_starts, load_scenes
    from pixtrack_tpu_torch.features.unet import load_unet_weights

    scenes = load_scenes(OUT, "cpu")
    extractors = {"unet_basin": FeatureExtractor(load_unet_weights(REPO / "assets" / "unet_basin.npz", device="cpu"),
                                                 resize=None),
                  "handcrafted": FeatureExtractor(HandcraftedExtractor(device="cpu"), resize=None)}
    for name, ex in extractors.items():
        t0 = time.time()
        got = evaluate_starts(ex, align_cfg=AlignConfig(num_iters=NUM_ITERS, robust_c=1.0), device="cpu",
                              scenes=scenes)
        ref = jax_starts(name)
        a, b = t_converged(got), converged(ref["rot"], ref["rot_init"])
        print(json.dumps({"extractor": name, "port_converged": int(a.sum()), "jax_converged": int(b.sum()),
                          "flags_equal": float((a == b).mean()),
                          "rot_abs_diff_median": float(np.median(np.abs(got["rot"] - ref["rot"]))),
                          "port_rot_median": float(np.median(got["rot"])), "jax_rot_median": float(np.median(ref["rot"])),
                          "seconds": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    {"jax": run_jax, "compare": run_compare}[sys.argv[1]]()
