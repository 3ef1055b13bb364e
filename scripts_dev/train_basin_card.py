"""The production basin-training run through the port, on the card: train the
UNet through the unrolled aligner at ``scripts_dev/train_basin_run.py``'s
config (2000 steps, 2 scenes x 4 starts, 192 px, 512 points, 5 GN steps a
level) from a given seed, save the weights, and benchmark them beside the
handcrafted pyramid on the held-out alignment suite (12 scenes x 4 starts,
the production LM at 100 iterations), on the JAX package's own held-out
scenes (``scripts_dev/evaluate_jax.npz``) as ``chip_smoke.py`` phase 36 does.

    python3 scripts_dev/train_basin_card.py --seed 1 --out runs/basin_seed1.npz [--eval-at 500]

Writes the weights to ``--out`` (the JAX package's npz format; never under
``assets/``) and the results beside them as JSON (``--out`` with ``.json``):
the loss and gradient-norm history, steps/s, and the benchmark at the end
and at each ``--eval-at`` step (a multiple of the log interval, 50). On an
H100 80GB HBM3 at 700 W each benchmark takes ~20 s and the 2000 steps ~2
min (16 steps/s as one CUDA graph a step; the eager step ran 3 steps/s,
~11 min with three seeds side by side). ``--device cpu`` runs it on the CPU
(~1.3 s a step).
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SCENES = REPO / "scripts_dev" / "evaluate_jax.npz"


def main():
    import torch

    from pixtrack_tpu_torch._device import resolve
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
    from pixtrack_tpu_torch.features.evaluate import converged, evaluate_starts, load_scenes, summarize
    from pixtrack_tpu_torch.features.train import save_unet_weights
    from pixtrack_tpu_torch.features.train_basin import BasinTrainConfig, train_basin_features
    from pixtrack_tpu_torch.features.unet import init_unet

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--eval-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    device = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = BasinTrainConfig(n_steps=args.steps, batch=2, n_perturb=4, size=192, tex_size=256, n_points=512,
                           k_steps=5, scan_steps=False, log_every=50)
    scenes = load_scenes(SCENES, device)
    acfg = AlignConfig(num_iters=100, robust_c=1.0)

    def bench(model) -> dict:
        t0 = time.time()
        starts = evaluate_starts(FeatureExtractor(model.eval(), resize=None), align_cfg=acfg, device=device,
                                 scenes=scenes)
        model.train()
        return {**summarize(starts), "converged": int(converged(starts).sum()), "rot": starts["rot"].tolist(),
                "eval_seconds": round(time.time() - t0, 1)}

    model = init_unet(torch.Generator().manual_seed(args.seed), device=device)
    res = {"device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu", "seed": args.seed,
           "steps": args.steps, "at": {}}
    t0 = time.time()

    def callback(step, loss, gnorm):
        print(f"step {step} loss {loss:.4f} grad norm {gnorm:.3f} t={time.time() - t0:.0f}s", flush=True)
        if step in args.eval_at:
            res["at"][step] = bench(model)
            print(f"step {step}: converged {res['at'][step]['converged']}/48", flush=True)

    model, info = train_basin_features(cfg, seed=args.seed, model=model, callback=callback, device=device)
    seconds = time.time() - t0 - sum(r["eval_seconds"] for r in res["at"].values())
    res["at"][args.steps] = bench(model)
    hand = evaluate_starts(FeatureExtractor(HandcraftedExtractor(device=device), resize=None), align_cfg=acfg,
                           device=device, scenes=scenes)
    res["handcrafted"] = {**summarize(hand), "converged": int(converged(hand).sum())}
    res["train"] = {"history": info["history"], "grad_norms": info["grad_norms"], "seconds": seconds,
                    "steps_per_s": args.steps / seconds}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    save_unet_weights(args.out, model)
    args.out.with_suffix(".json").write_text(json.dumps(res, indent=1))
    print(json.dumps({"seed": args.seed, "steps_per_s": round(args.steps / seconds, 3),
                      "converged": {k: v["converged"] for k, v in res["at"].items()},
                      "handcrafted": res["handcrafted"]["converged"],
                      "rot_median": res["at"][args.steps]["rot_err_median"]}), flush=True)


if __name__ == "__main__":
    main()
