"""What the batched LM's per-problem products cost on the card.

``align.lm`` contracts the gradient (``_gradient``) and composes the poses
(``_retract``) one problem at a time in a batch, so that a batch's problems
equal the same problems alone to the bit on the CPU. This times
``align_pyramid`` over B problems at the video tracker's shapes (three UNet
levels at strides 1, 4 and 16 with 32, 128 and 128 channels and
confidences, of a 640 x 480 query, and the mesh world's 1112 shared
points) in three ways, alternated in one process:

- ``per_problem``: ``align.lm`` as it is;
- ``batched``: ``_gradient`` as one einsum over the batch and ``_retract``
  as ``T.retract`` over it;
- ``unbatched_calls``: B unbatched calls, one problem each.

Every stopping rule is off, so each level runs ``--iters`` iterations and a
call does the same work in every variant. Prints ms per call and per
iteration (median of ``--reps``), then a ``torch.profiler`` table of one
call of each batched variant (the aten calls per iteration, nested ones
included, and the device's busy time), and writes it all to
``chiprun_out/lm_batch_products.json``.

    python scripts_dev/lm_batch_products.py [--B 8] [--iters 30] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from pixtrack_tpu_torch.align import lm  # noqa: E402
from pixtrack_tpu_torch.geometry import Camera, Pose  # noqa: E402

STRIDES, CHANNELS = (1, 4, 16), (32, 128, 128)


def levels_for(B: int, width: int, height: int, n_points: int, device, seed: int = 0):
    """B problems' levels (fine -> coarse) and their camera: smooth random
    maps, the references read at the true poses, shared points."""
    g = torch.Generator().manual_seed(seed)
    z = torch.rand(n_points, generator=g) * 2.0 + 3.0
    xy = (torch.rand(n_points, 2, generator=g) * 2.0 - 1.0) * 0.4 * z[:, None]
    p3d = torch.cat([xy, z[:, None]], -1).to(device)
    cam = Camera(size=torch.tensor([width, height], dtype=torch.float32),
                 f=torch.tensor([width, width], dtype=torch.float32),
                 c=torch.tensor([width / 2, height / 2], dtype=torch.float32), k=torch.zeros(2)).to(device)
    levels = []
    for s, C in zip(STRIDES, CHANNELS):
        h, w = height // s, width // s
        coarse = torch.randn(B, C, max(h // 8, 2), max(w // 8, 2), generator=g)
        fmap = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear").permute(0, 2, 3, 1).contiguous()
        conf = torch.rand(B, h, w, generator=g)
        scale = torch.full((2,), 1.0 / s)
        p2d, _ = cam.to("cpu").project(p3d.cpu())
        f_ref, _, _ = lm.interpolate_features(fmap, (p2d * scale).expand(B, -1, -1))
        levels.append(lm.LevelData(p3d=p3d, f_ref=f_ref.to(device), w_ref=torch.ones(B, n_points, device=device),
                                   mask=torch.ones(B, n_points, dtype=torch.bool, device=device),
                                   fmap=fmap.to(device), conf=conf.to(device), scale=scale.to(device)))
    rng = np.random.default_rng(seed)
    T0 = Pose.from_aa_t(torch.as_tensor(rng.uniform(-0.02, 0.02, (B, 3)), dtype=torch.float32),
                        torch.as_tensor(rng.uniform(-0.02, 0.02, (B, 3)), dtype=torch.float32))
    return tuple(levels), cam, Pose(T0.R.to(device), T0.t.to(device))


def batched_gradient(J_pix, v):
    return torch.einsum("...nak,...na->...k", J_pix, v)


def batched_retract(T, delta):
    return T.retract(delta)


def one_problem(levels, T, k):
    def lv(d):
        return lm.LevelData(p3d=d.p3d, f_ref=d.f_ref[k], w_ref=d.w_ref[k], mask=d.mask[k], fmap=d.fmap[k],
                            conf=d.conf[k], scale=d.scale)
    return tuple(lv(d) for d in levels), Pose(T.R[k], T.t[k])


def run_variant(name, levels, cam, T, cfg, singles):
    shipped = lm._gradient, lm._retract
    if name == "batched":
        lm._gradient, lm._retract = batched_gradient, batched_retract
    try:
        if name == "unbatched_calls":
            for lv, T1 in singles:
                lm.align_pyramid(T1, lv, cam, cfg)
        else:
            lm.align_pyramid(T, levels, cam, cfg)
    finally:
        lm._gradient, lm._retract = shipped


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--points", type=int, default=1112)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    card = None
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
        print(card)
    cfg = lm.AlignConfig(num_iters=args.iters, grad_stop_criteria=0.0, dt_stop_criteria=0.0, dR_stop_criteria=0.0,
                         stagnation_iters=0)
    levels, cam, T = levels_for(args.B, args.width, args.height, args.points, device)
    singles = [one_problem(levels, T, k) for k in range(args.B)]
    variants = ("per_problem", "batched", "unbatched_calls")
    n_iter = len(STRIDES) * args.iters  # LM iterations a call, per problem
    times = {v: [] for v in variants}
    with torch.no_grad():
        for v in variants:  # warm-up
            run_variant(v, levels, cam, T, cfg, singles)
        for rep in range(args.reps):
            for v in (variants if rep % 2 == 0 else variants[::-1]):
                sync()
                t0 = time.perf_counter()
                run_variant(v, levels, cam, T, cfg, singles)
                sync()
                times[v].append((time.perf_counter() - t0) * 1e3)
        out = {"card": card, "args": vars(args), "variants": {}}
        for v in variants:
            ms = statistics.median(times[v])
            out["variants"][v] = {"ms_per_call": ms, "ms_per_iteration": ms / n_iter, "all_ms": times[v]}
            print(f"{v}: {ms:.2f} ms a call of {n_iter} iterations, {ms / n_iter:.3f} ms an iteration "
                  f"(all: {[round(x, 2) for x in times[v]]})")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        for v in variants[:2]:
            with torch.profiler.profile(activities=acts) as prof:
                run_variant(v, levels, cam, T, cfg, singles)
                sync()
            ka = prof.key_averages()
            n_aten = sum(e.count for e in ka if e.key.startswith("aten::"))
            dev_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) for e in ka)
            top = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
            out["variants"][v]["profile"] = {
                "device_busy_ms": dev_us / 1e3,
                "top_self_cpu": [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in top],
                "aten_calls_per_iteration": n_aten / n_iter,
            }
            print(f"[{v}] device busy {dev_us / 1e3:.2f} ms in one call, {n_aten / n_iter:.0f} aten calls an "
                  f"iteration; top ops by self CPU time (name, count, ms): "
                  + "; ".join(f"{k} {c} {t:.2f}" for k, c, t in out["variants"][v]["profile"]["top_self_cpu"]))
    Path(REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "lm_batch_products.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({v: round(d["ms_per_iteration"], 4) for v, d in out["variants"].items()}))


if __name__ == "__main__":
    main()
