#!/usr/bin/env python3
"""The port's unposed mapper over chip_smoke's rigs at several seeds, on the
card or on the CPU.

The spread that sets the margins of ``chip_smoke.py`` phases 30-32 (the
port's side; the JAX side is ``scripts_dev/reconstruct_jax.py`` on the CPU):

- the arc rig (phase 30's 10 views at 192 px, the ``reconstruct``
  settings) at ``--seeds`` seeds, each with its outcome
  (``chip_smoke.rig_outcome``) and its wall time split by stage; at seed 0
  on the card also the mapper's RANSAC calls again on the CPU on their own
  draws (phase 30's check); with ``--cpu`` the same seeds of the port on the
  CPU beside them (the same draws: the generator is a seeded CPU one);
- with ``--cli N``, what ``reconstruct`` runs over those images (the camera
  it infers, 1024 keypoints) at seeds 0..N-1 (phase 31's margin), or at
  seeds K..K+N-1 with ``--cli-first K``;
- with ``--ring SEED ...``, phase 32's ring capture of the house at those
  seeds, each with its outcome and split, and phase 33's open loop over the
  first seed's model (on the card only).

``--device cpu`` runs it all on the CPU (no card needed; the tracking is
left out). ``--no-repeat-rule`` lets the RANSACs choose samples that draw
one correspondence twice, as the JAX package's do, to measure what the
port's rule (``incremental._repeats``) does.

    python3 scripts_dev/reconstruct_card_seeds.py [--device cpu] [--seeds N] [--cpu] [--cli N [--cli-first K]] \\
        [--ring SEED ...] [--no-repeat-rule]

Prints one JSON line per run, and on the card the card's name and power limit.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main():
    import torch

    import chip_smoke as cs
    from pixtrack_tpu_torch.mapping import incremental

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seeds", type=int, default=3, help="arc seeds to run")
    ap.add_argument("--cpu", action="store_true", help="also run each arc seed on the CPU")
    ap.add_argument("--cli", type=int, default=0, help="seeds of what `reconstruct` runs over the arc (0 = none)")
    ap.add_argument("--cli-first", type=int, default=0, help="the first of the --cli seeds")
    ap.add_argument("--ring", type=int, nargs="*", default=[], help="ring seeds to run")
    ap.add_argument("--no-repeat-rule", action="store_true")
    args = ap.parse_args()
    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card (or --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cs.log(cs.nvidia_smi_line())
        from pixtrack_tpu_torch.nerf import fused_mlp

        fused_mlp.build_kernels()
    else:
        torch.cuda.synchronize = lambda *a, **k: None  # the stage timer synchronises the card; here there is none
    if args.no_repeat_rule:
        incremental._repeats = lambda *rows: torch.zeros(rows[0].shape[0], dtype=torch.bool, device=rows[0].device)
    tag = {"device": args.device, "repeat_rule": not args.no_repeat_rule}

    def row(run, rec, truth, wall, split=None, **extra):
        out = cs.rig_outcome(rec, truth)
        cs.log(json.dumps({"run": run, **tag, "seconds": wall, **({"split": split} if split else {}),
                           **{k: v for k, v in out.items() if k != "names"}, **extra}))

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        views, truth, cam_rec = cs.arc_rig(work)
        for seed in range(args.seeds):
            calls = []
            with cs.recorded_ransacs(calls):
                rec, wall, split = cs.run_mapper(views, cam_rec, f"arc seed {seed}", max_keypoints=768, nms_radius=1,
                                                 seed=seed, device=args.device)
            extra = {"ransac_card_vs_cpu": cs.ransacs_card_vs_cpu(calls)} if seed == 0 and on_card else {}
            row(f"arc{seed}", rec, truth, wall, split, **extra)
            if args.cpu:
                rec, wall, _ = cs.run_mapper(views, cam_rec, f"arc seed {seed}, CPU", max_keypoints=768, nms_radius=1,
                                             seed=seed, device="cpu")
                row(f"arc{seed}_cpu", rec, truth, wall)
        h, w = next(iter(views.values())).shape[:2]
        for seed in range(args.cli_first, args.cli_first + args.cli):
            rec, wall, split = cs.run_mapper(views, cs.cli_camera(h, w), f"cli seed {seed}", max_keypoints=1024,
                                             nms_radius=1, seed=seed, device=args.device)
            row(f"cli{seed}", rec, truth, wall, split)
        if not args.ring:
            return
        ring_views, ring_truth, names, ring_cam = cs.ring_rig(work)
        for k, seed in enumerate(args.ring):
            rec, wall, split = cs.run_mapper(ring_views, ring_cam, f"ring seed {seed}", names=names,
                                             max_keypoints=1024, nms_radius=2, seed=seed, device=args.device)
            row(f"ring{seed}", rec, ring_truth, wall, split)
            if k == 0 and on_card:
                d = work / "unposed_sfm"
                d.mkdir(parents=True, exist_ok=True)
                rec.save(d)
                ref = cs.jax_reconstruct_reference()
                cs.log(json.dumps({"run": "track", **cs.phase_track_unposed(torch.device("cuda"), work, d, ring_truth,
                                                                          ref)}))


if __name__ == "__main__":
    main()
