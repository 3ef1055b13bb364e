"""The dense-distillation SuperPoint recipe through the port, uncut, on the card.

``scripts_dev/train_superpoint_dense_run.py``'s recipe: the full dense pair
bank (24 mesh scenes x 8 views and 24 shape scenes, 10 warps, 160 px, seed 0)
built here with detection on the card, then ``SPDenseConfig()`` (4000 steps,
batch 8, lr 1e-3), then both acceptance gates: ``repeatability`` on the JAX
package's six held-out scenes (``scripts_dev/superpoint_jax.npz``) and
``mesh_repeatability`` (4 cube scenes, 17 degrees), for the trained net and
for Harris, beside the TPU record of the JAX recipe
(``assets/superpoint_candidate_eval.json``).

    python3 scripts_dev/train_superpoint_card.py --out runs/superpoint_card [--steps 4000]

Writes the weights (``--out`` + ``.npz``, the JAX package's format) and the
results (``--out`` + ``.json``: bank size and build time, loss history,
steps/s, the gates, the card's name and power limit). It writes nothing under
``assets/``: a promoted checkpoint would change what ``--detector auto``
picks in both packages.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SCENES = REPO / "scripts_dev" / "superpoint_jax.npz"


def main():
    import torch

    from pixtrack_tpu_torch._device import resolve
    from pixtrack_tpu_torch.mapping.superpoint import save_superpoint_weights
    from pixtrack_tpu_torch.mapping.train_superpoint import mesh_repeatability, repeatability
    from pixtrack_tpu_torch.mapping.train_superpoint_dense import (
        SPDenseConfig,
        build_dense_pair_bank,
        train_superpoint_dense,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    device = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() if device.type == "cuda" else "cpu"
    print(card, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    with tempfile.TemporaryDirectory() as td:
        bank = build_dense_pair_bank(td, device=device)
    bank_s = time.time() - t0
    print(f"bank: {bank['images'].shape[0]} views, {bank['pairs'].shape[0]} pairs in {bank_s:.1f} s", flush=True)

    cfg = SPDenseConfig(n_steps=args.steps)
    net, info = train_superpoint_dense(cfg, bank, device=device,
                                       callback=lambda k, v, _: print(f"step {k}: loss {v:.4f}", flush=True))
    sps = cfg.n_steps / info["seconds"]
    print(f"trained {cfg.n_steps} steps at {sps:.2f} steps/s ({info['seconds']:.1f} s)", flush=True)
    save_superpoint_weights(args.out.with_suffix(".npz"), net)

    with np.load(SCENES) as z:
        draws = {"scene": {k.rsplit("/", 1)[1]: z[k] for k in z.files if k.startswith("rep/scene/")},
                 "homography": z["rep/homography"]}
    gates = {}
    for name, n in (("trained", net), ("harris", None)):
        det = "harris" if n is None else "superpoint"
        rep, counts = repeatability(n, detector=det, draws=draws, device=device)
        mrep, mcounts = mesh_repeatability(n, detector=det, device=device)
        gates[name] = {"repeatability": rep, "counts": counts, "mesh_repeatability": mrep, "mesh_counts": mcounts}
        print(f"{name}: repeatability {rep:.4f} {counts}; mesh {mrep:.4f} {mcounts}", flush=True)
    tpu = json.loads((REPO / "assets" / "superpoint_candidate_eval.json").read_text())
    record = {"card": card, "torch": torch.__version__, "bank_views": int(bank["images"].shape[0]),
              "bank_pairs": int(bank["pairs"].shape[0]), "bank_seconds": bank_s, "steps": cfg.n_steps,
              "steps_per_s": sps, "train_seconds": info["seconds"], "history": info["history"], "gates": gates,
              "tpu_record": tpu}
    args.out.with_suffix(".json").write_text(json.dumps(record, indent=1, default=float))
    print(json.dumps({k: record[k] for k in ("card", "steps_per_s", "bank_seconds", "gates")}, default=float))


if __name__ == "__main__":
    main()
