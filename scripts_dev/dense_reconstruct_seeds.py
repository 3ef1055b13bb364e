"""What ``reconstruct --detector dense`` runs over chip_smoke's arc rig, by seed.

The mapper's outcome with the dense descriptor at the CLI's camera (f = 1.2
* 192 against the rig's 211.2) turns with the RANSAC draws: at some seeds
the global averaging lands tens of degrees off, in both packages. Two ways
to look at it:

- ``port SEED ...``: the port's ``incremental_sfm`` at the CLI's settings
  (1024 keypoints, ``nms_radius=1``, the descriptor's ``match_kw``, KA, two
  featuremetric BA rounds) on its own draws, one JSON line a seed
  (``--device cpu`` by default; ``--device cuda`` on the card). The JAX
  package's own seeds are ``scripts_dev/learned_mapping_jax.py dense SEED``.
- ``paired SEED``: JAX's mapper with its draws recorded, then the port's on
  the same draws (``tests/test_torch_incremental.py``'s replay, JAX's
  RANSACs under the port's rule for samples that repeat a correspondence),
  both with KA and no featuremetric BA; one JSON line with both outcomes.
  Needs JAX; ~5 min a seed on the CPU.

    python scripts_dev/dense_reconstruct_seeds.py port 0 1 2 [--device cpu]
    JAX_PLATFORMS=cpu python scripts_dev/dense_reconstruct_seeds.py paired 0
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
CLI_KW = dict(max_keypoints=1024, nms_radius=1, match_kw=dict(min_score=0.1, ratio=0.98), featuremetric_ka=True)


def rig():
    import chip_smoke as cs

    views, truth, _ = cs.arc_rig(Path(tempfile.mkdtemp(prefix="dense_seeds_")))
    h, w = next(iter(views.values())).shape[:2]
    return views, truth, cs.cli_camera(h, w)


def outcome(rec, truth) -> dict:
    import chip_smoke as cs

    out = cs.rig_outcome(rec, truth)
    out.pop("names")
    return out


def run_port(seeds, device):
    import torch

    from pixtrack_tpu_torch.mapping import default_descriptor
    from pixtrack_tpu_torch.mapping.incremental import incremental_sfm

    # as chip_smoke's mapper workers run it on the card: one CPU thread, no TF32
    torch.set_num_threads(2 if device == "cpu" else 1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    views, truth, cam = rig()
    det = default_descriptor(device=device)
    for seed in seeds:
        t0 = time.perf_counter()
        rec = incremental_sfm(views, cam, seed=seed, featuremetric_ba_rounds=2, detector=det, device=device, **CLI_KW)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **outcome(rec, truth)}), flush=True)


def run_paired(seed: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import pytest
    import torch

    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_incremental import record_jax_draws, replay_draws

    from pixtrack_tpu.mapping import default_descriptor as jdefault
    from pixtrack_tpu.mapping import incremental as jinc
    from pixtrack_tpu.sfm import colmap_io as jcolmap
    from pixtrack_tpu_torch.mapping import default_descriptor
    from pixtrack_tpu_torch.mapping import incremental as tinc

    torch.set_num_threads(2)
    views, truth, cam = rig()
    jcam = jcolmap.CameraRecord(1, cam.model, cam.width, cam.height, np.asarray(cam.params))
    kw = dict(CLI_KW, seed=seed, featuremetric_ba_rounds=0)
    with pytest.MonkeyPatch.context() as mp:
        draws = record_jax_draws(mp, port_rule=True)
        rec_j = jinc.incremental_sfm(views, jcam, detector=jdefault(), **kw)
    stats = {"jax_calls": len(draws)}
    with pytest.MonkeyPatch.context() as mp:
        replay_draws(mp, draws, stats)
        rec_t = tinc.incremental_sfm(views, cam, detector=default_descriptor(device="cpu"), device="cpu", **kw)
    print(json.dumps({"seed": seed, "jax": outcome(rec_j, truth), "port": outcome(rec_t, truth), "draws": stats}),
          flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("port", "paired"))
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    if args.mode == "port":
        run_port(args.seeds, args.device)
    else:
        for s in args.seeds:
            run_paired(s)
