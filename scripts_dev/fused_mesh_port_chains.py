"""The port's fused closed loop on the mesh world, from perturbed cold starts, on the CPU.

The sibling of ``scripts_dev/fused_mesh_jax_chains.py``: the same 20
mesh-world frames (``chip_smoke.mesh_world``) through
``pixtrack_tpu_torch``'s ``PixTrackTracker.run_fused`` on the CPU, where
the ray march runs K1's plain version, from the cold starts ``chip_smoke.py``
uses on the card (translation moved by k * 1e-6 along x). UNet bf16.

    python scripts_dev/fused_mesh_port_chains.py [n_frames] [k ...]

Prints per chain what the JAX script prints, then one JSON line.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main(n_frames: int = 20, ks=(0, 1, 2, 3, 4, 5)):
    import torch

    import chip_smoke

    device = torch.device("cpu")
    tracker, camera, frames, gt, _, _ = chip_smoke.mesh_world(device, n_frames)
    t0 = time.perf_counter()
    outs0 = tracker.run_fused(frames, camera=camera)
    cold = tracker.pose_history[frames[0][0]]
    step = tracker._fused_step
    thresh = torch.tensor(tracker.cost_threshold, dtype=torch.float32)
    T0 = torch.as_tensor(cold["T_refined"], dtype=torch.float32)
    queries = [torch.as_tensor(img).float() / 255.0 for _, img in frames[1:]]
    print(f"cold start: cost {cold['cost']:.4f}, threshold {tracker.cost_threshold:.4f}, success {cold['success']}, "
          f"rot err {chip_smoke.rot_err_deg(T0[:3, :3], gt[0].R):.3f} deg "
          f"({time.perf_counter() - t0:.0f} s with chain 0)", flush=True)

    results = []
    for k in ks:
        t0 = time.perf_counter()
        outs = outs0 if k == 0 else chip_smoke.mesh_chain(step, T0, bool(cold["success"]), thresh, queries, k)
        oks = [bool(o.ok) for o in outs]
        costs = [float(o.cost) for o in outs]
        rot = [chip_smoke.rot_err_deg(o.R.numpy(), T.R.numpy()) for o, T in zip(outs, gt[1:])]
        entry = chip_smoke.rot_err_deg(outs[2].R.numpy(), gt[4].R.numpy()) if len(outs) >= 4 else None
        res = {
            "k": k, "successes": sum(oks), "frames": len(oks),
            "first_miss": oks.index(False) + 1 if False in oks else None,
            "rot_median_deg": float(np.median(rot)), "rot_max_deg": float(np.max(rot)),
            "costs": costs, "rot_err_deg": rot, "success": oks,
            "frame4": None if entry is None else {
                "rot_entry_deg": entry, "cost_entry": costs[2], "rot_exit_deg": rot[3], "cost_exit": costs[3]},
            "cpu_seconds": time.perf_counter() - t0,
        }
        results.append(res)
        print(f"chain {k} (cold start moved by {k}e-6): success {res['successes']}/{len(oks)}, first miss "
              f"{res['first_miss']}, rot med/max {res['rot_median_deg']:.2f}/{res['rot_max_deg']:.2f} deg; "
              f"frame 4: {res['frame4']}; cost {[round(c, 4) for c in costs]} vs {tracker.cost_threshold:.4f}; "
              f"rot err {[round(r, 2) for r in rot]}", flush=True)
    print(json.dumps({"cold_cost": float(cold["cost"]), "cost_threshold": float(tracker.cost_threshold),
                      "chains": results}))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20,
         tuple(int(a) for a in sys.argv[2:]) or (0, 1, 2, 3, 4, 5))
