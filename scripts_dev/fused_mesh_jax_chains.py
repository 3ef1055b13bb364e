"""The JAX package's fused closed loop on the mesh world, from perturbed cold starts.

``chip_smoke.py`` runs the port's fused closed loop (``PixTrackTracker.run_fused``)
over 20 mesh-world frames from six cold starts whose translation differs by
k * 1e-6 along x (k = 0..5), because the loop's outcome flips with the last bits
of its state. This script runs the JAX package over the same frames from the
same perturbed cold starts, on the CPU, so that the spread can be placed in
the port or in the reference's configuration. The world is the one
``scripts_dev/stepwise_mesh_jax.py`` builds, with the fused path's
configuration (``fast_render=True``, splat mask); the UNet computes in bf16.

    JAX_PLATFORMS=cpu python scripts_dev/fused_mesh_jax_chains.py [n_frames] [k ...]

(20 frames and k = 0..5 by default; a chain takes a few minutes on 8 cores.)

Prints per chain: successes, first miss, rotation median/max, the per-frame
costs and rotation errors, and for frame 4 the rotation error on entry (the
state it starts from, against frame 4's ground truth) and exit, with the cost;
then one JSON line with all of it.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts_dev"))
sys.path.insert(0, str(REPO / "tests"))


def rot_err_deg(R, R_gt) -> float:
    R, R_gt = np.asarray(R, np.float64), np.asarray(R_gt, np.float64)
    return float(np.rad2deg(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1))))


def main(n_frames: int = 20, ks=(0, 1, 2, 3, 4, 5)):
    from stepwise_mesh_jax import jax_world

    import jax.numpy as jnp

    tracker, frames, gt, _, _ = jax_world(n_frames + 1, "bf16")
    # the fused path's configuration: coarse-only renders (K1's shape), splat mask
    tracker.config.fast_render = True
    tracker.config.mask_mode = "splat"
    tracker.testbed.n_coarse, tracker.testbed.n_fine = 96, 0
    camera = tracker.camera

    t0 = time.perf_counter()
    outs0 = tracker.run_fused(frames, camera=camera)  # cold start + chain 0
    cold = tracker.pose_history[frames[0][0]]
    step = tracker._fused_step
    thresh = jnp.float32(tracker.cost_threshold)
    T0 = np.asarray(cold["T_refined"], np.float32)
    queries = [jnp.asarray(np.asarray(img), jnp.float32) / 255.0 for _, img in frames[1:]]
    print(f"cold start: cost {cold['cost']:.4f}, threshold {tracker.cost_threshold:.4f}, success {cold['success']}, "
          f"rot err {rot_err_deg(T0[:3, :3], gt[0].R):.3f} deg ({time.perf_counter() - t0:.0f} s with chain 0)",
          flush=True)

    def chain(k):
        R, t = jnp.asarray(T0[:3, :3]), T0[:3, 3].copy()
        t[0] += np.float32(k * 1e-6)
        t, ok = jnp.asarray(t), jnp.asarray(bool(cold["success"]))
        R2, t2, vel_ok = R, t, jnp.asarray(False)
        outs = []
        for q in queries:
            out = step(R, t, ok, thresh, q, R_prev=R2, t_prev=t2, vel_ok=vel_ok)
            R2, t2, vel_ok = R, t, ok
            R, t, ok = out.R, out.t, out.ok
            outs.append(out)
        return outs

    results = []
    for k in ks:
        t0 = time.perf_counter()
        outs = outs0 if k == 0 else chain(k)
        oks = [bool(np.asarray(o.ok)) for o in outs]
        costs = [float(np.asarray(o.cost)) for o in outs]
        rot = [rot_err_deg(o.R, T.R) for o, T in zip(outs, gt[1:])]
        # frame 4 starts from frame 3's output (frame j is outs[j - 1])
        entry = rot_err_deg(outs[2].R, gt[4].R) if len(outs) >= 4 else None
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
