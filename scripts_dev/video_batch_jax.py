"""The JAX package's batched video tracker on the mesh world: phase 41's reference.

``chip_smoke.py`` phase 41 runs the port's ``make_production_video_tracker`` +
``track_video_batch`` over B videos of the mesh world's 20-frame orbit
(frames 0-19 of ``chip_smoke.mesh_assets``), video b started from frame 0's
true pose retracted by ``uniform(-1, 1, 6) * (0.01, 0.01, 0.01, 0.015,
0.015, 0.015)`` from ``np.random.default_rng(b)`` (the draw of
tests/test_parallel_production.py), with ``AlignConfig(num_iters=30)``, the
fused loop's render configuration (96 coarse samples, no fine pass) and the
shipped UNet in bf16. This script runs the JAX package's
``make_production_video_tracker`` + ``track_video_batch`` over the same
videos 0-7 as one batch of 8, on the CPU over the virtual 8-device mesh, and
writes every frame's pose, cost and iteration count, the initial poses (the
port starts from these) and the outcome per video to
``scripts_dev/video_batch_jax.npz``:

    python scripts_dev/video_batch_jax.py [n_frames] [k]

(20 frames by default; ~11 min on 8 cores.) Success is phase 7's: a
finite cost within 110 % of the video's first-frame cost, and at least
0.05 (``cost_threshold_min``). With ``k`` > 0 the same videos start with
their translations moved by k * 1e-6 along x (phase 7's perturbed cold
starts), and the run's outcome is added to the npz as ``successes_k{k}`` /
``rot_median_deg_k{k}`` / ``rot_err_deg_k{k}``: how far the reference's own
outcome moves with the last bits of its start.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts_dev"))
sys.path.insert(0, str(REPO / "tests"))

B = 8
SCALES = np.array([0.01] * 3 + [0.015] * 3)
COST_THRESHOLD_MIN, COST_THRESHOLD_FACTOR = 0.05, 1.1


def rot_err_deg(R, R_gt) -> float:
    R, R_gt = np.asarray(R, np.float64), np.asarray(R_gt, np.float64)
    return float(np.rad2deg(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1))))


def outcome(cost: np.ndarray, rot: np.ndarray) -> dict:
    """Per video: successes (phase 7's gate against the first frame's cost)
    and the rotation median over the frames. cost, rot: (T, B)."""
    thresh = np.maximum(COST_THRESHOLD_FACTOR * cost[0], COST_THRESHOLD_MIN)
    ok = np.isfinite(cost) & (cost <= thresh[None])
    return {"success": ok, "successes": ok.sum(0), "rot_median_deg": np.median(rot, axis=0)}


def main(n_frames: int = 20, k: int = 0):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
    from stepwise_mesh_jax import jax_world

    import jax.numpy as jnp

    from pixtrack_tpu.align.lm import AlignConfig
    from pixtrack_tpu.parallel.mesh import make_mesh
    from pixtrack_tpu.parallel.video import make_production_video_tracker, track_video_batch

    tracker, frames, gt, _, _ = jax_world(n_frames, "bf16")
    testbed = tracker.testbed
    testbed.n_coarse, testbed.n_fine = 96, 0  # the fused loop's renders: K1's path in the port
    R0, t0 = [], []
    for b in range(B):
        delta = np.random.default_rng(b).uniform(-1, 1, 6) * SCALES
        T0 = gt[0].retract(jnp.asarray(delta, jnp.float32))
        R0.append(np.asarray(T0.R))
        t0.append(np.asarray(T0.t))
    R0, t0 = np.stack(R0), np.stack(t0)
    t_start0 = t0.copy()
    t0[:, 0] += np.float32(k * 1e-6)
    video = np.stack([np.asarray(img, np.float32) / 255.0 for _, img in frames])
    videos = np.broadcast_to(video[None], (B, *video.shape))

    run = make_production_video_tracker(make_mesh(8, tp=1), testbed, tracker.nerf2sfm, tracker.refiner.extractor,
                                        tracker.scene, tracker.camera, reference_scale=0.5,
                                        align_cfg=AlignConfig(num_iters=30))
    t_start = time.perf_counter()
    out = track_video_batch(run, R0, t0, videos)
    seconds = time.perf_counter() - t_start
    rot = np.asarray([[rot_err_deg(out["R"][k, b], gt[k].R) for b in range(B)] for k in range(n_frames)])
    res = outcome(out["cost"], rot)
    path = REPO / "scripts_dev" / "video_batch_jax.npz"
    if k == 0:
        np.savez(path, R=out["R"], t=out["t"], cost=out["cost"], num_iters=out["num_iters"], R0=R0, t0=t_start0,
                 rot_err_deg=rot, success=res["success"], successes=res["successes"],
                 rot_median_deg=res["rot_median_deg"])
    else:
        with np.load(path) as z:
            stored = {name: z[name] for name in z.files}
        stored.update({f"successes_k{k}": res["successes"], f"rot_median_deg_k{k}": res["rot_median_deg"],
                       f"rot_err_deg_k{k}": rot})
        np.savez(path, **stored)
    summary = {"n_frames": n_frames, "k": k, "videos": B, "cpu_seconds": seconds,
               "successes": res["successes"].tolist(), "rot_median_deg": res["rot_median_deg"].tolist(),
               "first_cost": out["cost"][0].tolist(), "mean_iters": float(out["num_iters"].mean())}
    for b in range(B):
        print(f"video {b}: success {res['successes'][b]}/{n_frames}, rot median {res['rot_median_deg'][b]:.2f} deg, "
              f"costs {[round(float(c), 4) for c in out['cost'][:, b]]}", flush=True)
    print(json.dumps(summary))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20, int(sys.argv[2]) if len(sys.argv) > 2 else 0)
