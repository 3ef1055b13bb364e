"""The JAX package's tracker variants and YCB protocol on the mesh world.

The references that ``chip_smoke.py``'s variant phases are held to: r6 and r7
(``make_tracker_r6``, ``make_tracker_r7(reference_scale=0.5)``: references
are NeRF renders at the SfM images' own poses, memoized), r3 (``RollTracker``
with ``render_at_db_pose=True`` and ``reference_scale=0.5`` on queries rolled
in-plane from 0 to 30 degrees over the frames) and the YCB evaluation
protocol (``YCBTracker`` with ``ycb_tracker_config()`` over (path, image,
ground-truth pose, camera) tuples), each through ``PoseTracker.run`` on the
first frames of the orbit that ``chip_smoke.mesh_world`` builds. Renders take
96 samples per ray (``fast_render``), the UNet computes in bf16, every
tracker starts from the upright mapping view, with ``covis_threshold=10``
and ``cost_threshold_min=0.05`` as the mesh world's flagship tracker.

Runs on the CPU at full size (minutes per variant on 8 cores):

    JAX_PLATFORMS=cpu python scripts_dev/variants_mesh_jax.py [n_frames] [r6|r7|r3|ycb ...]

Prints per variant the per-frame costs and rotation errors, successes,
relocalizations, rotation median (r3: the tracked roll beside the
ground-truth roll; ycb: ``summary()``), and one JSON line with them.
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

ROLL_MAX_DEG = 30.0
UP_WORLD = (0.0, 1.0, 0.0)


def rot_err_deg(R, R_gt) -> float:
    R, R_gt = np.asarray(R, np.float64), np.asarray(R_gt, np.float64)
    return float(np.rad2deg(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1))))


def main(n_frames: int = 10, variants=("r6", "r7", "r3", "ycb")):
    from stepwise_mesh_jax import jax_world

    flagship, frames, gt, mesh, meta = jax_world(n_frames, "bf16")
    from mesh_world import sample_mesh_surface
    from pixtrack_tpu.align.lm import AlignConfig
    from pixtrack_tpu.tracking import variants as var
    from pixtrack_tpu.tracking.tracker_ycb import YCBTracker, ycb_tracker_config

    scene, extractor, testbed, n2s = flagship.scene, flagship.refiner.extractor, flagship.testbed, flagship.nerf2sfm
    camera, up_id = flagship.camera, flagship.reference_ids[0]
    align = AlignConfig(num_iters=150)
    world = dict(covis_threshold=10, cost_threshold_min=0.05)

    def make(name):
        if name == "r6":
            return var.make_tracker_r6(scene, extractor, testbed, n2s, align_cfg=align)
        if name == "r7":
            return var.make_tracker_r7(scene, extractor, testbed, n2s, reference_scale=0.5, align_cfg=align)
        if name == "r3":
            cfg = var._static_cfg(render_at_db_pose=True, num_refs=2, reference_scale=0.5)
            return var.RollTracker(scene, extractor, testbed, n2s, config=cfg, align_cfg=align, up_world=UP_WORLD)
        return YCBTracker(scene, extractor, testbed, n2s, ycb_tracker_config(), align_cfg=align)

    for name in variants:
        tracker = make(name)
        for k, v in world.items():
            setattr(tracker.config, k, v)
        tracker.reference_ids = [up_id]
        tracker.camera = camera
        seq, gt_seq, rolls = frames, gt, None
        if name == "r3":
            rolls = np.deg2rad(np.linspace(0.0, ROLL_MAX_DEG, n_frames))
            c = (float(camera.c[0]), float(camera.c[1]))
            seq = [(nm, var.rotate_image(img, np.rad2deg(a), c)) for (nm, img), a in zip(frames, rolls)]
            gt_seq = [var.pre_opt_rotation(T, a) for T, a in zip(gt, rolls)]
        if name == "ycb":
            seq = [(nm, img, T, camera) for (nm, img), T in zip(frames, gt)]
        t0 = time.perf_counter()
        tracker.run(seq)
        seconds = time.perf_counter() - t0

        recs = [tracker.pose_history[f[0]] for f in frames]
        rot = [rot_err_deg(np.asarray(r["T_refined"])[:3, :3], T.R) for r, T in zip(recs, gt_seq)]
        out = {
            "variant": name, "frames": n_frames, "successes": sum(bool(r["success"]) for r in recs),
            "relocalizations": tracker.relocalization_count,
            "rot_median_deg": float(np.median(rot)), "rot_max_deg": float(np.max(rot)),
            "rot_err_deg": rot, "costs": [float(r["cost"]) for r in recs],
            "cost_threshold": tracker.cost_threshold, "success": [bool(r["success"]) for r in recs],
            "reference_ids": [list(r["reference_ids"]) for r in recs], "cpu_seconds": seconds,
        }
        if name == "r3":
            out["tracked_roll_deg"] = [float(np.rad2deg(r["tracked_roll"])) for r in recs]
            out["gt_roll_deg"] = [float(np.rad2deg(var.roll_of_pose(T, UP_WORLD))) for T in gt_seq]
        if name == "ycb":
            out["summary"] = tracker.summary(model_points=sample_mesh_surface(mesh, 512, seed=3))
            out["first_T_init_is_gt"] = bool(np.allclose(recs[0]["T_init"], np.asarray(gt[0].to_4x4())))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10, tuple(sys.argv[2:]) or ("r6", "r7", "r3", "ycb"))
