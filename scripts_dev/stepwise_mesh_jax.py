"""The JAX package's stepwise reference-exact tracker on the mesh world.

The reference that ``chip_smoke.py``'s stepwise phase is held to: the
tracker's video loop (``PixTrackTracker.run``) with ``fast_render=False``
(every NeRF render takes 64 stratified and 32 importance samples per ray)
and ``mask_mode="nerf_depth"`` (every steady frame renders NeRF depth at the
640x480 query camera and masks the query with it). The world is the one
``chip_smoke.py`` builds: the upright pick, the orbit and the query frames
from the mesh rasteriser, the same arithmetic step for step.

Runs on the CPU at full size (a few minutes per frame on 8 cores):

    JAX_PLATFORMS=cpu python scripts_dev/stepwise_mesh_jax.py [n_frames] [bf16|f32]

The UNet computes in bf16 (the default extractor's) or in f32.

Prints the per-frame costs, successes, relocalizations, rotation median/max
and ADD / ADD-S AUC@0.1d over the frames, and one JSON line with them.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def jax_world(n_frames: int, unet_dtype: str):
    """The JAX tracker in the reference-exact configuration, the query frames
    and their ground-truth poses, the mesh and the world's meta.json."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")

    from pixtrack_tpu.align.lm import AlignConfig
    from pixtrack_tpu.features import FeatureExtractor
    from pixtrack_tpu.features.train import load_unet_weights
    from pixtrack_tpu.features.unet import UNetExtractor
    from pixtrack_tpu.geometry import Camera
    from pixtrack_tpu.geometry.nerf_transform import NerfTransform
    from pixtrack_tpu.mapping.mesh_render import load_obj, render_mesh
    from pixtrack_tpu.nerf.distill import load_distilled
    from pixtrack_tpu.nerf.testbed import Testbed
    from pixtrack_tpu.sfm.scene import SceneModel
    from pixtrack_tpu.tracking import PixTrackTracker, TrackerConfig
    from synthetic_world import look_at_w2c

    mw = REPO / "assets" / "mesh_world"
    meta = json.loads((mw / "meta.json").read_text())
    scene = SceneModel.load(mw / "aug_sfm")
    n2s = NerfTransform.load(mw / "nerf2sfm.pkl")
    mesh = load_obj(mw / "src" / "house.obj")
    testbed = Testbed()
    testbed.set_baked_field(load_distilled(mw / "field.npz"))
    testbed.render_aabb.min = [float(v) for v in meta["aabb"][0]]
    testbed.render_aabb.max = [float(v) for v in meta["aabb"][1]]
    testbed.tighten_render_bounds()
    assert (testbed.n_coarse, testbed.n_fine) == (64, 32)

    # chip_smoke.mesh_world's upright pick and orbit
    center = mesh["vertices"].mean(axis=0)
    best = None
    for i in scene.image_ids:
        T_i = scene.pose_w2c(int(i))
        c = np.asarray(T_i.inv().t).astype(np.float64)
        v = c - center
        el = float(np.arcsin(v[1] / np.linalg.norm(v)))
        if np.rad2deg(float(T_i.geodesic_to(look_at_w2c(c, target=center)))) > 5.0:
            continue
        if best is None or abs(el - 0.35) < best[0]:
            best = (abs(el - 0.35), int(i), v)
    _, up_id, v0 = best
    dist = float(np.linalg.norm(v0))
    ang0, el0 = float(np.arctan2(v0[0], v0[2])), float(np.arcsin(v0[1] / dist))
    gt = []
    for i in range(n_frames):
        ang, el = ang0 + 0.02 * i, el0 + 0.05 * np.sin(0.4 * i)
        eye = center + dist * np.array([np.cos(el) * np.sin(ang), np.sin(el), np.cos(el) * np.cos(ang)])
        gt.append(look_at_w2c(eye, target=center))
    H, W = 480, 640
    camera = Camera.pinhole(600.0, 600.0, (W - 1) / 2, (H - 1) / 2, W, H)
    frames = [(f"frame_{i:04d}.png", render_mesh(mesh, T, camera, background=(0.0, 0.0, 0.0)))
              for i, T in enumerate(gt)]

    params = load_unet_weights(REPO / "assets" / "unet_basin.npz")[1]
    dtype = {"bf16": jnp.bfloat16, "f32": jnp.float32}[unet_dtype]
    extractor = FeatureExtractor(UNetExtractor(dtype=dtype), params=params, resize=1024)
    tracker = PixTrackTracker(
        scene, extractor, testbed, n2s,
        TrackerConfig(reference_scale=0.5, cost_threshold_min=0.05, covis_threshold=10,
                      refine_rounds=1, upright_ref_img=scene.images[up_id].name,
                      fast_render=False, mask_mode="nerf_depth"),
        align_cfg=AlignConfig(num_iters=150),
    )
    tracker.camera = camera
    return tracker, frames, gt, mesh, meta


def main(n_frames: int = 10, unet_dtype: str = "bf16"):
    tracker, frames, gt, mesh, meta = jax_world(n_frames, unet_dtype)
    from pixtrack_tpu.eval.metrics import add_error, add_s_error, auc_of_threshold_curve
    from mesh_world import sample_mesh_surface

    t0 = time.perf_counter()
    tracker.run(frames)
    seconds = time.perf_counter() - t0

    add_pts = sample_mesh_surface(mesh, 512, seed=3)
    oks, rot, adds, add_ss, costs = [], [], [], [], []
    for (name, _), T_gt in zip(frames, gt):
        rec = tracker.pose_history[name]
        T = np.asarray(rec["T_refined"], np.float64)
        R, t = T[:3, :3], T[:3, 3]
        Rg, tg = np.asarray(T_gt.R, np.float64), np.asarray(T_gt.t, np.float64)
        oks.append(bool(rec["success"]))
        costs.append(float(rec["cost"]))
        rot.append(float(np.rad2deg(np.arccos(np.clip((np.trace(R @ Rg.T) - 1) / 2, -1, 1)))))
        adds.append(add_error(R, t, Rg, tg, add_pts))
        add_ss.append(add_s_error(R, t, Rg, tg, add_pts))
    max_thr = 0.1 * float(meta["diameter"])
    out = {
        "unet": unet_dtype,
        "frames": n_frames,
        "successes": sum(oks),
        "relocalizations": tracker.relocalization_count,
        "rot_median_deg": float(np.median(rot)),
        "rot_max_deg": float(np.max(rot)),
        "add_auc": auc_of_threshold_curve(adds, max_thr),
        "add_s_auc": auc_of_threshold_curve(add_ss, max_thr),
        "costs": costs,
        "cost_threshold": tracker.cost_threshold,
        "success": oks,
        "num_iters": [int(r["num_iters"]) for r in tracker.trace],
        "reference_ids": [list(tracker.pose_history[name]["reference_ids"]) for name, _ in frames],
        "T_refined": [np.asarray(tracker.pose_history[name]["T_refined"]).tolist() for name, _ in frames],
        "cpu_seconds": seconds,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10, sys.argv[2] if len(sys.argv) > 2 else "bf16")
