#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's tracking main path once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, builds the port's CUDA kernels from ``pixtrack_tpu_torch/csrc``
at first use (nvcc, one process per source, in parallel), and imports
nothing of JAX. Phases:

1. the device, and the card's name and power limit from nvidia-smi;
2. the kernel builds;
3. K1 (the fused ray march) against its plain PyTorch version at the main
   path's shapes, miss rays included, with CUDA-event times for both;
4. K2 (the per-sample field evaluation) against its plain version at the
   staged render's chunk sizes, with CUDA-event times for both;
5. the staged render (64 coarse + 32 importance samples) of the mesh view,
   through K2 and through K2's plain version;
6. the blob world, open loop (the per-frame step of bench.py:75-233 through
   the port): rotation/translation error, LM iterations, FPS;
7. the mesh world, closed loop (bench.py:258-440 through the port's
   ``PixTrackTracker.run_fused``): ADD / ADD-S AUC, rotation error,
   successes, FPS;
8. per-stage CUDA-event times of one steady fused mesh frame;
9. the mesh world through the stepwise reference-exact tracker
   (``PixTrackTracker.run`` with ``fast_render=False`` and the NeRF-depth
   mask): every render goes through K2 and none through K1;
10. per-stage CUDA-event times of one steady stepwise frame;
11. the launch counts: K1 over phases 6-7, K2 (and no K1) over phase 9.

Every check raises on failure, so any failed phase exits non-zero. The
second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
K1_TOL = 5e-3             # alpha and rgb, as tests/test_fused_mlp.py
K1_DEPTH_TOL = 1e-2       # depth (NeRF units, ~2) on rays with alpha > 0.01 on both sides
K2_SIGMA_TOL, K2_RGB_TOL = 2e-3, 5e-3  # tests/test_fused_mlp.py::test_fused_matches_plain
# sigma of the trained mesh field reaches ~5e5, where f32 sums in another
# order differ by ~1e-6 relative: 2e-3 absolute plus 1e-5 relative, the rule
# of tests/test_torch_nerf.py for trained fields
K2_SIGMA_RTOL = 1e-5
STAGED_TOL = 5e-3         # alpha, rgb, depth of the staged render, K2 vs plain
BLOB_GATE_DEG = 3.0
MESH_MIN_OK, MESH_MED_GATE_DEG = 15, 3.0
# The JAX package's stepwise tracker on the same 10 frames, on the CPU
# (scripts_dev/stepwise_mesh_jax.py): UNet f32 3/10 successes, rotation
# median 3.99 deg; UNet bf16 10/10, 1.99 deg. Its bf16 run owes its 10/10 to
# frame 2, where XLA's bf16 UNet lands the LM in a lower minimum (cost
# 0.0798) than XLA's f32 UNet or the port's UNet in either dtype
# (0.08423-0.08425) from the same start; the port's tracker with XLA's bf16 UNet
# in place of its own lands where JAX's does (0.07974,
# scripts_dev/stepwise_frame2_unet_swap.py). Both runs must reach JAX's f32 count
# less one success. The rotation median is held to 3 deg in f32, and in bf16,
# where the port misses JAX's lower minimum, to JAX's f32 median plus 0.5 deg.
JAX_STEPWISE_OK = 3
STEP_MED_GATE_DEG = {"float32": 3.0, "bfloat16": 4.5}
# an H100 SXM's dense bf16 tensor-core rate and memory bandwidth, the bounds' peaks
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int) -> float:
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def c2w_nerf(T, n2s=None):
    """NeRF-space c2w (4, 4) of an SfM w2c pose, on the pose's device (the
    identity NerfTransform unless one is given)."""
    import torch

    from pixtrack_tpu_torch.geometry import nerf_transform

    n2s = n2s or nerf_transform.NerfTransform.identity()
    c2w = n2s.pose_sfm_to_nerf(T.inv().to_4x4().cpu().numpy().astype(np.float64))
    return torch.as_tensor(c2w, dtype=torch.float32, device=T.R.device)


def mlp_flops(octaves: int, depth: int = 4) -> int:
    """Operations of the distilled MLP at one sample (both kernels'
    products; a multiply-add counts two)."""
    enc_pad = -(-(3 + 6 * octaves) // 8) * 8
    return 2 * (128 * enc_pad + (depth - 1) * 128 * 128 + 16 * 128 + 64 * 32 + 64 * 64 + 3 * 64)


def bound(flops: float, nbytes: float):
    """The least time the card could take, ms, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rot_err_deg(R_est, R_gt) -> float:
    R_est, R_gt = np.asarray(R_est, np.float64), np.asarray(R_gt, np.float64)
    return float(np.rad2deg(np.arccos(np.clip((np.trace(R_est @ R_gt.T) - 1) / 2, -1, 1))))


# ----------------------------------------------------------------- phase 3 --
def k1_rays(c2w, f, c, w, h, aabb, sphere, x0=0.0, y0=0.0):
    """K1's inputs for a (window of a) view, bounded as render_rays bounds them."""
    from pixtrack_tpu_torch.nerf.render import march_rays, rays_from_camera

    o, d = rays_from_camera(c2w, f, f, c[0], c[1], w, h, x0=x0, y0=y0)
    return march_rays(o, d, aabb, sphere)


def k1_errors(out, ref):
    """Max |kernel - plain| of alpha, rgb, and depth where both alphas exceed 0.01."""
    errs = {k: float((out[k] - ref[k]).abs().max()) for k in ("alpha", "rgb")}
    both = (out["alpha"] > 0.01) & (ref["alpha"] > 0.01)
    errs["depth"] = float((out["depth"] - ref["depth"])[both].abs().max()) if bool(both.any()) else 0.0
    return errs


def k1_samples_needed(field, rays, S, min_trans=1e-7) -> int:
    """The samples K1's per-ray loop must evaluate on these rays: on hit
    rays, each sample the transmittance before it still exceeds the cutoff
    (computed with the plain density at K1's sample positions)."""
    import torch

    from pixtrack_tpu_torch.nerf.render import _sample_stratified

    n = 0
    with torch.no_grad():
        for s in range(0, len(rays[0]), 8192):
            o, d, tn, tf = (a[s : s + 8192] for a in rays)
            ts = _sample_stratified(tn, tf, S)
            x = (o.T[:, :, None] + ts[None] * d.T[:, :, None]).clamp(0.0, 1.0).reshape(3, -1)
            sigma = field.density_T(x)[0].reshape(len(tn), S)
            dt = (tf - tn).clamp_min(0.0)[:, None] / S
            trans = torch.cumprod(torch.exp(-sigma * dt) + 1e-10, dim=-1)  # 1 - a + 1e-10
            trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
            n += int(((trans > min_trans) & (tf > tn)[:, None]).sum())
    return n


def phase_k1(worlds, device):
    """K1 against its plain version on each ray set, with random
    production-shape weights (init_distilled) and with the shipped trained
    weights, held to K1_TOL on alpha and rgb and K1_DEPTH_TOL on depth.
    Times both versions with CUDA events."""
    import torch

    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf.distill import init_distilled

    results = []
    for name, (field, rays, S) in worlds.items():
        o_g, d_g, tn, tf = rays
        misses = int((tf <= tn).sum())
        check(0 < misses < len(tn), f"{name}: ray set must mix hits and misses ({misses}/{len(tn)})")
        with torch.no_grad():
            random_field = init_distilled(0, octaves=field.octaves, device=device)
            errs = {}
            for label, fld in (("random", random_field), ("trained", field)):
                out = fused_mlp.fused_march_render(fld, o_g, d_g, tn, tf, S, 1e-7)
                ref = fused_mlp.march_render_reference(fld, o_g, d_g, tn, tf, S, 1e-7)
                torch.cuda.synchronize()
                for k in ("alpha", "rgb", "depth"):
                    check(bool(torch.isfinite(out[k]).all()), f"K1 {name}: non-finite {k}")
                errs[label] = e = k1_errors(out, ref)
                check(e["alpha"] <= K1_TOL and e["rgb"] <= K1_TOL and e["depth"] <= K1_DEPTH_TOL,
                      f"K1 {name} ({label} weights) disagrees with its plain version: {e}")

            def kern():
                fused_mlp.fused_march_render(field, o_g, d_g, tn, tf, S, 1e-7)

            def plain():
                fused_mlp.march_render_reference(field, o_g, d_g, tn, tf, S, 1e-7)

            kern(), plain()  # warm-up
            # in turns on one card: plain, kernel, kernel, plain
            t_plain = cuda_time_ms(plain, 3)
            t_k = cuda_time_ms(kern, 5)
            t_k = 0.5 * (t_k + cuda_time_ms(kern, 5))
            t_plain = 0.5 * (t_plain + cuda_time_ms(plain, 3))
        log(f"[k1] {name}: R={len(tn)} S={S} octaves={field.octaves} misses={misses}; max |kernel - plain| "
            + "; ".join(f"{label} weights: alpha {e['alpha']:.3e} rgb {e['rgb']:.3e} depth {e['depth']:.3e}"
                        for label, e in errs.items())
            + f"; kernel {t_k:.3f} ms, plain {t_plain:.3f} ms")
        err = max(e[k] for e in errs.values() for k in ("alpha", "rgb"))
        needed = k1_samples_needed(field, rays, S)
        b_ms, b_by = bound(needed * mlp_flops(field.octaves), len(tn) * (8 + 5) * 4)
        log(f"[k1] {name}: {needed} samples needed ({len(tn) - misses} hit rays x {S} = "
            f"{(len(tn) - misses) * S}); bound {b_ms:.4f} ms ({b_by})")
        results.append({"shape": name, "err": err, "ms": t_k, "plain_ms": t_plain,
                        "bound_ms": b_ms, "bound_by": b_by})
    return results


# ----------------------------------------------------------------- phase 4 --
def phase_k2(device, aabb):
    """K2 against its plain version at the staged render's shapes (a coarse
    chunk of 16384 rays x 64 samples, a fine chunk x 32, and a ragged N),
    positions uniform in the mesh world's crop box and unit directions, on
    random production-shape fields and the shipped trained ones. Times both
    versions with CUDA events on the coarse chunk and the mesh field."""
    import torch

    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf.distill import init_distilled, load_distilled

    fields = {
        "random 8 octaves": init_distilled(0, octaves=8, device=device),
        "random 10 octaves": init_distilled(0, octaves=10, device=device),
        "bench_field": load_distilled(REPO / "assets" / "bench_field.npz", device=device),
        "mesh field": load_distilled(REPO / "assets" / "mesh_world" / "field.npz", device=device),
    }
    rng = np.random.default_rng(0)
    lo, hi = np.asarray(aabb[0], np.float32), np.asarray(aabb[1], np.float32)
    err = 0.0
    with torch.no_grad():
        for set_name, N in (("coarse_chunk", 16384 * 64), ("fine_chunk", 16384 * 32), ("ragged", 1_000_003)):
            x = torch.as_tensor((lo[:, None] + rng.uniform(0, 1, (3, N)) * (hi - lo)[:, None]).astype(np.float32),
                                device=device)
            d = rng.normal(size=(3, N)).astype(np.float32)
            d = torch.as_tensor(d / np.linalg.norm(d, axis=0, keepdims=True), device=device)
            parts = []
            for fname, field in fields.items():
                sigma, rgb = fused_mlp.fused_distilled_eval(field, x, d)
                s_ref, c_ref = fused_mlp.distilled_eval_reference(field, x, d)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(sigma).all() and torch.isfinite(rgb).all()), f"K2 {set_name} {fname}: non-finite")
                e_s, e_c = (sigma - s_ref).abs(), float((rgb - c_ref).abs().max())
                excess = float((e_s - K2_SIGMA_TOL - K2_SIGMA_RTOL * s_ref.abs()).max())
                check(excess <= 0 and e_c <= K2_RGB_TOL,
                      f"K2 {set_name} ({fname}) disagrees with its plain version: sigma {float(e_s.max()):.3e}, "
                      f"rgb {e_c:.3e}")
                err = max(err, float(e_s.max()), e_c)
                parts.append(f"{fname}: sigma {float(e_s.max()):.3e} (relative "
                             f"{float((e_s / s_ref.abs().clamp_min(1.0)).max()):.2e}, sigma max "
                             f"{float(s_ref.max()):.3g}) rgb {e_c:.3e}")
            log(f"[k2] {set_name}: N={N}; max |kernel - plain| " + "; ".join(parts))
            if set_name == "coarse_chunk":
                field = fields["mesh field"]

                def kern():
                    fused_mlp.fused_distilled_eval(field, x, d)

                def plain():
                    fused_mlp.distilled_eval_reference(field, x, d)

                kern(), plain()  # warm-up
                t_plain = cuda_time_ms(plain, 3)
                t_k = cuda_time_ms(kern, 5)
                t_k = 0.5 * (t_k + cuda_time_ms(kern, 5))
                t_plain = 0.5 * (t_plain + cuda_time_ms(plain, 3))
                b_ms, b_by = bound(N * mlp_flops(field.octaves), N * (6 + 4) * 4)
                log(f"[k2] {set_name}, mesh field (10 octaves): kernel {t_k:.3f} ms, plain {t_plain:.3f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by})")
                timing = {"ms": t_k, "plain_ms": t_plain, "bound_ms": b_ms, "bound_by": b_by}
    return {"err": err, **timing}


# ----------------------------------------------------------------- phase 5 --
@contextlib.contextmanager
def k2_plain():
    """Route the staged render's field evaluations through K2's plain version."""
    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf import render as render_mod

    render_mod.fused_distilled_eval = fused_mlp.distilled_eval_reference
    try:
        yield
    finally:
        render_mod.fused_distilled_eval = fused_mlp.fused_distilled_eval


def phase_staged(device, field, box, c2w):
    """The Testbed's 64 + 32 render of the mesh view at the query size
    (640x480, the depth mask's) and the reference size (224x224), through
    K2 and through its plain version: alpha, rgb and depth within
    STAGED_TOL. Times both with CUDA events."""
    import torch

    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf.render import RenderConfig, rays_from_camera, render_rays

    cfg = RenderConfig(n_coarse=64, n_fine=32)
    with torch.no_grad():
        for w, h, f in ((640, 480, 600.0), (224, 224, 225.0)):
            o, d = rays_from_camera(c2w, f, f, (w - 1) / 2, (h - 1) / 2, w, h)

            def kern():
                return render_rays(field, o, d, box[0], cfg, sphere=box[1])

            def plain():
                with k2_plain():
                    return render_rays(field, o, d, box[0], cfg, sphere=box[1])

            fused_mlp.reset_launch_counts()
            out = kern()
            launches = fused_mlp.launch_count(fused_mlp.K2)
            ref = plain()
            torch.cuda.synchronize()
            errs = {k: float((out[k] - ref[k]).abs().max()) for k in ("alpha", "rgb", "depth")}
            check(all(bool(torch.isfinite(out[k]).all()) for k in out), f"staged render {w}x{h}: non-finite")
            check(max(errs.values()) <= STAGED_TOL, f"staged render {w}x{h}: K2 vs plain {errs}")
            t_plain = cuda_time_ms(plain, 1)
            t_k = cuda_time_ms(kern, 2)
            t_plain = 0.5 * (t_plain + cuda_time_ms(plain, 1))
            hit = int((out["alpha"] > 0.01).sum())
            log(f"[staged] {w}x{h}, 64+32 samples, {launches} K2 launches, {hit} rays with alpha > 0.01: "
                f"max |K2 - plain| alpha {errs['alpha']:.3e} rgb {errs['rgb']:.3e} depth {errs['depth']:.3e}; "
                f"render through K2 {t_k:.2f} ms, through the plain version {t_plain:.2f} ms")


# ----------------------------------------------------------------- phase 6 --
def blob_world(device, n_frames=20):
    """The blob world's open-loop step (bench.py:75-233): each frame starts
    from the previous frame's ground truth plus a fixed perturbation."""
    import torch

    from pixtrack_tpu_torch.align.lm import AlignConfig, align_pyramid
    from pixtrack_tpu_torch.align.observations import build_level_data, observe_points
    from pixtrack_tpu_torch.features import default_extractor
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.nerf.distill import load_distilled
    from pixtrack_tpu_torch.nerf.render import RenderConfig, occupied_bounds, rays_from_camera, render_rays
    from pixtrack_tpu_torch.tracking.mask import splat_object_mask
    from smoke_worlds import look_at_w2c, sphere_surface_points

    field = load_distilled(REPO / "assets" / "bench_field.npz", device=device)
    H, W = 480, 640
    camera = Camera.pinhole(600.0, 600.0, (W - 1) / 2, (H - 1) / 2, W, H, device=device)
    rW, rH = W // 2, H // 2
    ref_camera = Camera.pinhole(300.0, 300.0, (rW - 1) / 2, (rH - 1) / 2, rW, rH, device=device)
    extractor = default_extractor(resize=1024, device=device)
    align_cfg = AlignConfig(num_iters=150)
    aabb_np, sphere_np = occupied_bounds(field, np.asarray([[0.3] * 3, [0.7] * 3], np.float32))
    aabb = torch.as_tensor(aabb_np, device=device)
    sphere = torch.as_tensor(sphere_np, device=device)
    rcfg = RenderConfig(n_coarse=48, n_fine=0)
    p3d = torch.as_tensor(sphere_surface_points(4200)[:4096], device=device)
    pmask = torch.ones(len(p3d), dtype=torch.bool, device=device)

    gt = []
    for i in range(n_frames + 1):
        ang, el = 0.35 + 0.02 * i, 0.15 + 0.06 * np.sin(0.4 * i)
        gt.append(look_at_w2c(1.6 * np.array([np.cos(el) * np.sin(ang), np.sin(el), np.cos(el) * np.cos(ang)]),
                              device=device))

    def render(T, f, w, h):
        o, d = rays_from_camera(c2w_nerf(T), f, f, (w - 1) / 2, (h - 1) / 2, w, h)
        out = render_rays(field, o, d, aabb, rcfg, sphere=sphere)
        return (out["rgb"] + (1.0 - out["alpha"][:, None])).reshape(h, w, 3)  # white background

    with torch.no_grad():
        queries = [render(T, 600.0, W, H) for T in gt]  # setup, untimed
    perturb = torch.tensor([0.004, -0.003, 0.002, 0.003, 0.004, -0.002], device=device)

    @torch.no_grad()
    def frame_step(T_prev_gt, query):
        T = T_prev_gt.retract(perturb)
        mask = splat_object_mask(T, camera, p3d, (H, W))
        ref_pyr = extractor.traced(render(T, 300.0, rW, rH))
        f_ref, w_ref, v_ref = observe_points(ref_pyr, T, ref_camera, p3d, pmask)
        pyr = extractor.traced(query * mask[..., None])
        levels = build_level_data(pyr, f_ref, w_ref, v_ref, p3d, pmask)
        final, states = align_pyramid(T, levels, camera, align_cfg)
        return final, sum(s.num_iters for s in states)

    return gt, queries, frame_step, extractor


def phase_blob(device, n_frames=20):
    gt, queries, frame_step, extractor = blob_world(device, n_frames)
    import torch

    rot, trans, iters = [], [], []
    for k in range(1, n_frames + 1):  # evidence pass
        final, it = frame_step(gt[k - 1], queries[k])
        R, t = final.T.R.cpu().numpy(), final.T.t.cpu().numpy()
        check(np.isfinite(R).all() and np.isfinite(t).all(), "blob world: non-finite pose")
        rot.append(rot_err_deg(R, gt[k].R.cpu().numpy()))
        trans.append(float(np.linalg.norm(t - gt[k].t.cpu().numpy())))
        iters.append(int(it))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(1, n_frames + 1):  # timed pass
        final, _ = frame_step(gt[k - 1], queries[k])
    torch.cuda.synchronize()
    fps = n_frames / (time.perf_counter() - t0)
    log(f"[blob] open loop, UNet {str(extractor.model.dtype)[6:]}, {n_frames} frames: rot err deg mean/max = {np.mean(rot):.3f}/{np.max(rot):.3f} "
        f"(BENCH_r05: 1.562/2.168), t err mean/max = {np.mean(trans):.4f}/{np.max(trans):.4f}, "
        f"LM iters/frame mean = {np.mean(iters):.1f}, FPS = {fps:.2f}")
    check(np.mean(rot) <= BLOB_GATE_DEG, f"blob world: mean rotation error {np.mean(rot):.3f} > {BLOB_GATE_DEG}")
    return {"rot_mean": float(np.mean(rot)), "rot_max": float(np.max(rot)), "fps": fps}


# ----------------------------------------------------------------- phase 7 --
def mesh_world(device, n_frames=20, unet_dtype=None, **config):
    """The mesh world (bench.py:258-440) through the port's tracker: the
    upright pick, the ground-truth orbit and the query frames from the
    mesh rasteriser, black background. ``config`` overrides fields of
    bench.py's TrackerConfig; the UNet computes in bf16 unless
    ``unet_dtype`` says otherwise."""
    import torch

    from pixtrack_tpu_torch.geometry import nerf_transform
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.features import default_extractor
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
    from pixtrack_tpu_torch.nerf.distill import load_distilled
    from pixtrack_tpu_torch.nerf.testbed import Testbed
    from pixtrack_tpu_torch.sfm.scene import SceneModel
    from pixtrack_tpu_torch.tracking.tracker import PixTrackTracker, TrackerConfig
    from smoke_worlds import look_at_w2c

    mw = REPO / "assets" / "mesh_world"
    meta = json.loads((mw / "meta.json").read_text())
    scene = SceneModel.load(mw / "aug_sfm")
    n2s = nerf_transform.NerfTransform.load(mw / "nerf2sfm.pkl")
    mesh = load_obj(mw / "src" / "house.obj")
    testbed = Testbed(device=device)
    testbed.set_baked_field(load_distilled(mw / "field.npz", device=device))
    testbed.render_aabb.min = [float(v) for v in meta["aabb"][0]]
    testbed.render_aabb.max = [float(v) for v in meta["aabb"][1]]
    testbed.tighten_render_bounds()

    center = mesh["vertices"].mean(axis=0)
    best = None
    for i in scene.image_ids:
        T_i = scene.pose_w2c(int(i))
        c = T_i.inv().t.numpy().astype(np.float64)
        v = c - center
        el = float(np.arcsin(v[1] / np.linalg.norm(v)))
        # skip roll-augmented entries: the stored orientation must be the rig's look-at
        if np.rad2deg(float(T_i.geodesic_to(look_at_w2c(c, target=center)))) > 5.0:
            continue
        if best is None or abs(el - 0.35) < best[0]:
            best = (abs(el - 0.35), int(i), v)
    check(best is not None, "mesh world: no upright mapping view")
    _, up_id, v0 = best
    dist = float(np.linalg.norm(v0))
    ang0, el0 = float(np.arctan2(v0[0], v0[2])), float(np.arcsin(v0[1] / dist))
    gt = []
    for i in range(n_frames + 1):
        ang, el = ang0 + 0.02 * i, el0 + 0.05 * np.sin(0.4 * i)
        eye = center + dist * np.array([np.cos(el) * np.sin(ang), np.sin(el), np.cos(el) * np.cos(ang)])
        gt.append(look_at_w2c(eye, target=center))
    H, W = 480, 640
    camera = Camera.pinhole(600.0, 600.0, (W - 1) / 2, (H - 1) / 2, W, H)
    frames = [(f"frame_{i:04d}.png", render_mesh(mesh, T, camera, background=(0.0, 0.0, 0.0)))
              for i, T in enumerate(gt)]
    tracker = PixTrackTracker(
        scene, default_extractor(resize=1024, device=device, dtype=unet_dtype or torch.bfloat16),
        testbed, n2s,
        TrackerConfig(reference_scale=0.5, cost_threshold_min=0.05, covis_threshold=10,
                      refine_rounds=1, upright_ref_img=scene.images[up_id].name, **config),
        align_cfg=AlignConfig(num_iters=150),
    )
    return tracker, camera.to(device), frames, gt, mesh, float(meta["diameter"])


def phase_mesh(device, n_frames=20):
    import torch

    tracker, camera, frames, gt, mesh, diameter = mesh_world(device, n_frames)
    outs = tracker.run_fused(frames, camera=camera)  # cold start + fused frames
    check(len(outs) == n_frames, "mesh world: missing frames")
    add_auc, add_s_auc, rot = pose_metrics([(o.R.cpu().numpy(), o.t.cpu().numpy()) for o in outs], gt[1:],
                                           mesh, diameter)
    oks = [bool(o.ok) for o in outs]
    cold = tracker.pose_history[frames[0][0]]

    # timed pass: the same chain from the cold start's state, one sync at the end
    step = tracker._fused_step
    thresh = torch.tensor(tracker.cost_threshold, dtype=torch.float32, device=device)
    T0 = torch.as_tensor(cold["T_refined"], dtype=torch.float32, device=device)
    queries = [torch.as_tensor(img, device=device).float() / 255.0 for _, img in frames[1:]]
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    R, t, ok = T0[:3, :3], T0[:3, 3], torch.tensor(bool(cold["success"]), device=device)
    R2, t2, vel_ok = R, t, torch.tensor(False, device=device)
    for q in queries:
        out = step(R, t, ok, thresh, q, R_prev=R2, t_prev=t2, vel_ok=vel_ok)
        R2, t2, vel_ok = R, t, ok
        R, t, ok = out.R, out.t, out.ok
    torch.cuda.synchronize()
    fps = n_frames / (time.perf_counter() - t_start)
    unet = str(tracker.refiner.extractor.model.dtype)[6:]
    log(f"[mesh] closed loop, UNet {unet}, {n_frames} frames: "
        f"per-frame cost {[round(float(o.cost), 4) for o in outs]} vs threshold {tracker.cost_threshold:.4f}")
    log(f"[mesh] closed loop, UNet {unet}, {n_frames} frames: ADD AUC@0.1d {add_auc:.3f} (BENCH_r05 0.685), "
        f"ADD-S AUC {add_s_auc:.3f} (0.750), rot med/max {np.median(rot):.2f}/{np.max(rot):.2f} deg "
        f"(1.63/23.09), success {sum(oks)}/{len(oks)} (18/20), cold-start cost {cold['cost']:.4f}, "
        f"FPS = {fps:.2f}")
    check(sum(oks) >= MESH_MIN_OK, f"mesh world: {sum(oks)} successes < {MESH_MIN_OK}")
    check(np.median(rot) <= MESH_MED_GATE_DEG, f"mesh world: rotation median {np.median(rot):.2f} deg")
    return tracker, queries, {"add_auc": add_auc, "add_s_auc": add_s_auc, "fps": fps}


def pose_metrics(poses, gt, mesh, diameter):
    """ADD / ADD-S AUC@0.1d and rotation errors of (R, t) numpy poses against the orbit."""
    from pixtrack_tpu_torch.eval import metrics
    from pixtrack_tpu_torch.mapping.mesh_render import sample_mesh_surface

    add_pts = sample_mesh_surface(mesh, 512, seed=3)
    adds, add_ss, rot = [], [], []
    for (R, t), T_gt in zip(poses, gt):
        check(np.isfinite(R).all() and np.isfinite(t).all(), "mesh world: non-finite pose")
        Rg, tg = T_gt.R.cpu().numpy(), T_gt.t.cpu().numpy()
        adds.append(metrics.add_error(R, t, Rg, tg, add_pts))
        add_ss.append(metrics.add_s_error(R, t, Rg, tg, add_pts))
        rot.append(rot_err_deg(R, Rg))
    max_thr = 0.1 * diameter
    return (metrics.auc_of_threshold_curve(adds, max_thr), metrics.auc_of_threshold_curve(add_ss, max_thr),
            np.asarray(rot))


# ----------------------------------------------------------------- phase 8 --
def phase_stages(tracker, queries, device):
    import torch

    step = tracker._fused_step
    events = {}

    @contextlib.contextmanager
    def timer(name):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        events.setdefault(name, []).append((a, b))

    R, t = tracker.pose.R.to(device), tracker.pose.t.to(device)
    thresh = torch.tensor(tracker.cost_threshold, dtype=torch.float32, device=device)
    step.stage_timer = timer
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(R, t, torch.tensor(True, device=device), thresh, queries[-1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        step.stage_timer = None
    parts = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}
    log("[stages] one steady mesh frame (CUDA events, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + f"; frame wall {wall:.2f}")

    # device busy share of one frame, from the profiler's kernel times
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(R, t, torch.tensor(True, device=device), thresh, queries[-1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
            and "CUDA" in str(e.device_type)]
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
    if busy > 0:
        log(f"[profile] one steady frame: device busy {busy:.2f} ms of {wall:.2f} ms wall "
            f"(idle share {1 - busy / wall:.3f}, profiler on); top kernels: "
            + "; ".join(f"{e.key[:60]} {getattr(e, 'self_device_time_total', 0.0) / 1e3:.2f} ms x{e.count}"
                        for e in top))
    else:
        log("[profile] the profiler recorded no device time: idle share not measured")


# ----------------------------------------------------------------- phase 9 --
def phase_stepwise(device, unet_dtype, n_frames=10):
    """The first n_frames of the mesh world's orbit through the stepwise
    reference-exact tracker: PixTrackTracker.run (refine, relocalize and
    retry once on failure), fast_render off (every render 64 coarse + 32
    importance samples per ray, the staged render and K2), the NeRF-depth
    mask at the 640x480 query camera on every steady frame. Counts both
    kernels over the run: K2 must launch, K1 must not."""
    import torch

    from pixtrack_tpu_torch.nerf import fused_mlp

    tracker, camera, frames, gt, mesh, diameter = mesh_world(
        device, n_frames - 1, unet_dtype=unet_dtype, fast_render=False, mask_mode="nerf_depth")
    unet = str(unet_dtype)[6:]
    check((tracker.testbed.n_coarse, tracker.testbed.n_fine) == (64, 32), "stepwise: the Testbed left 64 + 32")
    tracker.camera = camera
    torch.cuda.synchronize()
    fused_mlp.reset_launch_counts()
    t0 = time.perf_counter()
    tracker.run(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fused_mlp.launch_count(k) for k in (fused_mlp.K1, fused_mlp.K2)}

    recs = [tracker.pose_history[name] for name, _ in frames]
    poses = [(r["T_refined"][:3, :3], r["T_refined"][:3, 3]) for r in recs]
    add_auc, add_s_auc, rot = pose_metrics(poses, gt, mesh, diameter)
    oks = sum(bool(r["success"]) for r in recs)
    log(f"[stepwise] UNet {unet}, {n_frames} frames, 64+32 samples, NeRF-depth mask: per-frame cost "
        f"{[round(float(r['cost']), 4) for r in recs]} vs threshold {tracker.cost_threshold:.4f}; "
        f"relocalizations {tracker.relocalization_count}")
    log(f"[stepwise] UNet {unet}: success {oks}/{n_frames} (JAX on the CPU, UNet f32/bf16: 3/10, 10/10), "
        f"rot med/max {np.median(rot):.2f}/{np.max(rot):.2f} deg (3.99/12.59, 1.99/5.02), ADD AUC@0.1d "
        f"{add_auc:.3f} (0.406, 0.661), ADD-S AUC {add_s_auc:.3f} (0.599, 0.718), FPS = {n_frames / wall:.3f} "
        f"({wall:.2f} s); launches K1 {launches[fused_mlp.K1]}, K2 {launches[fused_mlp.K2]}")
    check(launches[fused_mlp.K2] > 0, "stepwise: K2 was never launched")
    check(launches[fused_mlp.K1] == 0, f"stepwise: the path reached K1 ({launches[fused_mlp.K1]} launches)")
    check(np.median(rot) <= STEP_MED_GATE_DEG[unet],
          f"stepwise, UNet {unet}: rotation median {np.median(rot):.2f} deg > {STEP_MED_GATE_DEG[unet]}")
    check(oks >= JAX_STEPWISE_OK - 1, f"stepwise: {oks} successes < {JAX_STEPWISE_OK - 1}")
    return tracker, frames, gt, launches


# ---------------------------------------------------------------- phase 10 --
def phase_stepwise_stages(tracker, frames, gt):
    """CUDA-event times of the stages of one steady stepwise frame: the
    last frame refined from the previous frame's ground-truth pose with an
    empty reference cache, so that it renders its depth mask and its
    reference: the depth-mask render and its morphology, the reference
    render, the two UNets, the observation and the LM."""
    import torch

    from pixtrack_tpu_torch.geometry import Pose
    from pixtrack_tpu_torch.tracking import refiner as refiner_mod

    events = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            events.setdefault(name(kwargs) if callable(name) else name, []).append((a, b))
            return out
        return run

    class TimedExtractor:
        def __init__(self, inner):
            self.inner = inner
            self.call = timed(lambda kw: "query_unet" if "image_scale" in kw else "reference_unet", inner)

        def __call__(self, *args, **kwargs):
            return self.call(*args, **kwargs)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    refiner = tracker.refiner
    saved = (refiner.extractor, refiner_mod.align_pyramid, refiner_mod.build_level_data)
    tracker.get_mask = timed("depth_mask", tracker.get_mask)
    tracker.get_reference_image = timed("reference_render", tracker.get_reference_image)
    refiner._observe_reference = timed("observation", refiner._observe_reference)
    refiner.extractor = TimedExtractor(refiner.extractor)
    refiner_mod.align_pyramid = timed("lm", refiner_mod.align_pyramid)
    refiner_mod.build_level_data = timed("observation", refiner_mod.build_level_data)
    tracker.success, tracker.cold_start = True, False
    tracker.pose = Pose(gt[-2].R.to(tracker.device), gt[-2].t.to(tracker.device))
    tracker._cache.clear()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = tracker.refine(frames[-1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        refiner.extractor, refiner_mod.align_pyramid, refiner_mod.build_level_data = saved
        for name in ("get_mask", "get_reference_image"):
            del tracker.__dict__[name]
        del refiner.__dict__["_observe_reference"]
    parts = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}
    log("[stages] one steady stepwise mesh frame (CUDA events, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + f"; frame wall {wall:.2f}; success {ok}")


# -------------------------------------------------------------------- main --
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not (REPO / "pixtrack_tpu_torch").is_dir() or not (REPO / "assets").is_dir():
        print("chip_smoke: run from a checkout of the repository (pixtrack_tpu_torch/ and assets/ missing)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script measures the port on an NVIDIA GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: the device
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"count {torch.cuda.device_count()}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    smi = nvidia_smi_line()
    log(smi)

    # phase 2: build (both sources at once)
    from pixtrack_tpu_torch import _build
    from pixtrack_tpu_torch.nerf import fused_mlp

    t0 = time.perf_counter()
    fused_mlp.build_kernels()
    for name in ("march_render", "distilled_eval"):
        info = _build.build_info[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {name}.cu: nvcc {info['seconds']:.2f} s; " + " | ".join(ptxas))
    log(f"[build] both kernels built and loaded in {time.perf_counter() - t0:.2f} s")

    # phase 3: K1 against its plain version at the main path's shapes
    from pixtrack_tpu_torch.nerf.distill import load_distilled
    from pixtrack_tpu_torch.nerf.render import occupied_bounds
    from pixtrack_tpu_torch.sfm.scene import SceneModel
    from pixtrack_tpu_torch.geometry import nerf_transform
    from smoke_worlds import look_at_w2c

    mw = REPO / "assets" / "mesh_world"
    meta = json.loads((mw / "meta.json").read_text())
    mesh_field = load_distilled(mw / "field.npz", device=device)
    m_aabb, m_sphere = occupied_bounds(mesh_field, np.asarray(meta["aabb"], np.float32))
    scene = SceneModel.load(mw / "aug_sfm")
    n2s = nerf_transform.NerfTransform.load(mw / "nerf2sfm.pkl")
    c2w_m = c2w_nerf(scene.pose_w2c(int(scene.image_ids[0]), device=device), n2s)
    m_box = torch.as_tensor(m_aabb, device=device), torch.as_tensor(m_sphere, device=device)
    blob_field = load_distilled(REPO / "assets" / "bench_field.npz", device=device)
    b_aabb, b_sphere = occupied_bounds(blob_field, np.asarray([[0.3] * 3, [0.7] * 3], np.float32))
    b_box = torch.as_tensor(b_aabb, device=device), torch.as_tensor(b_sphere, device=device)
    c2w_b = c2w_nerf(look_at_w2c(1.6 * np.array([0.33, 0.15, 0.93]), device=device))
    k1_sets = {
        # the mesh world's steady reference: 224x224 (its crop window is off)
        "mesh_ref_224x224": (mesh_field, k1_rays(c2w_m, 225.0, (111.5, 111.5), 224, 224, *m_box), 96),
        # a crop window's ray set: 160x144 at offset (32, 40) of that view
        "mesh_window_160x144": (mesh_field, k1_rays(c2w_m, 225.0, (111.5, 111.5), 160, 144,
                                                    *m_box, x0=32.0, y0=40.0), 96),
        "blob_ref_320x240": (blob_field, k1_rays(c2w_b, 300.0, (159.5, 119.5), 320, 240, *b_box), 48),
    }
    k1 = phase_k1(k1_sets, device)

    # phase 4: K2 against its plain version at the staged render's shapes
    k2 = phase_k2(device, meta["aabb"])

    # phase 5: the staged render of the mesh view through K2 and through plain
    phase_staged(device, mesh_field, m_box, c2w_m)

    # phases 6-7: the fused main path, counted
    fused_mlp.reset_launch_counts()
    blob = phase_blob(device)
    tracker, queries, mesh = phase_mesh(device)
    fused_launches = {k: fused_mlp.launch_count(k) for k in (fused_mlp.K1, fused_mlp.K2)}

    # phase 8: per-stage times of one steady fused frame
    phase_stages(tracker, queries, device)

    # phase 9: the stepwise reference-exact path, each run counted on its own
    phase_stepwise(device, torch.float32)
    step_tracker, step_frames, step_gt, step_launches = phase_stepwise(device, torch.bfloat16)

    # phase 10: per-stage times of one steady stepwise frame
    phase_stepwise_stages(step_tracker, step_frames, step_gt)

    # phase 11: each path went through its kernel
    log(f"[launches] phases 6-7 (fused frames): K1 {fused_launches[fused_mlp.K1]}, "
        f"K2 {fused_launches[fused_mlp.K2]}; phase 9 (stepwise, UNet bf16): K1 {step_launches[fused_mlp.K1]}, "
        f"K2 {step_launches[fused_mlp.K2]}")
    check(fused_launches[fused_mlp.K1] > 0, "K1 was never launched on the fused main path")

    main_shape = k1[0]
    log(json.dumps({"kernels": [
        {
            "name": "fused_march_render",
            "route": "cuda",
            "source": "pixtrack_tpu_torch/csrc/march_render.cu",
            "replaces": "pixtrack_tpu/nerf/fused_mlp.py:300",
            "launches": fused_launches[fused_mlp.K1],
            "max_abs_err": max(r["err"] for r in k1),
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": None,
        },
        {
            "name": "fused_distilled_eval",
            "route": "cuda",
            "source": "pixtrack_tpu_torch/csrc/distilled_eval.cu",
            "replaces": "pixtrack_tpu/nerf/fused_mlp.py:232",
            "launches": step_launches[fused_mlp.K2],
            "max_abs_err": k2["err"],
            "ms": k2["ms"],
            "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"],
            "bound_by": k2["bound_by"],
            "library_ms": None,
        },
    ]}))
    log(f"[summary] {smi}: blob FPS {blob['fps']:.2f}, mesh closed-loop FPS {mesh['fps']:.2f}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
