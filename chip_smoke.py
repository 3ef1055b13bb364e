#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's tracking main path once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, builds the port's CUDA kernels from ``pixtrack_tpu_torch/csrc``
at first use (nvcc, one process per source, in parallel), and imports
nothing of JAX. Phases:

1. the device, and the card's name and power limit from nvidia-smi;
2. the kernel builds;
3. K1 (the fused ray march) against its plain PyTorch version at the main
   path's shapes, miss rays included, with CUDA-event times for both, the
   samples it walked through the network beside the samples its rays need,
   and its outputs bit-equal under a permutation of the rays;
4. K2 (the per-sample field evaluation) against its plain version at the
   staged render's chunk sizes, with CUDA-event times for both at a coarse
   and a fine chunk, and both against the exact (f64) sums;
5. the staged render (64 coarse + 32 importance samples) of the mesh view,
   through K2 and through K2's plain version, its time split into K2 and
   the plain PyTorch work around it;
6. the blob world, open loop (the per-frame step of bench.py:75-233 through
   the port): rotation/translation error, LM iterations, FPS;
7. the mesh world, closed loop (bench.py:258-440 through the port's
   ``PixTrackTracker.run_fused``): ADD / ADD-S AUC, rotation error,
   successes, FPS, over several chains whose cold starts differ in their
   last bits; then the same fused frame in open loop, each frame from the
   previous frame's ground truth;
8. per-stage CUDA-event times of one steady fused mesh frame;
9. the mesh world through the stepwise reference-exact tracker
   (``PixTrackTracker.run`` with ``fast_render=False`` and the NeRF-depth
   mask): every render goes through K2 and none through K1;
10. per-stage CUDA-event times of one steady stepwise frame;
11. the launch counts: K1 over phases 6-7, K2 (and no K1) over phase 9;
12. jittered renders: ``Testbed.render(spp=4)`` of the mesh view at 224x224
    and 640x480, every sample through K2 and none through K1, the same
    image bit for bit under the same seed;
13. the tracker lineage on the mesh world's first 10 frames through
    ``PoseTracker.run``: r6 and r7 (references rendered at the SfM images'
    own poses through K1, memoized);
14. r3 (``RollTracker``, references rendered at the SfM poses) on the same
    frames rolled in-plane from 0 to 30 degrees: the tracked roll beside
    the ground truth's;
15. the YCB evaluation protocol (``YCBTracker`` over (path, image,
    ground-truth pose, camera) tuples): its ``summary()``, the cold
    start's snap to the ground truth;
16. the optimizer trace: one steady stepwise frame with a ``DebugTracker``
    attached against the same frame without;
17. the capture for the asset path: the mesh world's 42-view mapping rig at
    448x448 from the port's rasteriser, in NeRF space, its crop box and ray
    pool;
18. the hash-grid field trained at full width on it: loss history, steps/s,
    a CUDA-event split of one step, hold-out PSNR against JAX's on the CPU;
19. a snapshot of it, loaded and baked: dense levels equal to the vertex
    field bit for bit;
20. distillation and fine-tune of the baked field into a student, saved;
    the student's renders through the Testbed (K1 and K2, counted), both
    kernels against their plain versions on the fine-tuned weights and after
    an in-place update of them, and hold-out PSNRs beside the teacher's and
    the shipped field's;
21. the procedural house of the shipped build (``make_house_obj``), written
    by the port: the same OBJ text and atlas pixels as ``assets/mesh_world/src``;
22. ``sfm-from-obj`` (``pixtrack_tpu_torch.pipelines.cli``) on the shipped
    rig, 42 views of 448x448: render, Harris detection and description,
    861 pairs matched and filtered, tracks and triangulation on the card,
    against the JAX package's model of the same rig;
23. ``train-nerf`` (cut to a few hundred steps) and ``nerf-sfm``: the views
    re-rendered from the baked hash field and triangulated again, no K1 or
    K2 launched;
24. ``augment`` of phase 22's model: 504 images, database.db, covis.pkl,
    poses equal to the shipped ``aug_sfm``'s;
25. phase 7's fused closed loop and open loop over the model of phase 24,
    with the shipped field;
26. ``bundle-adjust`` (the CLI) on phase 22's model, and ``bundle_adjust``
    of a perturbed copy of it, against the JAX package's outcome on its own
    model (``scripts_dev/refine_mesh_jax.npz``);
27. featuremetric refinement, the mapper's polish order: keypoint
    adjustment, BA, featuremetric BA (2 rounds) with the handcrafted
    extractor, its wall time split into extraction, KA, BA, the pose block
    and the point block; held to JAX's as phase 26;
28. photometric track refinement, then BA; held to JAX's as phase 26;
29. phase 7's fused frame in open loop over phase 27's refined model, with
    phase 7's open-loop gate;
30. the JAX package's headline mapper rig without poses: 10 views of a
    textured cube over a 17-degree-step arc at 192 px through
    ``incremental_sfm`` at the ``reconstruct`` defaults (KA, two
    featuremetric BA rounds) at seeds 0-7, each run's wall time split by
    stage, the median outcome held to the JAX test's gates and to JAX's on
    the CPU; seed 0's RANSAC calls run again on the CPU on the same draws;
31. ``reconstruct`` (the CLI) over phase 30's images written to a mapping
    folder, the camera inferred from the image size, and what it runs at
    seeds 1-6, the median held to JAX's;
32. a capture of the house, 36 renders at 448 px on a ring at the mesh
    world's orbit elevation, reconstructed without their poses at the CLI's
    settings for 448 px, against JAX's outcome on the same renders;
33. phase 7's fused frame in open loop over phase 32's model and over
    JAX's, each aligned to the rig's frame by a similarity of the camera
    centres, K1 launches counted;
34. the UNet trained with warp-consistency InfoNCE at its default widths
    (``features/train.py``), steps cut: loss history, steps/s, a CUDA-event
    split of one step, the loss on a fixed batch before and after;
35. the UNet trained through the unrolled aligner at the shipped run's
    config (``features/train_basin.py``, seed 0, steps cut): loss and
    gradient-norm history, steps/s, a CUDA-event split of one eager step and
    the time of one CUDA-graph replay of it; the weights saved in the JAX
    package's format and read back bit for bit;
36. the held-out alignment benchmark (``features/evaluate.py``, 12 scenes x
    4 starts, the production LM) on the JAX package's own scenes
    (``scripts_dev/evaluate_jax.npz``) for the shipped UNet and the
    handcrafted pyramid, held to JAX's per-start outcome, and for phase 35's
    UNet, held between them (in worker processes while phase 37 runs);
37. phase 7's fused frame in open loop with phase 35's UNet, K1 launches
    counted;
38. the command line: ``demo`` (6 frames, the JAX test's success gate);
    ``track`` over phases 21-24's object folder with the mesh world's
    first 10 queries as PNGs, its ``poses.pkl`` against the same tracker
    called through the API; ``eval`` of those poses with the ground truth
    added, against ``evaluate_trajectory``; ``visualize`` of three poses;
39. the learned SfM components: the dense descriptor and SuperPoint (the
    candidate weights) on a 448 px render, and the attention matcher
    (seeded init weights) on one arc-rig pair, each on the card against
    the port on the CPU; ms per call; the deployment A/B of the dense
    descriptor against the patch descriptor on held-out mesh pairs, held to
    JAX's counts on the CPU (``scripts_dev/learned_mapping_jax.json``);
40. ``reconstruct --detector dense`` over phase 30's images and what it
    runs at seeds 1-7 (in worker processes, while phases 38-39 run), the
    median held to JAX's over seeds 0-7;
41. offline tracking at batch (``parallel/video.py``): B = 1 and 8 videos
    of the mesh world's 20-frame orbit from perturbed first poses,
    every video's reference rendered in one K1 launch a timestep, each video
    held to the JAX package's run of it (``scripts_dev/video_batch_jax.npz``);
    frames/s at each B, the gaps between B = 8 and B = 1, one B = 8
    step's CUDA-event split, K1 at B * 224 * 224 rays against its plain
    version; ``track-batch`` through the CLI over phases 21-24's object
    folder against the same calls through the API;
42. the dense descriptor trained on the card at its recipe's widths, steps
    and scenes cut (its banks built in worker processes while phase 41
    runs): the logged losses, held-out InfoNCE against the untrained net's,
    steps/s, and phase 39's A/B with the trained net;
43. the attention matcher trained on the card: the plane-pair trainer and
    the mesh-pair bank trainer on its host path at seeds 0-2 and on its
    device-resident path, held-out NLLs against the untrained matcher's,
    steps/s;
44. SuperPoint trained on the card: the MagicPoint trainer with its texture
    label bank and the dense-distillation trainer with its pair bank (the
    banks built in worker processes while phases 41-43 run), steps cut:
    logged losses, the held-out detector and descriptor terms each against
    the untrained net's, steps/s and a CUDA-event split of a step; cell
    labels on the card against the CPU; both repeatability gates for the
    candidate weights and Harris held to JAX's on the CPU
    (``scripts_dev/superpoint_jax.npz``), and for the untrained and the two
    trained nets.

Every phase prints its wall time. Every check raises on failure, so any failed phase exits non-zero. The
second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
K1_TOL = 5e-3             # alpha and rgb, as tests/test_fused_mlp.py
K1_DEPTH_TOL = 1e-2       # depth (NeRF units, ~2) on rays with alpha > 0.01 on both sides
# With trained weights a flipped bf16 activation (see the K2 rule below) at a
# ray's surface sample moves its colour: K1_TOL holds on K1_SHARE of the rays
# and K1_TRAINED_ALL_TOL on all. Measured at the mesh reference (H100 80GB
# HBM3, 700 W): one ray of 50,176 at 7.3e-3 in rgb, all others within 5e-3,
# and there the plain version is the one 7.3e-3 from the exact sums.
K1_SHARE, K1_TRAINED_ALL_TOL = 0.999, 1e-2
# Both kernels are also held to the exact (f64) sums of the same bf16 products
# no worse than their plain versions are: the share of rays (K1) or samples
# (K2) further than 5e-3 from the exact sums may be EXACT_RATIO times the plain
# version's share plus EXACT_SLACK. Measured: K2, mesh field, 5.3e-4 of the
# samples against the plain version's 4.5e-4 in rgb, 3.8e-4 against 2.9e-4 in
# log1p(sigma); K1, blob set, 5 rays of 76,800 against 2.
# On the fine-tuned students of phase 20 this rule replaces the bound on every
# ray: the full-budget student's worst K1 ray (scripts_dev/asset_build_full.py)
# is 4.3e-3 from the exact sums where its plain version is exact; its
# 96 samples through K2 (the same network) hold one sample 4.8e-2 off in a
# flipped bf16 rounding, and composited in f64 they give K1's output to 7e-7.
# So K1 composites right and the tail is the network's tensor-core sum order,
# which a fine-tuned field may carry past any fixed bound (another run: 1.63e-2).
EXACT_RATIO, EXACT_SLACK = 1.5, 1e-4
# K2 against its plain version, on rgb and on log1p(sigma) (that is
# softplus(h), the quantity whose error is absolute; sigma itself reaches 6e5
# on the mesh field): K2_BULK_TOL on K2_BULK_SHARE of the samples, K2_ALL_TOL
# on all. The tensor cores sum each layer's exact bf16 products in another
# order than the plain version's f32 matmul, so now and then a hidden
# activation rounds to the other bf16 neighbour, and the trained fields' large
# weights carry that flip to the outputs. Measured on 1,048,576 samples of the
# mesh field (H100 80GB HBM3, 700 W): kernel vs plain 99.937 % of the samples
# within 5e-3 in rgb and 99.955 % in log1p(sigma), maxima 2.4e-2 and 4.2e-2
# (5.2e-2 on the ragged set); the plain version against the exact (f64) sums
# of the same products: 99.955 % and 99.971 %, maxima 1.6e-2 and 4.4e-2; the
# kernel against them: 99.947 % and 99.962 %. So the tail is the function's, not the
# kernel's; phase 4 prints both against the exact sums. Random-weight fields
# are held to K2_RANDOM_ALL_TOL on all samples (measured maxima: rgb 4.9e-3,
# sigma 2.4e-3 absolute, over the former 2e-3 + 1e-5 relative rule on sigma,
# which held only while kernel and plain version summed in one order).
K2_BULK_TOL, K2_BULK_SHARE, K2_ALL_TOL, K2_RANDOM_ALL_TOL = 5e-3, 0.999, 6e-2, 1e-2
# The staged render through K2 against the same render through K2's plain
# version, trained weights: alpha and rgb under K1's trained-weights rule
# (measured at 640x480: alpha 4.0e-3, rgb 4.96e-3, a hair under STAGED_TOL);
# depth on rays with alpha > 0.01 on both sides, as K1's: the render's depth
# jumps from 0 to the weighted mean where alpha crosses 1e-4, so a last-bit
# difference in alpha there shows as the whole depth (measured: 2.86).
STAGED_TOL = 5e-3
BLOB_GATE_DEG = 3.0
# The mesh world's closed loop hangs on frames 3 and 4 of these 20 (frame k is
# the k-th after the cold start's). From one state (0.72 deg off, cost 0.0818)
# the LM of frame 4 ends, by the last bits of that state, 0.67 deg off at cost
# 0.0921, 1.85 deg off at 0.0861 or 0.77 deg off at 0.0832: the cost does not
# rank the poses by their rotation error, the success gate (110 % of the cold
# start's cost, 0.0906) refuses the first, and after one miss the
# relocalization to the upright view cannot reach the orbit again. Why the
# nearest pose costs most is open. So the loop is run MESH_CHAINS times, the
# cold start's translation moved by k * 1e-6 along x in chain k (a few ulps):
# the best chain must reach MESH_MIN_OK successes at a rotation median of
# MESH_MED_GATE_DEG, and a second chain must reach that count (MESH_GATES).
# Measured on one H100 (80GB HBM3, 700 W), chains 0-5: 3, 15, 15, 2, 15, 15 of
# 20 (7, 15, 15, 15, 15, 15 once the UNet rounds as XLA's does); every chain
# that passes frame 4 reaches 15/20 (first miss frame 16) at a rotation
# median of 1.77-2.43 deg. With K1's plain version rendering, one
# cold start gave 15/20 and one that differed in its last bits 2/20. The same
# fused frame is also held in open loop, each frame started from the previous
# frame's ground truth, where a flip costs one frame and not the rest. Measured
# there: 15/20 (17/20 with the UNet rounding as XLA's), rotation median 1.31 deg; three of the five misses cost
# 0.0912-0.0916 and two of the successes 0.0883-0.0887, so that count is held
# to MESH_MIN_OK too. The chains were cut from 6 to MESH_CHAINS (chains 0-3)
# to keep the script inside its time limit once phases 34-37 came (the
# measured runs above: 3, 15, 15, 2 and 7, 15, 15, 15 over chains 0-3).
MESH_MIN_OK, MESH_MED_GATE_DEG, MESH_CHAINS = 13, 3.0, 4
MESH_GATES = {"best_ok": MESH_MIN_OK, "best_med": MESH_MED_GATE_DEG, "second_ok": MESH_MIN_OK,
              "open_ok": MESH_MIN_OK, "open_med": MESH_MED_GATE_DEG}
# The JAX package's stepwise tracker on the same 10 frames, on the CPU
# (scripts_dev/stepwise_mesh_jax.py): UNet f32 3/10 successes, rotation
# median 3.99 deg; UNet bf16 10/10, 1.99 deg. Its bf16 run owes its 10/10 to
# frame 2, where XLA's bf16 UNet lands the LM in a lower minimum (cost
# 0.0798) than XLA's f32 UNet from the same start. Since the port's UNet
# rounds where XLA's compiled one rounds, the card lands there too
# (0.0797) and reaches 10/10 at 2.40 deg in bf16 and 10/10 at 2.11 deg in f32
# (NVIDIA H100 80GB HBM3, 700 W). Each run is held to JAX's count of its dtype
# less one success; the rotation median to 3 deg.
STEP_GATES = {"float32": (3 - 1, 3.0), "bfloat16": (10 - 1, 3.0)}
# Phase 12. The mean of four jittered 64 + 32 sample renders against the
# deterministic render, on rgb where alpha > 0.99 in both. Measured on one
# H100 (80GB HBM3, 700 W): max 0.0232 (mean 0.00155) at 224x224, max 0.0334
# (mean 0.00155) at 640x480; the gate is about twice that.
JITTER_TOL = 0.06
# Phases 13-15. The JAX package's trackers of the same variants on the same 10
# frames, on the CPU (scripts_dev/variants_mesh_jax.py, UNet bf16): successes of
# 10 and rotation median, deg. The card is held to that count less one and
# that median plus 0.5 deg. The static-reference variants are weak on this
# world, in JAX too: the gate (110 % of the cold start's cost, which starts at
# a mapping view) refuses frames whose pose is good (r6: 8 of 10 frames within
# 1.3 deg, 3 accepted), and a refused frame relocalizes to the upright view,
# which the orbit leaves behind. The YCB protocol relocalizes to the ground
# truth and holds 10/10 (ADD AUC 0.811, ADD-S 0.864 at 0.1 absolute).
# Measured on one H100 (80GB HBM3, 700 W): r6 4/10 at 1.12 deg, r7 4/10 at
# 4.20, r3 3/10 at 9.70, YCB 10/10 at 2.22 (ADD AUC 0.850, ADD-S 0.896).
JAX_VARIANTS = {"r6": (3, 1.12), "r7": (4, 4.25), "r3": (2, 9.66), "ycb": (10, 2.95)}
# r3's queries are rolled in-plane from 0 to ROLL_MAX_DEG over the frames. JAX's
# r3 follows the roll while it tracks (frame 1: -4.21 deg tracked, -3.33 true)
# and loses the object at frame 2 (cost 0.0896 over the gate 0.0891); from then
# on it relocalizes to the upright view's roll of 0. So the tracked roll is
# held to the ground truth's within ROLL_GATE_DEG on the frames that succeed
# (measured on the card: frames 0-2 succeed, 0.08, 0.99 and 0.33 deg off).
UP_WORLD, ROLL_MAX_DEG, ROLL_GATE_DEG = (0.0, 1.0, 0.0), 30.0, 2.0
# Phase 16. The traced refinement (the classic LM, without level arbitration,
# as the JAX package's) against the plain one (deferred accept) on frame 1:
# the CPU test's tolerances for the two loops (tests/test_torch_align.py:
# 0.02 deg, 2e-4, 1e-3 relative). Measured on one H100 (80GB HBM3, 700 W):
# 0.0000 deg, 3.9e-5 and 4.2e-6 apart, after 25, 150 and 39 traced iterations.
# With the UNet rounding where XLA rounds the two loops part by
# 0.0273 deg on the card, both 5.02 deg from the ground truth at costs 1.03e-6
# apart, in each of three runs (every number printed equal: the gap is
# deterministic, no spread between runs); the rotation is held to that
# reading with 1.8x room, 0.05 deg.
TRACE_ROT_DEG, TRACE_T, TRACE_COST_REL = 0.05, 2e-4, 1e-3
# an H100 SXM's dense bf16 tensor-core rate and memory bandwidth, the bounds' peaks
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def timed_phase(name, fn, *args, **kwargs):
    """Run one phase and print its wall time (host clock)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


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


def share_within(err, tol: float) -> float:
    """The share of the errors (a tensor) at or under tol."""
    return float((err <= tol).float().mean())


def exact_field(field, xT, dT):
    """DistilledField.field_T with every layer's sums taken in f64: the exact
    sum of the same bf16 products, rounded to f32 once. The yardstick that
    both K2 and its plain version are printed against."""
    import torch
    import torch.nn.functional as F

    from pixtrack_tpu_torch.nerf.field import sh_encoding_deg4_T

    def dense(p, h):
        w = p["kernel"].to(torch.bfloat16).double()
        return (w @ h.to(torch.bfloat16).double() + p["bias"].double()).float()

    h = field.encode_T(xT)
    for p in field.trunk:
        h = torch.relu(dense(p, h))
    h = dense(field.head, h)
    sigma = torch.expm1(F.softplus(h[0]))
    c = torch.cat([h[1:], sh_encoding_deg4_T(dT)], dim=0)
    for p in field.color[:-1]:
        c = torch.relu(dense(p, c))
    return sigma, torch.sigmoid(dense(field.color[-1], c))


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
    """Max |a - b| of alpha, rgb, and depth where both alphas exceed 0.01,
    and the share of rays whose alpha and rgb all lie within K1_TOL."""
    import torch

    per_ray = torch.maximum((out["alpha"] - ref["alpha"]).abs(), (out["rgb"] - ref["rgb"]).abs().amax(dim=1))
    errs = {k: float((out[k] - ref[k]).abs().max()) for k in ("alpha", "rgb")}
    both = (out["alpha"] > 0.01) & (ref["alpha"] > 0.01)
    errs["depth"] = float((out["depth"] - ref["depth"])[both].abs().max()) if bool(both.any()) else 0.0
    errs["share"] = share_within(per_ray, K1_TOL)
    return errs


class ExactField:
    """A field whose field_T takes every layer's sums in f64 (exact_field)."""

    def __init__(self, field):
        self.field = field

    def field_T(self, xT, dT):
        return exact_field(self.field, xT, dT)


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


def timed_in_turns(kern, plain, k_iters=5, p_iters=3):
    """CUDA-event times (ms) of a kernel and its plain version, in turns on
    one card: plain, kernel, kernel, plain."""
    kern(), plain()  # warm-up
    t_plain = cuda_time_ms(plain, p_iters)
    t_k = cuda_time_ms(kern, k_iters)
    t_k = 0.5 * (t_k + cuda_time_ms(kern, k_iters))
    return t_k, 0.5 * (t_plain + cuda_time_ms(plain, p_iters))


def phase_k1(worlds, device):
    """K1 against its plain version on each ray set, with random
    production-shape weights (init_distilled) and with the shipped trained
    weights, held to K1_TOL on alpha and rgb and K1_DEPTH_TOL on depth.
    Times both versions with CUDA events, reads the kernel's count of
    samples walked through the network beside the samples the rays need,
    and on the first set holds the outputs bit-equal under a permutation
    of the rays."""
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
            for label, fld in (("random weights", random_field), ("trained weights", field)):
                out = fused_mlp.fused_march_render(fld, o_g, d_g, tn, tf, S, 1e-7)
                ref = fused_mlp.march_render_reference(fld, o_g, d_g, tn, tf, S, 1e-7)
                torch.cuda.synchronize()
                for k in ("alpha", "rgb", "depth"):
                    check(bool(torch.isfinite(out[k]).all()), f"K1 {name}: non-finite {k}")
                errs[label] = e = k1_errors(out, ref)
                tol_all = K1_TOL if label == "random weights" else K1_TRAINED_ALL_TOL
                check(max(e["alpha"], e["rgb"]) <= tol_all and e["share"] >= K1_SHARE and e["depth"] <= K1_DEPTH_TOL,
                      f"K1 {name} ({label}) disagrees with its plain version: {e}")
            walked = fused_mlp.last_samples_evaluated()  # of the trained field's launch
            exact = fused_mlp.march_render_reference(ExactField(field), o_g, d_g, tn, tf, S, 1e-7)
            errs["trained weights, kernel vs the exact sums"] = e_k = k1_errors(out, exact)
            errs["trained weights, plain vs the exact sums"] = e_p = k1_errors(ref, exact)
            check(1 - e_k["share"] <= EXACT_RATIO * (1 - e_p["share"]) + EXACT_SLACK,
                  f"K1 {name}: the kernel is further from the exact sums ({e_k}) than its plain version ({e_p})")

            if not results:  # a ray's result must not depend on the slot it ran in
                perm = torch.as_tensor(np.random.default_rng(7).permutation(len(tn)), device=device)
                again = fused_mlp.fused_march_render(field, o_g[perm], d_g[perm], tn[perm], tf[perm], S, 1e-7)
                check(all(bool((again[k] == out[k][perm]).all()) for k in out),
                      f"K1 {name}: outputs differ under a permutation of the rays")
                log(f"[k1] {name}: outputs bit-equal under a random permutation of the {len(tn)} rays")

            def kern():
                fused_mlp.fused_march_render(field, o_g, d_g, tn, tf, S, 1e-7)

            def plain():
                fused_mlp.march_render_reference(field, o_g, d_g, tn, tf, S, 1e-7)

            t_k, t_plain = timed_in_turns(kern, plain)
        log(f"[k1] {name}: R={len(tn)} S={S} octaves={field.octaves} misses={misses}; max |kernel - plain| "
            + "; ".join(f"{label}: alpha {e['alpha']:.3e} rgb {e['rgb']:.3e} depth {e['depth']:.3e} "
                        f"({e['share']:.6f} of the rays within {K1_TOL})" for label, e in errs.items())
            + f"; kernel {t_k:.3f} ms, plain {t_plain:.3f} ms")
        check(t_k < t_plain, f"K1 {name}: the kernel ({t_k:.3f} ms) is not faster than its plain version")
        err = max(errs[label][k] for label in ("random weights", "trained weights") for k in ("alpha", "rgb"))
        needed = k1_samples_needed(field, rays, S)
        b_ms, b_by = bound(needed * mlp_flops(field.octaves), len(tn) * (8 + 5) * 4)
        log(f"[k1] {name}: {needed} samples needed ({len(tn) - misses} hit rays x {S} = "
            f"{(len(tn) - misses) * S}); the kernel walked {walked['evaluated']} samples through the network "
            f"({walked['evaluated'] / needed:.3f} x needed), {walked['live']} of them of a ray that could still "
            f"add colour; bound {b_ms:.4f} ms ({b_by})")
        check(walked["hit_rays"] == len(tn) - misses, f"K1 {name}: the kernel listed {walked['hit_rays']} hit rays")
        check(abs(walked["live"] - needed) <= 0.01 * needed,
              f"K1 {name}: the kernel's live samples ({walked['live']}) are not the samples needed ({needed})")
        results.append({"shape": name, "err": err, "ms": t_k, "plain_ms": t_plain,
                        "bound_ms": b_ms, "bound_by": b_by})
    return results


# ----------------------------------------------------------------- phase 4 --
def phase_k2(device, aabb):
    """K2 against its plain version at the staged render's shapes (a coarse
    chunk of 16384 rays x 64 samples, a fine chunk x 32, and a ragged N),
    positions uniform in the mesh world's crop box and unit directions, on
    random production-shape fields and the shipped trained ones, under the
    K2_* rule on rgb and log1p(sigma). On the coarse chunk both versions are
    also printed against the exact sums. Times both versions with CUDA
    events on the coarse and the fine chunk with the mesh field."""
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
    err, timing = 0.0, {}
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
                e_c = (rgb - c_ref).abs().amax(dim=0)  # per sample
                e_s = (torch.log1p(sigma) - torch.log1p(s_ref)).abs()
                tol_all = K2_ALL_TOL if fname in ("bench_field", "mesh field") else K2_RANDOM_ALL_TOL
                for what, e in (("rgb", e_c), ("log1p(sigma)", e_s)):
                    check(share_within(e, K2_BULK_TOL) >= K2_BULK_SHARE and float(e.max()) <= tol_all,
                          f"K2 {set_name} ({fname}) disagrees with its plain version on {what}: "
                          f"{share_within(e, K2_BULK_TOL):.5f} within {K2_BULK_TOL}, max {float(e.max()):.3e}")
                err = max(err, float(e_s.max()), float(e_c.max()))
                line = (f"{fname}: rgb max {float(e_c.max()):.3e} ({share_within(e_c, K2_BULK_TOL):.6f} within "
                        f"{K2_BULK_TOL}), log1p(sigma) max {float(e_s.max()):.3e} ({share_within(e_s, K2_BULK_TOL):.6f}), "
                        f"sigma max |diff| {float((sigma - s_ref).abs().max()):.3e} of sigma max {float(s_ref.max()):.3g}")
                if set_name == "coarse_chunk":
                    s_ex, c_ex = exact_field(field, x, d)
                    to_exact = (
                        ("rgb", (rgb - c_ex).abs().amax(dim=0), (c_ref - c_ex).abs().amax(dim=0)),
                        ("log1p(sigma)", (torch.log1p(sigma) - torch.log1p(s_ex)).abs(),
                         (torch.log1p(s_ref) - torch.log1p(s_ex)).abs()))
                    line += "; against the exact sums, kernel / plain: " + ", ".join(
                        f"{what} max {float(a.max()):.3e} / {float(b.max()):.3e}, within {K2_BULK_TOL} "
                        f"{share_within(a, K2_BULK_TOL):.6f} / {share_within(b, K2_BULK_TOL):.6f}"
                        for what, a, b in to_exact)
                    for what, a, b in to_exact:
                        check(1 - share_within(a, K2_BULK_TOL)
                              <= EXACT_RATIO * (1 - share_within(b, K2_BULK_TOL)) + EXACT_SLACK,
                              f"K2 {set_name} ({fname}): the kernel is further from the exact sums than its "
                              f"plain version on {what}")
                parts.append(line)
            log(f"[k2] {set_name}: N={N}; |kernel - plain| " + " || ".join(parts))
            if set_name in ("coarse_chunk", "fine_chunk"):
                field = fields["mesh field"]

                def kern():
                    fused_mlp.fused_distilled_eval(field, x, d)

                def plain():
                    fused_mlp.distilled_eval_reference(field, x, d)

                t_k, t_plain = timed_in_turns(kern, plain, k_iters=20)
                b_ms, b_by = bound(N * mlp_flops(field.octaves), N * (6 + 4) * 4)
                log(f"[k2] {set_name}, mesh field (10 octaves): kernel {t_k:.3f} ms, plain {t_plain:.3f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by})")
                check(t_k < t_plain, f"K2 {set_name}: the kernel ({t_k:.3f} ms) is not faster than its plain version")
                timing[set_name] = {"ms": t_k, "plain_ms": t_plain, "bound_ms": b_ms, "bound_by": b_by}
    return {"err": err, **timing["coarse_chunk"]}


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


def staged_split(render):
    """One staged render with CUDA events around every K2 call: (the
    render's ms, the ms inside K2)."""
    import torch

    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf import render as render_mod

    spans = []

    def timed_eval(field, xT, dT):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fused_mlp.fused_distilled_eval(field, xT, dT)
        b.record()
        spans.append((a, b))
        return out

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    render_mod.fused_distilled_eval = timed_eval
    try:
        torch.cuda.synchronize()
        start.record()
        render()
        stop.record()
        torch.cuda.synchronize()
    finally:
        render_mod.fused_distilled_eval = fused_mlp.fused_distilled_eval
    return start.elapsed_time(stop), sum(a.elapsed_time(b) for a, b in spans)


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
            errs = k1_errors(out, ref)
            check(all(bool(torch.isfinite(out[k]).all()) for k in out), f"staged render {w}x{h}: non-finite")
            check(max(errs["alpha"], errs["rgb"]) <= K1_TRAINED_ALL_TOL and errs["share"] >= K1_SHARE
                  and errs["depth"] <= STAGED_TOL, f"staged render {w}x{h}: K2 vs plain {errs}")
            t_plain = cuda_time_ms(plain, 1)
            t_k = cuda_time_ms(kern, 2)
            t_plain = 0.5 * (t_plain + cuda_time_ms(plain, 1))
            t_all, t_k2 = staged_split(kern)
            hit = int((out["alpha"] > 0.01).sum())
            log(f"[staged] {w}x{h}, 64+32 samples, {launches} K2 launches, {hit} rays with alpha > 0.01: "
                f"max |K2 - plain| alpha {errs['alpha']:.3e} rgb {errs['rgb']:.3e} depth {errs['depth']:.3e} "
                f"({errs['share']:.6f} of the rays within {K1_TOL}); "
                f"render through K2 {t_k:.2f} ms, through the plain version {t_plain:.2f} ms; one render split "
                f"(CUDA events): {t_all:.2f} ms = K2 {t_k2:.2f} ms + the plain PyTorch work around it "
                f"{t_all - t_k2:.2f} ms")


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
def mesh_assets(device, n_frames=20, unet_dtype=None, aug_sfm=None, extractor=None):
    """What every mesh-world tracker is built from (bench.py:258-440): the
    SfM scene (the shipped ``aug_sfm`` unless ``aug_sfm`` names another
    model), the extractor (the shipped UNet, bf16 unless ``unet_dtype`` says
    otherwise, unless ``extractor`` is given),
    the Testbed over the trained field, the upright pick, the ground-truth
    orbit of n_frames + 1 poses and the query frames from the mesh
    rasteriser, black background."""
    import types

    import torch

    from pixtrack_tpu_torch.geometry import nerf_transform
    from pixtrack_tpu_torch.features import default_extractor
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
    from pixtrack_tpu_torch.nerf.distill import load_distilled
    from pixtrack_tpu_torch.nerf.testbed import Testbed
    from pixtrack_tpu_torch.sfm.scene import SceneModel
    from smoke_worlds import look_at_w2c

    mw = REPO / "assets" / "mesh_world"
    meta = json.loads((mw / "meta.json").read_text())
    scene = SceneModel.load(aug_sfm or mw / "aug_sfm")
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
    return types.SimpleNamespace(
        scene=scene, n2s=n2s, mesh=mesh, testbed=testbed, up_id=up_id, gt=gt, frames=frames,
        camera=camera.to(device), diameter=float(meta["diameter"]), device=device,
        extractor=extractor or default_extractor(resize=1024, device=device, dtype=unet_dtype or torch.bfloat16))


def mesh_world(device, n_frames=20, unet_dtype=None, assets=None, **config):
    """The mesh world through the port's flagship tracker. ``config``
    overrides fields of bench.py's TrackerConfig; ``assets`` reuses a
    ``mesh_assets`` result instead of building one."""
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.tracking.tracker import PixTrackTracker, TrackerConfig

    a = assets or mesh_assets(device, n_frames, unet_dtype)
    tracker = PixTrackTracker(
        a.scene, a.extractor, a.testbed, a.n2s,
        TrackerConfig(reference_scale=0.5, cost_threshold_min=0.05, covis_threshold=10,
                      refine_rounds=1, upright_ref_img=a.scene.images[a.up_id].name, **config),
        align_cfg=AlignConfig(num_iters=150),
    )
    return tracker, a.camera, a.frames, a.gt, a.mesh, a.diameter


def mesh_chain(step, T0, ok0: bool, thresh, queries, k: int):
    """The fused frames over ``queries`` from the cold start's state ``T0``
    (4, 4), its translation moved by k * 1e-6 along x; no host sync inside."""
    import torch

    device = T0.device
    R, t, ok = T0[:3, :3], T0[:3, 3].clone(), torch.tensor(ok0, device=device)
    t[0] += k * 1e-6
    R2, t2, vel_ok = R, t, torch.tensor(False, device=device)
    outs = []
    for q in queries:
        out = step(R, t, ok, thresh, q, R_prev=R2, t_prev=t2, vel_ok=vel_ok)
        R2, t2, vel_ok = R, t, ok
        R, t, ok = out.R, out.t, out.ok
        outs.append(out)
    return outs


def phase_mesh(device, n_frames=20, aug_sfm=None, gates=None, label="mesh", open_only=False, extractor=None):
    """The fused closed loop over MESH_CHAINS perturbed cold starts, then the
    same fused frame in open loop, on the shipped model or on ``aug_sfm``,
    held to ``gates`` (phase 7's by default); every fused frame after the
    cold start launches K1 once. ``open_only``: the cold start and the open
    loop only. ``extractor`` replaces the shipped UNet."""
    import torch

    from pixtrack_tpu_torch.nerf import fused_mlp

    g = gates or MESH_GATES
    assets = mesh_assets(device, n_frames, aug_sfm=aug_sfm, extractor=extractor)
    tracker, camera, frames, gt, mesh, diameter = mesh_world(device, assets=assets)
    # cold start + fused frames: chain 0 (the cold start alone in open_only)
    outs = tracker.run_fused(frames[:1] if open_only else frames, camera=camera)
    check(len(outs) == (0 if open_only else n_frames), f"{label}: missing frames")
    cold = tracker.pose_history[frames[0][0]]

    step = tracker._fused_step
    thresh = torch.tensor(tracker.cost_threshold, dtype=torch.float32, device=device)
    T0 = torch.as_tensor(cold["T_refined"], dtype=torch.float32, device=device)
    queries = [torch.as_tensor(img, device=device).float() / 255.0 for _, img in frames[1:]]
    if open_only:
        k1_before = fused_mlp.launch_count(fused_mlp.K1)
        return tracker, queries, open_loop(step, thresh, gt, queries, mesh, diameter, g, label, tracker, n_frames,
                                           k1_before, n_frames, device), assets

    def chain(k):
        return mesh_chain(step, T0, bool(cold["success"]), thresh, queries, k)

    def timed_chain(k):
        """Chain k with one sync at its end: the closed loop's FPS."""
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        k_outs = chain(k)
        torch.cuda.synchronize()
        return k_outs, n_frames / (time.perf_counter() - t_start)

    k1_before = fused_mlp.launch_count(fused_mlp.K1)
    unet = str(tracker.refiner.extractor.model.dtype)[6:]
    results = []
    for k in range(MESH_CHAINS):
        if k == 0:
            k_outs = outs
        elif k == 1:
            k_outs, fps = timed_chain(k)
        else:
            k_outs = chain(k)
        add_auc, add_s_auc, rot = pose_metrics([(o.R.cpu().numpy(), o.t.cpu().numpy()) for o in k_outs], gt[1:],
                                               mesh, diameter)
        oks = [bool(o.ok) for o in k_outs]
        results.append({"ok": sum(oks), "rot_med": float(np.median(rot)), "add_auc": add_auc, "add_s_auc": add_s_auc})
        log(f"[{label}] closed loop, chain {k} (cold start moved by {k}e-6), UNet {unet}, {n_frames} frames: "
            f"success {sum(oks)}/{len(oks)}, first miss at frame {oks.index(False) + 1 if False in oks else None}, "
            f"rot med/max {np.median(rot):.2f}/{np.max(rot):.2f} deg, ADD AUC@0.1d {add_auc:.3f}, ADD-S AUC "
            f"{add_s_auc:.3f}; per-frame cost {[round(float(o.cost), 4) for o in k_outs]} vs threshold "
            f"{tracker.cost_threshold:.4f}; per-frame rot err deg {[round(float(r), 2) for r in rot]}")
    ranked = sorted(results, key=lambda r: -r["ok"])
    best = ranked[0]
    if "ranked" in g:
        gate_text = "ranked chains >= / <= " + ", ".join(f"{ok} / {med:.2f} deg" for ok, med in g["ranked"])
    else:
        gate_text = f"best >= {g['best_ok']} at <= {g['best_med']:.2f} deg, second >= {g['second_ok']}"
    log(f"[{label}] closed loop, {MESH_CHAINS} chains: successes {[r['ok'] for r in results]} of {n_frames} "
        f"(BENCH_r05 18/20); the best chain: rot med {best['rot_med']:.2f} deg (1.63), ADD AUC@0.1d "
        f"{best['add_auc']:.3f} (0.685), ADD-S AUC {best['add_s_auc']:.3f} (0.750); cold-start cost "
        f"{cold['cost']:.4f}; chain 1 FPS = {fps:.2f}; gates: {gate_text}")
    if "ranked" in g:
        # both sides ranked by (successes, median), as REBUILT_GATES ranks JAX's chains
        by_ok_med = sorted(results, key=lambda r: (-r["ok"], r["rot_med"]))
        for i, (r, (min_ok, max_med)) in enumerate(zip(by_ok_med, g["ranked"])):
            check(r["ok"] >= min_ok and r["rot_med"] <= max_med,
                  f"{label}: ranked chain {i} has {r['ok']} successes at {r['rot_med']:.2f} deg, gate {min_ok} at "
                  f"{max_med:.2f}")
    else:
        check(best["ok"] >= g["best_ok"], f"{label}: the best chain has {best['ok']} successes < {g['best_ok']}")
        check(best["rot_med"] <= g["best_med"], f"{label}: the best chain's rotation median {best['rot_med']:.2f} deg")
        check(ranked[1]["ok"] >= g["second_ok"], f"{label}: the second chain has {ranked[1]['ok']} < {g['second_ok']}")

    # chains 1.. and the open loop
    opened = open_loop(step, thresh, gt, queries, mesh, diameter, g, label, tracker, n_frames, k1_before,
                       MESH_CHAINS * n_frames, device)
    return tracker, queries, {"fps": fps, "chains": [r["ok"] for r in results], **opened}, assets


def open_loop(step, thresh, gt, queries, mesh, diameter, g, label, tracker, n_frames, k1_before, fused_frames,
              device):
    """The fused frame in open loop, each frame from the previous frame's
    ground truth, held to ``g``'s open-loop gates; K1 must have launched
    once per fused frame since ``k1_before`` was read (``fused_frames`` of
    them, this loop's included)."""
    import torch

    from pixtrack_tpu_torch.nerf import fused_mlp

    always = torch.tensor(True, device=device)
    open_outs = [step(gt[k].R.to(device).float(), gt[k].t.to(device).float(), always, thresh, q)
                 for k, q in enumerate(queries)]
    o_auc, o_s_auc, o_rot = pose_metrics([(o.R.cpu().numpy(), o.t.cpu().numpy()) for o in open_outs], gt[1:],
                                         mesh, diameter)
    o_oks = [bool(o.ok) for o in open_outs]
    k1 = fused_mlp.launch_count(fused_mlp.K1) - k1_before
    unet = str(tracker.refiner.extractor.model.dtype)[6:]
    log(f"[{label}] open loop (each frame from the previous frame's ground truth), UNet {unet}, {n_frames} frames: "
        f"per-frame cost {[round(float(o.cost), 4) for o in open_outs]}; success {sum(o_oks)}/{len(o_oks)}, "
        f"rot med/max {np.median(o_rot):.2f}/{np.max(o_rot):.2f} deg, ADD AUC@0.1d {o_auc:.3f}, ADD-S AUC {o_s_auc:.3f}"
        f"; K1 launches over the {fused_frames} fused frames counted here: {k1}")
    check(sum(o_oks) >= g["open_ok"], f"{label}, open loop: {sum(o_oks)} successes < {g['open_ok']}")
    check(np.median(o_rot) <= g["open_med"], f"{label}, open loop: rotation median {np.median(o_rot):.2f} deg")
    check(k1 == fused_frames, f"{label}: K1 launched {k1} times over {fused_frames} fused frames")
    return {"open": sum(o_oks)}


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
    min_ok, med_gate = STEP_GATES[unet]
    check(np.median(rot) <= med_gate, f"stepwise, UNet {unet}: rotation median {np.median(rot):.2f} deg > {med_gate}")
    check(oks >= min_ok, f"stepwise, UNet {unet}: {oks} successes < {min_ok}")
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


# ---------------------------------------------------------------- phase 12 --
def phase_jittered(device, a):
    """Testbed.render(spp=4) of the mesh view at the reference size and the
    query size, 64 + 32 samples per ray: the mean of four jittered renders,
    each through the staged render and K2 (a jittered render is not
    eligible for K1). The same seed must give the same image bit for bit,
    another seed another image, and where alpha > 0.99 in both the mean
    must lie within JITTER_TOL of the deterministic spp = 1 render."""
    import torch

    from pixtrack_tpu_torch.nerf import fused_mlp

    tb = a.testbed
    tb.n_coarse, tb.n_fine = 64, 32
    tb.set_nerf_camera_matrix(c2w_nerf(a.scene.pose_w2c(a.up_id, device=device), a.n2s).cpu().numpy()[:3])
    launches = {}
    for w, h, f in ((224, 224, 225.0), (640, 480, 600.0)):
        tb.override_intrinsics = (f, f, (w - 1) / 2, (h - 1) / 2)
        one = tb.render(w, h, spp=1)
        fused_mlp.reset_launch_counts()
        img = tb.render(w, h, spp=4, seed=0)
        n = {k: fused_mlp.launch_count(k) for k in (fused_mlp.K1, fused_mlp.K2)}
        again, other = tb.render(w, h, spp=4, seed=0), tb.render(w, h, spp=4, seed=1)
        check(np.isfinite(img).all() and img.shape == (h, w, 4), f"jittered {w}x{h}: bad image")
        check(n[fused_mlp.K2] > 0 and n[fused_mlp.K1] == 0, f"jittered {w}x{h}: launches {n}")
        check(np.array_equal(img, again), f"jittered {w}x{h}: the same seed gave another image")
        check(not np.array_equal(img, other), f"jittered {w}x{h}: another seed gave the same image")
        solid = (img[..., 3] > 0.99) & (one[..., 3] > 0.99)
        check(solid.sum() > 0.05 * w * h, f"jittered {w}x{h}: the object is not in view")
        err = np.abs(img[..., :3] - one[..., :3])[solid]
        torch.cuda.synchronize()
        ms = cuda_time_ms(lambda: tb.render(w, h, spp=4, seed=0), 2) / 4
        log(f"[jittered] {w}x{h}, spp=4, 64+32 samples: launches K1 {n[fused_mlp.K1]}, K2 {n[fused_mlp.K2]}; same seed "
            f"bit-equal, other seed differs in {float((img != other).mean()):.3f} of the values; |mean of 4 - spp=1| "
            f"where alpha > 0.99 on both ({int(solid.sum())} px): max {err.max():.4f}, mean {err.mean():.5f} "
            f"(gate {JITTER_TOL}); {ms:.2f} ms per spp (CUDA events, host copy included)")
        check(err.max() <= JITTER_TOL, f"jittered {w}x{h}: {err.max():.4f} from the spp=1 render > {JITTER_TOL}")
        launches[(w, h)] = n[fused_mlp.K2]
    return launches


# ----------------------------------------------------------- phases 13-15 --
def variant_tracker(a, name):
    """A tracker of the lineage, or the YCB one, over the mesh world, as
    scripts_dev/variants_mesh_jax.py builds the JAX ones: from the upright
    view, covis_threshold 10, cost_threshold_min 0.05, LM budget 150."""
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.tracking import variants as var
    from pixtrack_tpu_torch.tracking.tracker_ycb import YCBTracker, ycb_tracker_config

    align = AlignConfig(num_iters=150)
    args = (a.scene, a.extractor, a.testbed, a.n2s)
    if name == "r6":
        tracker = var.make_tracker_r6(*args, align_cfg=align)
    elif name == "r7":
        tracker = var.make_tracker_r7(*args, reference_scale=0.5, align_cfg=align)
    elif name == "r3":
        cfg = var._static_cfg(render_at_db_pose=True, num_refs=2, reference_scale=0.5)
        tracker = var.RollTracker(*args, config=cfg, align_cfg=align, up_world=UP_WORLD)
    else:
        tracker = YCBTracker(*args, ycb_tracker_config(), align_cfg=align)
    tracker.config.covis_threshold, tracker.config.cost_threshold_min = 10, 0.05
    tracker.reference_ids = [a.up_id]
    tracker.camera = a.camera
    return tracker


def phase_variant(device, a, name, n_frames=10):
    """One variant over the first n_frames of the orbit through
    PoseTracker.run, held to the JAX tracker of that variant on the same
    frames (JAX_VARIANTS): its successes less one, its rotation median plus
    0.5 deg. r3 gets the frames rolled in-plane from 0 to ROLL_MAX_DEG
    (rotate_image about the principal point; ground truth through
    pre_opt_rotation); the YCB tracker gets (path, image, gt, camera)."""
    import torch

    from pixtrack_tpu_torch.mapping.mesh_render import sample_mesh_surface
    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.tracking import variants as var

    tracker = variant_tracker(a, name)
    frames, gt = a.frames[:n_frames], [T for T in a.gt[:n_frames]]
    seq = frames
    if name == "r3":
        rolls = np.deg2rad(np.linspace(0.0, ROLL_MAX_DEG, n_frames))
        c = tuple(float(v) for v in a.camera.c)
        seq = [(nm, var.rotate_image(torch.as_tensor(img, device=device), np.rad2deg(r), c).cpu().numpy())
               for (nm, img), r in zip(frames, rolls)]
        gt = [var.pre_opt_rotation(T, r) for T, r in zip(gt, rolls)]
    elif name == "ycb":
        seq = [(nm, img, T, a.camera) for (nm, img), T in zip(frames, gt)]
    torch.cuda.synchronize()
    fused_mlp.reset_launch_counts()
    t0 = time.perf_counter()
    tracker.run(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {k: fused_mlp.launch_count(k) for k in (fused_mlp.K1, fused_mlp.K2)}

    recs = [tracker.pose_history[nm] for nm, _ in frames]
    poses = [(r["T_refined"][:3, :3], r["T_refined"][:3, 3]) for r in recs]
    add_auc, add_s_auc, rot = pose_metrics(poses, gt, a.mesh, a.diameter)
    oks = sum(bool(r["success"]) for r in recs)
    jax_ok, jax_med = JAX_VARIANTS[name]
    log(f"[{name}] {n_frames} frames, 96 samples per ray, UNet bf16: per-frame cost "
        f"{[round(float(r['cost']), 4) for r in recs]} vs threshold {tracker.cost_threshold:.4f}; per-frame rot err deg "
        f"{[round(float(r), 2) for r in rot]}; reference ids {[r['reference_ids'] for r in recs]}")
    log(f"[{name}] success {oks}/{n_frames} (JAX on the CPU: {jax_ok}/{n_frames}), rot med/max "
        f"{np.median(rot):.2f}/{np.max(rot):.2f} deg ({jax_med:.2f}), relocalizations {tracker.relocalization_count}, "
        f"ADD AUC@0.1d {add_auc:.3f}, ADD-S AUC {add_s_auc:.3f}, FPS = {n_frames / wall:.3f} ({wall:.2f} s); "
        f"launches K1 {n[fused_mlp.K1]}, K2 {n[fused_mlp.K2]}")
    check(n[fused_mlp.K1] > 0, f"{name}: K1 was never launched (fast_render renders every reference through it)")
    check(oks >= jax_ok - 1, f"{name}: {oks} successes < {jax_ok - 1}")
    check(np.median(rot) <= jax_med + 0.5, f"{name}: rotation median {np.median(rot):.2f} deg > {jax_med + 0.5:.2f}")
    if name == "r3":
        tracked = [float(np.rad2deg(r["tracked_roll"])) for r in recs]
        truth = [float(np.rad2deg(var.roll_of_pose(T, UP_WORLD))) for T in gt]
        log(f"[r3] tracked roll deg {[round(v, 2) for v in tracked]} against the ground truth's "
            f"{[round(v, 2) for v in truth]}")
        check(all("tracked_center" in r for r in recs), "r3: no tracked_center in the pose records")
        gap = np.abs(np.asarray(tracked) - np.asarray(truth))[[bool(r["success"]) for r in recs]]
        check(len(gap) > 0 and gap.max() <= ROLL_GATE_DEG,
              f"r3: on the frames that succeed the tracked roll is up to {gap.max() if len(gap) else np.nan:.2f} deg "
              f"from the truth")
    if name == "ycb":
        summ = tracker.summary(model_points=sample_mesh_surface(a.mesh, 512, seed=3))
        log(f"[ycb] summary: " + ", ".join(f"{k} {v:.4f}" for k, v in summ.items()))
        check(tracker.relocalization_count >= 1, "ycb: the cold start did not relocalize")
        check(np.array_equal(recs[0]["T_init"], a.gt[0].to_4x4().numpy()), "ycb: the cold start did not snap to GT")
        check(all({"gt_pose", "t_error", "r_error_deg"} <= set(r) for r in recs), "ycb: GT errors not recorded")
        check(np.isfinite(list(summ.values())).all(), "ycb: non-finite summary")
    return n


# ---------------------------------------------------------------- phase 16 --
def phase_debug_trace(device, a):
    """One steady stepwise frame (the flagship tracker: fast render, splat
    mask) refined twice from one cold start: with a DebugTracker(debug=1)
    attached to the Refiner and without. The traced refinement (the classic
    LM, level after level) must land where the plain one (deferred accept)
    does, within TRACE_ROT_DEG, TRACE_T and TRACE_COST_REL, and every
    level's trace must hold num_iters costs that do not rise over the
    accepted steps."""
    from pixtrack_tpu_torch.tracking.debug import DebugTracker

    results = {}
    for traced in (False, True):
        tracker = mesh_world(device, assets=a)[0]
        tracker.camera = a.camera
        dbg = DebugTracker(debug=1)
        tracker.run_single_frame(a.frames[0])  # cold start, untraced in both
        if traced:
            tracker.refiner.attach_tracker(dbg)
            dbg.start_frame(a.frames[1][0])
        tracker.run_single_frame(a.frames[1])
        results[traced] = (tracker.pose_history[a.frames[1][0]], dbg)
    plain, (rec, dbg) = results[False][0], results[True]
    check(len(dbg.frames) >= 1 and len(dbg.frames[0]["levels"]) == 3, "debug trace: no per-level traces")
    for lv in dbg.frames[0]["levels"]:
        check(1 <= lv["num_iters"] <= 150 and all(len(lv[k]) == lv["num_iters"] for k in ("costs", "dt", "dR", "accepted")),
              f"debug trace: level {lv['level']} holds {len(lv['costs'])} costs for {lv['num_iters']} iterations")
        acc = lv["costs"][lv["accepted"]]
        check(np.isfinite(lv["costs"]).all() and (np.diff(acc) <= 1e-6).all(),
              f"debug trace: level {lv['level']}: the accepted costs rise")
    d_rot = rot_err_deg(rec["T_refined"][:3, :3], plain["T_refined"][:3, :3])
    d_t = float(np.abs(rec["T_refined"][:3, 3] - plain["T_refined"][:3, 3]).max())
    d_cost = abs(rec["cost"] - plain["cost"]) / plain["cost"]
    log(f"[debug] frame 1 traced vs plain: rotation {d_rot:.4f} deg apart, translation {d_t:.2e}, cost {rec['cost']:.5f} "
        f"vs {plain['cost']:.5f} ({d_cost:.2e} relative); iterations per level (coarse to fine) "
        f"{[lv['num_iters'] for lv in dbg.frames[0]['levels']]}, accepted "
        f"{[int(lv['accepted'].sum()) for lv in dbg.frames[0]['levels']]}; rot err vs ground truth: traced "
        f"{rot_err_deg(rec['T_refined'][:3, :3], a.gt[1].R.numpy()):.2f}, plain "
        f"{rot_err_deg(plain['T_refined'][:3, :3], a.gt[1].R.numpy()):.2f} deg")
    check("T_refined" in dbg.frames[0] and abs(dbg.frames[0]["cost"] - rec["cost"]) < 1e-6, "debug trace: no final pose")
    check(d_rot <= TRACE_ROT_DEG and d_t <= TRACE_T and d_cost <= TRACE_COST_REL,
          f"debug trace: traced and plain refinements part: {d_rot:.3f} deg, {d_t:.2e}, {d_cost:.2e}")


# ------------------------------------------------------------ phases 17-20 --
# The asset path (scripts_dev/build_mesh_bench_assets.py:110-211 through the
# port): the mesh world's capture, the hash-grid field trained at full width
# on it, a snapshot baked on load, distillation (floaters cleaned) and the
# fine-tune through the renderer, and the student rendered through K1 and K2.
# The recipe of build_mesh_bench_assets.py:125-127 (4096 rays, 48 + 16
# samples); the step counts are cut to fit the script's time (PERF.md has one
# full-budget run, scripts_dev/asset_build_full.py).
TRAIN_STEPS, TRAIN_LOG_EVERY = 1000, 100
DISTILL_STEPS, FINETUNE_STEPS = 1000, 500
# The JAX package's training of the same recipe on the same capture, on the
# CPU (scripts_dev/nerf_train_mesh_jax.py TRAIN_STEPS SEED): hold-out PSNR,
# full image and object region, dB, per seed. The card's hash field must
# reach the lower seed's less PSNR_SLACK_DB on both.
JAX_HOLDOUT_PSNR = {0: (23.927252133687336, 22.15692933400472), 1: (25.043501536051433, 23.287612279256184)}
PSNR_SLACK_DB = 1.0
ASSET_WORKDIR = REPO / "build" / "chip_smoke_assets"


def psnr(a, b, mask=None) -> float:
    """PSNR of two uint8 images, dB (over ``mask`` when given)."""
    se = (a.astype(np.float32) / 255.0 - b.astype(np.float32) / 255.0) ** 2
    return float(10.0 * np.log10(1.0 / max((se[mask] if mask is not None else se).mean(), 1e-10)))


def holdout_poses(mesh, n=6, seed=11):
    """Novel views off the mapping rig (build_mesh_bench_assets.py:51-68)."""
    from smoke_worlds import look_at_w2c

    V = mesh["vertices"]
    center = V.mean(axis=0)
    radius = np.linalg.norm(V - center, axis=1).max()
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        az, el = rng.uniform(0, 2 * np.pi), rng.uniform(-0.5, 0.9)
        d = np.array([np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)])
        poses.append(look_at_w2c(center + d * radius * 2.8, target=center))
    return poses


def holdout_psnr(tb, cap):
    """Mean hold-out PSNR (full image, object region) of the Testbed's render
    field: 448x448 at focal 1.2 x 448, one deterministic sample a pixel."""
    from pixtrack_tpu_torch.tracking.render_bridge import render_nerf_view

    views = [render_nerf_view(tb, cap.n2s, T, cap.hold_cam, spp=1, alpha_threshold=-1.0) for T in cap.hold]
    return (float(np.mean([psnr(v, g) for v, g in zip(views, cap.hold_gt)])),
            float(np.mean([psnr(v, g, m) for v, g, m in zip(views, cap.hold_gt, cap.hold_masks)])))


def phase_capture(device):
    """The mesh world's mapping rig: 42 icosphere views of house.obj at
    448x448, focal 450, rasterised by the port, their poses moved to NeRF
    space by nerf2sfm.pkl; the crop box from the augmented SfM points; the
    ray pool after the foreground-weighted cap; the hold-out views."""
    import types

    from pixtrack_tpu_torch.geometry import Camera, nerf_transform
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, look_at_rig_for_mesh, render_mesh
    from pixtrack_tpu_torch.mapping.nerf_dataset import estimate_aabb_from_scene
    from pixtrack_tpu_torch.nerf.dataset import NerfDataset
    from pixtrack_tpu_torch.nerf.train import TrainConfig, ray_pool
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    mw = REPO / "assets" / "mesh_world"
    mesh = load_obj(mw / "src" / "house.obj")
    n2s = nerf_transform.NerfTransform.load(mw / "nerf2sfm.pkl")
    cam = Camera.pinhole(450.0, 450.0, 223.5, 223.5, 448, 448)
    images, poses = [], []
    for T in look_at_rig_for_mesh(mesh["vertices"], subdiv=1):
        images.append(render_mesh(mesh, T, cam, background=(1.0, 1.0, 1.0)).astype(np.float32) / 255.0)
        poses.append(n2s.pose_sfm_to_nerf(T.inv().to_4x4().numpy().astype(np.float64)))
    ds = NerfDataset(images=np.stack(images), c2w=np.stack(poses).astype(np.float32), fx=450.0, fy=450.0,
                     cx=223.5, cy=223.5, width=448, height=448)
    aabb = estimate_aabb_from_scene(SceneModel.load(mw / "aug_sfm"), n2s)
    meta = json.loads((mw / "meta.json").read_text())
    cfg = TrainConfig()
    n_all = ds.n_images * ds.width * ds.height
    origins, _, rgbs = ray_pool(ds, cfg.ray_pool_cap, cfg.background, 0, device)
    n_fg = int(((rgbs - 1.0).abs().amax(dim=1) > 0.02).sum())
    log(f"[capture] {ds.n_images} views of {ds.width}x{ds.height}, focal {ds.fx}: {n_all} rays, pool after the "
        f"foreground-weighted cap {origins.shape[0]} ({n_fg} foreground); aabb from aug_sfm "
        f"{np.round(aabb, 4).tolist()}, meta.json's {np.round(meta['aabb'], 4).tolist()}")
    check(ds.n_images == 42 and origins.shape[0] == min(n_all, cfg.ray_pool_cap), "capture: wrong size")
    check(np.allclose(aabb, meta["aabb"], atol=0.02), "capture: the crop box is far from meta.json's")
    hold_cam = Camera.pinhole(1.2 * 448, 1.2 * 448, 223.5, 223.5, 448, 448)
    hold = holdout_poses(mesh)
    hold_gt = [render_mesh(mesh, T, hold_cam) for T in hold]
    return types.SimpleNamespace(mesh=mesh, n2s=n2s, ds=ds, aabb=aabb, hold=hold, hold_cam=hold_cam,
                                 hold_gt=hold_gt, hold_masks=[g.min(axis=-1) < 250 for g in hold_gt])


def _encoding_backward_span(out, x):
    """CUDA events bracketing the backward of one hash-encoding call: from
    the gradient reaching its output to the last node of its graph (the
    nodes between the output and the input ``x`` or the tables)."""
    import torch

    start, last = torch.cuda.Event(enable_timing=True), [None]

    def mark(*_):
        last[0] = torch.cuda.Event(enable_timing=True)
        last[0].record()

    out.register_hook(lambda g: start.record())
    seen, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen or node is x.grad_fn or type(node).__name__ == "AccumulateGrad":
            continue
        seen.add(node)
        node.register_hook(mark)
        todo.extend(n for n, _ in node.next_functions)
    return start, last


def train_step_split(device, cap, cfg, steps=4):
    """CUDA events over one training step at the recipe (a fresh field, after
    warm-up steps): the hash encoding's forward and backward, the MLPs'
    forward, the rest of the render's forward, the rest of the backward,
    the optimizer. Returns ms by part."""
    import torch

    from pixtrack_tpu_torch.nerf.field import init_field
    from pixtrack_tpu_torch.nerf.optim import Adam, exponential_decay
    from pixtrack_tpu_torch.nerf.train import batch_indices, make_loss_fn, ray_pool

    field = init_field(99, device=device)
    pool = ray_pool(cap.ds, cfg.ray_pool_cap, cfg.background, 0, device)
    loss_fn = make_loss_fn(field, cfg, cap.aabb)
    opt = Adam(field.parameters(), lambda k: exponential_decay(cfg.lr, cfg.n_steps, cfg.lr_final, k),
               b1=0.9, b2=0.99, eps=1e-15)
    gen = torch.Generator(device=device).manual_seed(99)
    spans, bwd, on = {"encoding": [], "density": [], "color": []}, [], [False]
    funcs = {"encoding": field.encoding.forward, "density": field.density_T, "color": field.color_T}

    def timed(name):
        def run(*args):
            if not on[0]:
                return funcs[name](*args)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = funcs[name](*args)
            b.record()
            spans[name].append((a, b))
            if name == "encoding":
                bwd.append(_encoding_backward_span(out, args[0]))
            return out
        return run

    field.encoding.forward, field.density_T, field.color_T = timed("encoding"), timed("density"), timed("color")
    for i in range(steps):
        on[0] = i == steps - 1
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        idx = batch_indices(gen, pool[0].shape[0], cfg.batch_rays)
        loss = loss_fn(pool[0][idx], pool[1][idx], pool[2][idx], gen)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
    torch.cuda.synchronize()

    def total(pairs):
        return sum(a.elapsed_time(b) for a, b in pairs)

    enc_f, enc_b = total(spans["encoding"]), sum(s.elapsed_time(e[0]) for s, e in bwd)
    mlp_f = total(spans["density"]) - enc_f + total(spans["color"])
    fwd, back, opt_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), ev[2].elapsed_time(ev[3])
    return {"step": ev[0].elapsed_time(ev[3]), "encoding forward": enc_f, "encoding backward": enc_b,
            "MLP forward": mlp_f, "render forward, rest": fwd - enc_f - mlp_f,
            "backward, rest (MLP and render)": back - enc_b, "optimizer": opt_ms}


def phase_train(device, cap):
    """The hash-grid field at full width (NGPField defaults: 16 levels, 2
    features, 2^19 tables) trained TRAIN_STEPS steps at the recipe; the loss
    history, steps/s, a CUDA-event split of one step and the hold-out PSNR
    against JAX's on the CPU (JAX_HOLDOUT_PSNR)."""
    import torch

    from pixtrack_tpu_torch.nerf.testbed import Testbed
    from pixtrack_tpu_torch.nerf.train import TrainConfig, train

    cfg = TrainConfig(n_steps=TRAIN_STEPS, batch_rays=4096, n_coarse=48, n_fine=16, log_every=TRAIN_LOG_EVERY)
    split = train_step_split(device, cap, cfg)
    log("[train] one step at the recipe (CUDA events, ms): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f"; the hash encoding {(split['encoding forward'] + split['encoding backward']) / split['step']:.3f} of "
        f"the step")
    torch.cuda.reset_peak_memory_stats()
    field, info = train(cap.ds, cap.aabb, cfg, seed=0, device=device)
    hist = info["history"]
    n_params = sum(p.numel() for p in field.parameters())
    tb = Testbed(device=device)
    tb.set_field(field)
    tb.render_aabb.min, tb.render_aabb.max = list(cap.aabb[0]), list(cap.aabb[1])
    full, obj = holdout_psnr(tb, cap)
    jax_full = min(v[0] for v in JAX_HOLDOUT_PSNR.values())
    jax_obj = min(v[1] for v in JAX_HOLDOUT_PSNR.values())
    log(f"[train] {TRAIN_STEPS} steps, {n_params} parameters, {cfg.batch_rays} rays x ({cfg.n_coarse} + "
        f"{cfg.n_fine}) samples: loss {[(k, round(v, 5)) for k, v in hist]}; {TRAIN_STEPS / info['seconds']:.2f} "
        f"steps/s ({info['seconds']:.1f} s), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[train] hold-out PSNR of the hash field: full {full:.2f} dB, object {obj:.2f} dB (JAX on the CPU, "
        f"seeds 0 / 1: {JAX_HOLDOUT_PSNR[0][0]:.2f} / {JAX_HOLDOUT_PSNR[1][0]:.2f}, object "
        f"{JAX_HOLDOUT_PSNR[0][1]:.2f} / {JAX_HOLDOUT_PSNR[1][1]:.2f}; gate the lower less {PSNR_SLACK_DB})")
    check(all(np.isfinite(v) for _, v in hist) and hist[-1][1] <= 0.5 * hist[0][1],
          f"train: the loss did not halve: {hist}")
    check(full >= jax_full - PSNR_SLACK_DB and obj >= jax_obj - PSNR_SLACK_DB,
          f"train: hold-out PSNR {full:.2f} / {obj:.2f} dB under JAX's {jax_full:.2f} / {jax_obj:.2f} less "
          f"{PSNR_SLACK_DB}")
    return field, (full, obj)


def phase_bake(device, cap, field, vertex_psnr):
    """A .npz snapshot of the trained field, loaded into a Testbed that
    bakes it: the vertex field read back exactly, the baked field equal to it
    on the dense levels to the last bit, one 224x224 view through both, and
    the baked field's hold-out PSNR beside the vertex field's
    (``vertex_psnr``, phase 18's). Returns the Testbed and that PSNR."""
    import torch

    from pixtrack_tpu_torch.nerf.snapshot import save_snapshot
    from pixtrack_tpu_torch.nerf.testbed import Testbed
    from pixtrack_tpu_torch.tracking.render_bridge import render_nerf_view
    from pixtrack_tpu_torch.geometry import Camera

    ASSET_WORKDIR.mkdir(parents=True, exist_ok=True)
    path = ASSET_WORKDIR / "weights.npz"
    save_snapshot(path, field, extra={"aabb": cap.aabb})
    tb = Testbed(device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb.load_snapshot(path)
    torch.cuda.synchronize()
    t_bake = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(tb.field.parameters(), field.parameters())),
          "bake: the snapshot did not read back the trained field")
    baked = tb._baked
    x = torch.rand(3, 1 << 18, generator=torch.Generator(device=device).manual_seed(5), device=device)
    with torch.no_grad():
        enc_v, enc_b = field.encoding(x), baked.encode_T(x)
    F = baked.f_per_level
    rows = torch.cat([torch.arange(l * F, (l + 1) * F) for l, d in enumerate(baked.dense) if d]).to(device)
    check(torch.equal(enc_v[rows], enc_b[rows]), "bake: a dense level differs from the vertex field")
    hashed = [l for l, d in enumerate(baked.dense) if not d]
    filled = [float((baked.tables[l] != 0).any(dim=0).float().mean()) for l in hashed]
    tv = Testbed(device=device)
    tv.set_field(field)
    cam = Camera.pinhole(225.0, 225.0, 111.5, 111.5, 224, 224)
    imgs = []
    for t in (tv, tb):
        t.render_aabb.min, t.render_aabb.max = list(cap.aabb[0]), list(cap.aabb[1])
        imgs.append(render_nerf_view(t, cap.n2s, cap.hold[0], cam, spp=1, alpha_threshold=-1.0).astype(np.float32))
    diff = np.abs(imgs[0] - imgs[1])
    full, obj = holdout_psnr(tb, cap)
    log(f"[bake] snapshot {path.stat().st_size / 2**20:.1f} MiB; load and bake {t_bake:.2f} s; "
        f"{sum(baked.dense)} dense levels equal to the vertex field bit for bit on {x.shape[1]} points; hashed "
        f"levels {hashed}: share of slots filled {[round(f, 3) for f in filled]}; 224x224 view, vertex vs baked "
        f"field: max {diff.max():.0f}, mean {diff.mean():.3f} of 255; hold-out PSNR, full / object (dB): the baked "
        f"field {full:.2f} / {obj:.2f}, the vertex field {vertex_psnr[0]:.2f} / {vertex_psnr[1]:.2f}")
    check(np.isfinite([full, obj]).all(), "bake: non-finite hold-out PSNR")
    return tb, (full, obj)


def phase_student(device, cap, tb, teacher_psnr, baked_psnr, gate=True):
    """Tighten the crop to the baked field, distill it (10 octaves, width
    128, depth 4, batch 2^15, 2^21 points; DISTILL_STEPS steps) and fine-tune
    the student on the capture (8192 rays x 64 samples, FINETUNE_STEPS
    steps), save and reload it. The student's renders through the Testbed
    are the counted path: the hold-out views (64 + 32 samples, K2) and a
    coarse 96-sample view (K1). Then K1 (224x224x96) and the staged render
    through K2 (64 + 32, 640x480) against their plain versions on the
    fine-tuned weights, and again after an in-place update of them; and the
    hold-out PSNRs of the student, the hash teacher and the shipped field.
    ``gate`` False reports a kernel that disagrees instead of failing."""
    import torch

    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf.distill import DistillConfig, load_distilled, save_distilled
    from pixtrack_tpu_torch.nerf.render import RenderConfig, rays_from_camera, render_rays
    from pixtrack_tpu_torch.nerf.testbed import Testbed
    from pixtrack_tpu_torch.tracking.render_bridge import render_nerf_view

    t0 = time.perf_counter()
    tb.tighten_render_bounds()
    tb.distill(config=DistillConfig(steps=DISTILL_STEPS, octaves=10), finetune_dataset=cap.ds,
               finetune_steps=FINETUNE_STEPS)
    torch.cuda.synchronize()
    t_distill = time.perf_counter() - t0
    path = ASSET_WORKDIR / "field.npz"
    save_distilled(path, tb._baked)
    student = load_distilled(path, device=device)
    check(all(torch.equal(a["kernel"], b["kernel"]) and torch.equal(a["bias"], b["bias"])
              for a, b in zip(student.layers(), tb._baked.layers())), "student: the saved field differs")
    tb.set_baked_field(student)

    fused_mlp.reset_launch_counts()
    full, obj = holdout_psnr(tb, cap)
    tb.n_coarse, tb.n_fine = 96, 0
    coarse = render_nerf_view(tb, cap.n2s, cap.hold[0], Camera.pinhole(225.0, 225.0, 111.5, 111.5, 224, 224),
                              spp=1, alpha_threshold=-1.0)
    tb.n_coarse, tb.n_fine = 64, 32
    launches = {k: fused_mlp.launch_count(k) for k in (fused_mlp.K1, fused_mlp.K2)}
    check(launches[fused_mlp.K1] > 0 and launches[fused_mlp.K2] > 0, f"student: launches {launches}")
    check(coarse.mean() < 254.0, "student: the coarse view is empty")

    box = (torch.as_tensor(np.asarray([tb.render_aabb.min, tb.render_aabb.max], np.float32), device=device),
           torch.as_tensor(tb._sphere, device=device))
    c2w = c2w_nerf(cap.hold[0], cap.n2s).to(device)
    rays = k1_rays(c2w, 225.0, (111.5, 111.5), 224, 224, *box)
    cfg = RenderConfig(n_coarse=64, n_fine=32)
    o, d = rays_from_camera(c2w, 600.0, 600.0, 319.5, 239.5, 640, 480)
    errs, failed = {}, []
    with torch.no_grad():
        for label in ("fine-tuned weights", "after an in-place update"):
            if label != "fine-tuned weights":  # the packed weights must follow the tensors
                for p in student.layers():
                    p["kernel"].mul_(1.01)
            out = fused_mlp.fused_march_render(student, *rays, 96, 1e-7)
            ref = fused_mlp.march_render_reference(student, *rays, 96, 1e-7)
            staged = render_rays(student, o, d, box[0], cfg, sphere=box[1])
            with k2_plain():
                staged_ref = render_rays(student, o, d, box[0], cfg, sphere=box[1])
            if label == "fine-tuned weights":  # both versions of each against the exact (f64) sums
                exact = fused_mlp.march_render_reference(ExactField(student), *rays, 96, 1e-7)
                staged_exact = render_rays(ExactField(student), o, d, box[0], cfg, sphere=box[1])
                to_exact = k1_errors(out, exact), k1_errors(ref, exact)
                staged_to_exact = k1_errors(staged, staged_exact), k1_errors(staged_ref, staged_exact)
            torch.cuda.synchronize()
            errs[label] = e1, e2 = k1_errors(out, ref), k1_errors(staged, staged_ref)
            for name, e, (ek, ep) in (("K1", e1, to_exact), ("the staged render through K2", e2, staged_to_exact)):
                # the share within K1_TOL of the plain version (a stale weight
                # pack after the in-place update misses it by far); on the
                # fine-tuned weights, the per-ray rule against the exact sums
                # in place of a bound on every ray (see EXACT_RATIO)
                ok = e["share"] >= K1_SHARE and (
                    label != "fine-tuned weights"
                    or 1.0 - ek["share"] <= EXACT_RATIO * (1.0 - ep["share"]) + EXACT_SLACK)
                if not ok:
                    failed.append(f"student, {label}: {name} disagrees with its plain version: {e}, against the "
                                  f"exact sums {ek} (plain {ep})")
    log(f"[student] tighten, distill ({DISTILL_STEPS} steps) and fine-tune ({FINETUNE_STEPS} steps): "
        f"{t_distill:.1f} s; launches through the Testbed: K1 {launches[fused_mlp.K1]}, K2 {launches[fused_mlp.K2]}; "
        + "; ".join(f"{label}: K1 224x224x96 alpha {a['alpha']:.3e} rgb {a['rgb']:.3e} ({a['share']:.6f} of the rays "
                    f"within {K1_TOL}), staged 640x480 (K2) alpha {b['alpha']:.3e} rgb {b['rgb']:.3e} "
                    f"({b['share']:.6f})" for label, (a, b) in errs.items())
        + "; against the exact sums, kernel / plain: " + "; ".join(
            f"{name} " + ", ".join(f"{k} {te[0][k]:.3e} / {te[1][k]:.3e}" for k in ("alpha", "rgb"))
            + f", share within {K1_TOL} {te[0]['share']:.6f} / {te[1]['share']:.6f}"
            for name, te in (("K1", to_exact), ("staged", staged_to_exact))))
    shipped = Testbed(device=device)
    shipped.set_baked_field(load_distilled(REPO / "assets" / "mesh_world" / "field.npz", device=device))
    meta = json.loads((REPO / "assets" / "mesh_world" / "meta.json").read_text())
    shipped.render_aabb.min, shipped.render_aabb.max = list(meta["aabb"][0]), list(meta["aabb"][1])
    shipped.tighten_render_bounds()
    s_full, s_obj = holdout_psnr(shipped, cap)
    log(f"[student] hold-out PSNR, full / object (dB): the card-built student {full:.2f} / {obj:.2f}, the hash "
        f"field's vertex field {teacher_psnr[0]:.2f} / {teacher_psnr[1]:.2f} and baked field {baked_psnr[0]:.2f} / "
        f"{baked_psnr[1]:.2f}, the shipped field.npz {s_full:.2f} / {s_obj:.2f}")
    check(np.isfinite([full, obj]).all(), "student: non-finite PSNR")
    if failed and not gate:
        log("[student] not gated here: " + "; ".join(failed))
    check(not (failed and gate), "; ".join(failed))
    k1_err, staged_err = (max(max(e[i]["alpha"], e[i]["rgb"]) for e in errs.values()) for i in (0, 1))
    return launches, k1_err, staged_err, rays, (full, obj)


def phase_assets(device, gate=True):
    """Phases 17-20, each timed; returns phase 20's launch counts, the
    student's largest K1 and staged-render errors against the plain versions,
    K1's 224x224 ray set (the student is saved in ASSET_WORKDIR, the snapshot
    beside it), the student's hold-out PSNR, phase 17's capture, and the
    hold-out PSNRs of the vertex field (phase 18) and the baked one (19)."""
    cap = timed_phase("phase 17, the capture", phase_capture, device)
    field, teacher_psnr = timed_phase("phase 18, NeRF training at full width", phase_train, device, cap)
    tb, baked_psnr = timed_phase("phase 19, snapshot and bake", phase_bake, device, cap, field, teacher_psnr)
    return timed_phase("phase 20, distil, fine-tune, render the student", phase_student, device, cap, tb,
                       teacher_psnr, baked_psnr, gate) + (cap, teacher_psnr, baked_psnr)


# ------------------------------------------------------------ phases 21-25 --
# The SfM model of the mesh world rebuilt on the card through the port's asset
# subcommands (pixtrack_tpu_torch.pipelines.cli, the obj pipeline of
# scripts_dev/build_mesh_bench_assets.py:87-140: make_house_obj, sfm-from-obj,
# train-nerf, then nerf-sfm and augment), and the mesh world tracked over it.
# The rig is the shipped one at full width: 42 views of 448 x 448, focal 450.
# Phase 22's reference is the JAX package's model of the same rig on the CPU
# (scripts_dev/sfm_from_obj_jax.py writes its points to SFM_JAX_POINTS: 1137
# points, mean reprojection error 0.614 px; the shipped TPU-built model is no
# exact reference: only 69.3 % of JAX's points lie within 1e-3 of one of its
# 1112). The card must come within SFM_COUNT_TOL of JAX's count and put
# SFM_NEAR_SHARE of its points within SFM_NEAR_TOL of JAX's, both ways; on the
# CPU the port's model equals JAX's to 1e-6 (all 1137 points).
SFM_JAX_POINTS = REPO / "scripts_dev" / "sfm_from_obj_jax.npz"
SFM_COUNT_TOL, SFM_NEAR_TOL, SFM_NEAR_SHARE = 0.03, 1e-4, 0.90
# Phase 24. The shipped aug_sfm's rolled poses were rolled on the TPU, whose
# default matmul precision runs f32 products through bf16 passes: the JAX
# package's own augmentation on the CPU lands up to 5.03e-4 (quaternion) and
# 2.04e-4 (translation) from them. So the rolled poses are held to the exact
# f64 roll of the rig's poses (both packages roll in f32: measured 1e-7 on the
# CPU) and to the shipped ones at AUG_SHIPPED_TOL; the 42 rig poses to the
# shipped ones at 1e-5.
AUG_EXACT_TOL, AUG_SHIPPED_TOL = 1e-6, 1e-3
# train-nerf before nerf-sfm, cut from the CLI's 10000 steps to fit the script
# (phase 18 measures training at 1000 steps): the recipe's 4096 rays x 48 + 16.
NERF_SFM_TRAIN_STEPS = 300
# nerf-sfm's renders at one sample a pixel, cut from the CLI's spp 2 for time
# (the spp 2 render took 45.70 s of phase 23's 71.5 s on an H100 80GB HBM3);
# phase 23's gate (points >= half of phase 22's) and its reference do not
# depend on it.
NERF_SFM_SPP = 1
# Phase 25: the JAX package's fused closed loop over ITS model of the same rig,
# augmented as the shipped build (scripts_dev/fused_mesh_rebuilt_jax_chains.py,
# CPU, UNet bf16, the six perturbed cold starts): chains 2, 2, 7, 7, 2, 7 of
# 20, each at a rotation median of 12.28 deg (its cold start costs 0.0760, so
# the success gate is 0.0836 where the shipped model's is 0.0905, and frames 3
# and 8 miss it); the open loop 20/20 at 1.37 deg. So JAX misses phase 7's
# closed-loop gates there and the card is held to JAX's own result, the
# variants' rule, chain by chain: both sets of chains ranked by successes, the
# card's i-th chain at the i-th JAX chain's successes less one and at its
# rotation median plus 0.5 deg; JAX passes phase 7's open-loop gate, and so
# must the card.
JAX_REBUILT_CHAINS = ((2, 12.28), (2, 12.28), (7, 12.28), (7, 12.28), (2, 12.28), (7, 12.28))  # successes, median
REBUILT_GATES = {"ranked": [(ok - 1, med + 0.5) for ok, med in sorted(JAX_REBUILT_CHAINS, key=lambda c: (-c[0], c[1]))],
                 "open_ok": MESH_MIN_OK, "open_med": MESH_MED_GATE_DEG}


@contextlib.contextmanager
def sfm_stage_split(split: dict, render: str):
    """Time the SfM stages' parts inside the block (host clock, synchronised):
    the adds go to ``split`` by part. ``render`` names the stage's renderer
    ("mesh" or "nerf"). Each part is timed by wrapping a function that its
    caller looks up through its module at call time; a part that no call
    reached fails the phase, so a wrapper that misses its caller cannot read 0."""
    import torch

    from pixtrack_tpu_torch.mapping import mesh_render
    from pixtrack_tpu_torch.nerf import testbed
    from pixtrack_tpu_torch.pipelines import assets
    from pixtrack_tpu_torch.sfm.scene import SceneModel
    from pixtrack_tpu_torch.tracking import render_bridge

    renders = {"mesh": [(mesh_render, "render_mesh", "render")],
               "nerf": [(render_bridge, "render_nerf_view", "render"),
                        (testbed, "initialize_testbed", "load + bake")]}[render]
    parts = renders + [(assets, "detect_and_describe", "detect + describe"),
                       (assets, "match_descriptors", "match + epipolar"), (assets, "epipolar_filter", "match + epipolar"),
                       (assets, "triangulate_scene", "tracks + triangulation"), (mesh_render, "write_png", "write"),
                       (SceneModel, "save", "write")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in parts]
    reached = set()

    def timed(fn, name, part):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[part] = split.get(part, 0.0) + time.perf_counter() - t0
            reached.add(name)
            return out
        return run

    for (obj, name, fn), (_, _, part) in zip(saved, parts):
        setattr(obj, name, timed(fn, name, part))
    try:
        yield split
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    missed = [name for _, name, _ in parts if name not in reached]
    check(not missed, f"SfM stage split: no call reached {missed}: a caller no longer looks them up at call time")


def nearest_shares(a, b, tols=(1e-3, 1e-4)):
    """The share of the points of ``a`` within each tolerance of a point of ``b``."""
    from scipy.spatial import cKDTree

    d = cKDTree(b).query(a)[0]
    return {t: float(np.mean(d <= t)) for t in tols}


def phase_house(work):
    """make_house_obj as the shipped build called it, written by the port."""
    from pixtrack_tpu_torch.mapping.mesh_render import read_png
    from pixtrack_tpu_torch.mapping.procedural import make_house_obj

    src = REPO / "assets" / "mesh_world" / "src"
    obj = make_house_obj(work / "src", seed=7, size=0.3, tile=96)
    same_obj = obj.read_text() == (src / "house.obj").read_text()
    same_tex = np.array_equal(read_png(work / "src" / "house_tex.png"), read_png(src / "house_tex.png"))
    log(f"[house] make_house_obj(seed=7, size=0.3, tile=96): house.obj equal to the shipped text {same_obj}, "
        f"atlas pixels equal {same_tex}")
    check(same_obj and same_tex, "house: the port's procedural house differs from the shipped one")
    return obj


def _shipped_pose_error(scene, shipped) -> float:
    """The largest difference of qvec / tvec between images of one name."""
    k = [shipped._imgidx[shipped.name2id[n]] for n in scene.names]
    return float(max(np.abs(scene.qvecs - shipped.qvecs[k]).max(), np.abs(scene.tvecs - shipped.tvecs[k]).max()))


def phase_sfm_from_obj(work, obj):
    """``sfm-from-obj`` on the shipped rig, through the CLI, on the card."""
    from pixtrack_tpu_torch.pipelines import assets, cli
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    split = {}
    t0 = time.perf_counter()
    with sfm_stage_split(split, "mesh"):
        cli.main(["sfm-from-obj", "--object_path", str(work), "--obj", str(obj), "--image_size", "448",
                  "--subdiv", "1"])
    wall = time.perf_counter() - t0
    scene = SceneModel.load(assets.layout(work)["ref_sfm"])
    shipped = SceneModel.load(REPO / "assets" / "mesh_world" / "aug_sfm")
    jax_xyz = np.load(SFM_JAX_POINTS)["xyz"]
    to_jax, from_jax = nearest_shares(scene.xyz, jax_xyz), nearest_shares(jax_xyz, scene.xyz)
    to_ship, from_ship = nearest_shares(scene.xyz, shipped.xyz), nearest_shares(shipped.xyz, scene.xyz)
    pose_err = _shipped_pose_error(scene, shipped)
    lengths = np.bincount(scene.track_lengths)
    log(f"[sfm-from-obj] {len(scene.image_ids)} views, {len(scene.point_ids)} points (JAX on the CPU "
        f"{len(jax_xyz)}, the shipped TPU model 1112) in {wall:.1f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in split.items())
        + f"; mean reprojection error {scene.point_errors.mean():.3f} px (JAX 0.614); track lengths "
        f"{ {int(n): int(c) for n, c in enumerate(lengths) if c} }; poses vs the shipped model's {pose_err:.2e}")
    log(f"[sfm-from-obj] points within 1e-3 / 1e-4 of JAX's model: {to_jax[1e-3]:.4f} / {to_jax[1e-4]:.4f}, JAX's "
        f"within them of the card's: {from_jax[1e-3]:.4f} / {from_jax[1e-4]:.4f}; against the shipped model (no "
        f"gate): {to_ship[1e-3]:.4f} / {to_ship[1e-4]:.4f}, the shipped within them of the card's: "
        f"{from_ship[1e-3]:.4f} / {from_ship[1e-4]:.4f}")
    check(len(scene.image_ids) == 42, "sfm-from-obj: not 42 views")
    check(pose_err <= 1e-5, f"sfm-from-obj: the rig's poses differ from the shipped model's by {pose_err:.2e}")
    check(abs(len(scene.point_ids) - len(jax_xyz)) <= SFM_COUNT_TOL * len(jax_xyz),
          f"sfm-from-obj: {len(scene.point_ids)} points against JAX's {len(jax_xyz)}")
    check(min(to_jax[SFM_NEAR_TOL], from_jax[SFM_NEAR_TOL]) >= SFM_NEAR_SHARE,
          f"sfm-from-obj: shares within {SFM_NEAR_TOL} of JAX's points {to_jax[SFM_NEAR_TOL]:.4f} / "
          f"{from_jax[SFM_NEAR_TOL]:.4f}")
    return scene


def phase_nerf_sfm(work, ref_points: int):
    """``train-nerf`` (cut) and ``nerf-sfm`` through the CLI: the views
    re-rendered from the baked hash field (no K1 or K2) and triangulated."""
    import importlib.util

    from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.pipelines import assets, cli
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    paths = assets.layout(work)
    fused_mlp.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["train-nerf", "--object_path", str(work), "--n_steps", str(NERF_SFM_TRAIN_STEPS), "--batch_rays",
              "4096", "--n_coarse", "48", "--n_fine", "16", "--save_every", "0"])
    t_train = time.perf_counter() - t0
    has_h5 = importlib.util.find_spec("h5py") is not None
    split = {}
    t0 = time.perf_counter()
    with sfm_stage_split(split, "nerf"):
        cli.main(["nerf-sfm", "--object_path", str(work), "--spp", str(NERF_SFM_SPP)]
                 + ([] if has_h5 else ["--no_h5"]))
    t_sfm = time.perf_counter() - t0
    launches = {k: fused_mlp.launch_count(k) for k in (fused_mlp.K1, fused_mlp.K2)}
    nerf = SceneModel.load(paths["nerf_sfm"])
    tf, shipped = NerfTransform.load(paths["nerf2sfm"]), NerfTransform.load(REPO / "assets" / "mesh_world" /
                                                                            "nerf2sfm.pkl")
    tf_err = max(float(np.abs(np.asarray(getattr(tf, f)) - np.asarray(getattr(shipped, f))).max())
                 for f in ("centroid", "avglen", "R", "totp", "up"))
    log(f"[nerf-sfm] train-nerf {NERF_SFM_TRAIN_STEPS} steps (cut from 10000; 4096 rays x 48 + 16) {t_train:.1f} s; "
        f"nerf-sfm (spp {NERF_SFM_SPP}, cut from the CLI's 2; h5 files "
        f"{'written' if has_h5 else 'off: this machine has no h5py'}) {t_sfm:.1f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in split.items())
        + f"; {len(nerf.image_ids)} views, {len(nerf.point_ids)} points (phase 22: {ref_points}), mean reprojection "
        f"error {nerf.point_errors.mean():.3f} px; nerf2sfm.pkl vs the shipped one {tf_err:.2e}; launches K1 "
        f"{launches[fused_mlp.K1]}, K2 {launches[fused_mlp.K2]}")
    check(paths["transforms"].exists() and paths["nerf2sfm"].exists(), "nerf-sfm: transforms.json or nerf2sfm.pkl missing")
    check(tf_err <= 1e-5, f"nerf-sfm: nerf2sfm.pkl differs from the shipped one by {tf_err:.2e}")
    check(launches == {fused_mlp.K1: 0, fused_mlp.K2: 0}, f"nerf-sfm: kernel launches {launches}")
    check(len(nerf.point_ids) >= ref_points / 2, f"nerf-sfm: {len(nerf.point_ids)} points")
    return launches


def rolled_poses_f64(scene, angles=tuple(range(30, 360, 30))):
    """{augmented name: (qvec, tvec)} of every original image of ``scene``
    rolled about its optical axis, in f64 numpy (scipy's quaternion, w >= 0):
    the exact reference of the augmentation's poses."""
    from scipy.spatial.transform import Rotation

    out = {}
    for k, name in enumerate(scene.names):
        R = Rotation.from_quat(np.roll(scene.qvecs[k], -1)).as_matrix()
        c2w_R, c2w_t = R.T, -R.T @ scene.tvecs[k]
        stem, _, ext = name.rpartition(".")
        for a in angles:
            c, s = np.cos(np.deg2rad(a)), np.sin(np.deg2rad(a))
            Rn = (c2w_R @ np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])).T
            q = np.roll(Rotation.from_matrix(Rn).as_quat(), 1)
            out[f"{stem}_rot{a:03d}.{ext}"] = (q if q[0] >= 0 else -q, -Rn @ c2w_t)
    return out


def phase_augment(work, ref):
    """``augment`` of phase 22's ref_sfm, as the shipped build augmented it
    (it never ran nerf-sfm): nerf_sfm is removed first, so that augment falls
    back to ref_sfm. The 42 rig poses must equal the shipped ones to 1e-5 and
    the 462 rolled ones the exact (f64) roll of them to AUG_EXACT_TOL; the
    shipped rolled poses were rolled on the TPU and are reported beside."""
    import pickle
    import shutil
    import sqlite3

    from pixtrack_tpu_torch.pipelines import assets, cli
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    paths = assets.layout(work)
    shutil.rmtree(paths["nerf_sfm"])
    t0 = time.perf_counter()
    cli.main(["augment", "--object_path", str(work)])
    wall = time.perf_counter() - t0
    aug = SceneModel.load(paths["aug_sfm"])
    shipped = SceneModel.load(REPO / "assets" / "mesh_world" / "aug_sfm")
    same_names = sorted(aug.names) == sorted(shipped.names)
    rolled = rolled_poses_f64(ref)
    exact_err = max(max(min(np.abs(aug.qvecs[aug._imgidx[aug.name2id[n]]] - sgn * q).max() for sgn in (1, -1)),
                        np.abs(aug.tvecs[aug._imgidx[aug.name2id[n]]] - t).max()) for n, (q, t) in rolled.items())
    orig = [n for n in aug.names if n not in rolled]
    rig_err = _shipped_pose_error(SceneModel(aug.cameras, {aug.name2id[n]: aug.images[aug.name2id[n]] for n in orig},
                                             {}), shipped)
    ship_err = _shipped_pose_error(aug, shipped) if same_names else float("inf")
    with contextlib.closing(sqlite3.connect(str(paths["aug_db"]))) as conn:
        n_db = conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]
    with open(paths["aug_sfm"] / "covis.pkl", "rb") as f:
        covis = pickle.load(f)
    log(f"[augment] {len(aug.image_ids)} images ({len(aug.point_ids)} points) in {wall:.1f} s; names equal to the "
        f"shipped aug_sfm's {same_names}; the {len(orig)} rig poses vs the shipped ones {rig_err:.2e}, the "
        f"{len(rolled)} rolled ones vs their exact (f64) roll {exact_err:.2e} and vs the shipped (rolled on the TPU) "
        f"{ship_err:.2e} (JAX on the CPU: 5.03e-04); database.db holds {n_db} images; covis.pkl {len(covis)} entries")
    check(len(aug.image_ids) == 504 and same_names, f"augment: {len(aug.image_ids)} images, names {same_names}")
    check(rig_err <= 1e-5 and exact_err <= AUG_EXACT_TOL, f"augment: poses {rig_err:.2e} / {exact_err:.2e}")
    check(ship_err <= AUG_SHIPPED_TOL, f"augment: rolled poses {ship_err:.2e} from the shipped ones")
    check(n_db == 504 and len(covis) == 504, f"augment: database {n_db} images, covis {len(covis)}")
    return paths["aug_sfm"]


# ------------------------------------------------------------ phases 26-29 --
# The SfM refinement stages (pixtrack_tpu_torch/mapping/{bundle,featuremetric,
# track_refine}.py) over phase 22's model on the card, then the mesh world
# tracked over the refined model. Their reference is the JAX package's
# outcome of the same stages over ITS model of the same rig, on the CPU
# (scripts_dev/refine_mesh_jax.py writes REFINE_JAX). "The truth" is the
# rig's poses: the posed-view model's own poses as built.
REFINE_JAX = REPO / "scripts_dev" / "refine_mesh_jax.npz"
# Phase 26's second run: every pose but camera 0's turned by PERTURB_DEG about
# a random axis and its centre moved by PERTURB_FRAC of the object's diameter,
# every point moved by PERTURB_FRAC of it, from numpy's default_rng(PERTURB_SEED)
# in the order perturb_scene draws; then PERTURB_ITERS BA iterations.
PERTURB_SEED, PERTURB_DEG, PERTURB_FRAC, PERTURB_ITERS = 0, 1.0, 0.01, 30
# Gates of phases 26-28, each against JAX's outcome of the same stage: each
# view's rotation error against the truth, median within JAX's + ROT_MED_SLACK
# and max within JAX's + ROT_MAX_SLACK (deg); the median reprojection error
# within REPROJ_REL of JAX's; REFINE_NEAR_SHARE of the refined points within
# REFINE_NEAR_FRAC of the diameter of a JAX point, both ways. BA leaves the
# scale about camera 0's centre free and f32 rounding drives it (the port and
# JAX on the CPU, one model: scales 1.0380 and 1.0339 from 1.0354, the shape
# equal to 7e-5), so points are compared with that gauge removed
# (gauge_free_points). The card's phase-22 model is not JAX's to the last
# point (phase 22's gate), so the stages start from models that differ.
# Readings (the card: NVIDIA H100 80GB HBM3, 700 W, a probe of PR 8 over its
# own phase-22 model; the port on the CPU over JAX's model), against JAX:
# bundle-adjust median/max 0.6692/1.8785 deg (JAX 0.6687/1.8810), the
# perturbed run 0.6578/1.9221 (0.6576/1.9209), photometric 0.5370/1.3638
# (0.5369/1.3634), reprojection medians within 0.1 %, points 99.9-100 %
# within 1e-3 of the diameter.
ROT_MED_SLACK, ROT_MAX_SLACK, REPROJ_REL = 0.05, 0.2, 0.05
REFINE_NEAR_FRAC, REFINE_NEAR_SHARE = 1e-3, 0.90
# Phase 27 (KA -> BA -> featuremetric BA) is held by its own two constants.
# KA's LM has no acceptance test and clips its steps at 1 px, so a few of its
# 3353 observations land by their last bits: the port against JAX on one
# model moves 11 keypoints by more than 0.01 px (7 by more than 0.1, up to
# 2.41 px), and the port against itself with the keypoints moved by 3e-5 px
# moves 15 (6, up to 1.66 px); the rest agree to 4e-4 px. The pose block and
# PA, fed one scene, agree to 5e-4 deg and 6e-8. Those few keypoints move
# single views through BA and the pose block: per-view rotation errors 0.57
# deg apart at most (median 0.023) between the packages on one model, and
# the points (shares within 1e-3 / 2e-3 / 5e-3 / 1e-2 of the diameter):
# 0.708 / 0.852 / 0.945 / 0.987 there, 0.814 / 0.912 / 0.974 / 0.990 on the
# card from its own model. Measured: rotation median 0.7718 deg on the card,
# 0.7408 in the port on the CPU, 0.7474 in JAX; max 3.0971, 2.9616, 2.9456.
FM_ROT_MAX_SLACK, FM_NEAR_FRAC = 0.6, 5e-3


def quat_rotmats(qvecs) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternions (P, 4) -> rotation matrices, f64."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat(np.roll(np.asarray(qvecs, np.float64), -1, axis=-1)).as_matrix()


def rotation_errors_deg(scene, truth) -> np.ndarray:
    """Each view's rotation error (deg) against the same-named view of
    ``truth``, in the order of ``truth.names``; the chord form, without
    arccos's floor near 0."""
    k = [scene._imgidx[scene.name2id[n]] for n in truth.names]
    d = np.linalg.norm(quat_rotmats(scene.qvecs[k]) - quat_rotmats(truth.qvecs), axis=(1, 2))
    return np.rad2deg(2.0 * np.arcsin(np.minimum(d / (2.0 * np.sqrt(2.0)), 1.0)))


def reprojection_errors(scene) -> np.ndarray:
    """The pixel error of every observation of every point (PINHOLE)."""
    cam = next(iter(scene.cameras.values()))
    f, c = np.asarray(cam.params[:2], np.float64), np.asarray(cam.params[2:4], np.float64)
    R = quat_rotmats(scene.qvecs)
    rows, X, uv = [], [], []
    for pid in scene.point_ids:
        p = scene.points3D[int(pid)]
        for iid, kidx in zip(p.image_ids, p.point2D_idxs):
            rows.append(scene._imgidx[int(iid)])
            X.append(p.xyz)
            uv.append(scene.images[int(iid)].xys[int(kidx)])
    rows = np.asarray(rows)
    pc = np.einsum("mij,mj->mi", R[rows], np.asarray(X, np.float64)) + scene.tvecs[rows]
    return np.linalg.norm(pc[:, :2] / pc[:, 2:] * f + c - np.asarray(uv, np.float64), axis=1)


def gauge_free_points(scene, truth) -> np.ndarray:
    """The points scaled about camera 0's centre (the first image id) so that
    the camera centres' mean distance from it is the truth's."""
    def centres(s):
        k = [s._imgidx[s.name2id[n]] for n in truth.names]
        return -np.einsum("pji,pj->pi", quat_rotmats(s.qvecs[k]), s.tvecs[k])

    c, c_ref = centres(scene), centres(truth)
    s = np.linalg.norm(c_ref - c_ref[0], axis=1).mean() / np.linalg.norm(c - c[0], axis=1).mean()
    return c[0] + (scene.xyz - c[0]) * s


def perturb_scene(scene, diameter: float, seed: int = PERTURB_SEED):
    """A copy of ``scene`` (either package's SceneModel) with every pose but
    the first image id's turned by PERTURB_DEG about a random axis and its
    centre moved by PERTURB_FRAC * diameter in a random direction, and every
    point moved by PERTURB_FRAC * diameter: numpy's default_rng(seed), drawn
    per image in id order (axis, then direction), then for the points."""
    import dataclasses

    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    images = dict(scene.images)
    for iid in sorted(scene.images)[1:]:
        im = scene.images[iid]
        turn = Rotation.from_rotvec(unit(1)[0] * np.deg2rad(PERTURB_DEG))
        R = Rotation.from_quat(np.roll(im.qvec, -1))
        centre = -R.as_matrix().T @ im.tvec + unit(1)[0] * PERTURB_FRAC * diameter
        R2 = turn * R
        q = np.roll(R2.as_quat(), 1)
        images[iid] = dataclasses.replace(im, qvec=q if q[0] >= 0 else -q, tvec=-R2.as_matrix() @ centre)
    moves = unit(len(scene.point_ids)) * PERTURB_FRAC * diameter
    points = {int(pid): dataclasses.replace(scene.points3D[int(pid)], xyz=scene.points3D[int(pid)].xyz + moves[k])
              for k, pid in enumerate(scene.point_ids)}
    return type(scene)(scene.cameras, images, points)


def refine_outcome(scene, truth) -> dict:
    """What phases 26-28 hold to JAX's: per-view rotation errors against the
    truth, the reprojection median, the points without BA's scale gauge."""
    return {"rot": rotation_errors_deg(scene, truth), "reproj_med": float(np.median(reprojection_errors(scene))),
            "xyz": gauge_free_points(scene, truth)}


def hold_to_jax(label: str, got: dict, ref: dict, diameter: float, max_slack: float = ROT_MAX_SLACK,
                near_frac: float = REFINE_NEAR_FRAC):
    """Print the stage's outcome beside JAX's and check it by the gates above."""
    tol = near_frac * diameter
    near = (nearest_shares(got["xyz"], ref["xyz"], (tol,))[tol], nearest_shares(ref["xyz"], got["xyz"], (tol,))[tol])
    log(f"[{label}] rotation error vs the truth, median/max {np.median(got['rot']):.4f}/{got['rot'].max():.4f} deg "
        f"(JAX on the CPU {np.median(ref['rot']):.4f}/{ref['rot'].max():.4f}); reprojection median "
        f"{got['reproj_med']:.4f} px (JAX {ref['reproj_med']:.4f}); points within {near_frac:g} of the diameter "
        f"of a JAX point, without the scale gauge: {near[0]:.4f}, JAX's of the card's {near[1]:.4f}")
    check(np.median(got["rot"]) <= np.median(ref["rot"]) + ROT_MED_SLACK,
          f"{label}: rotation median {np.median(got['rot']):.4f} deg, JAX {np.median(ref['rot']):.4f}")
    check(got["rot"].max() <= ref["rot"].max() + max_slack,
          f"{label}: rotation max {got['rot'].max():.4f} deg, JAX {ref['rot'].max():.4f}")
    check(abs(got["reproj_med"] - ref["reproj_med"]) <= REPROJ_REL * ref["reproj_med"],
          f"{label}: reprojection median {got['reproj_med']:.4f} px, JAX {ref['reproj_med']:.4f}")
    check(min(near) >= REFINE_NEAR_SHARE, f"{label}: points near JAX's {near[0]:.4f} / {near[1]:.4f}")


def jax_refine_reference() -> dict:
    """{stage: {rot, reproj_med, xyz}} and the JAX times from REFINE_JAX."""
    z = np.load(REFINE_JAX)
    stages = ("ba_cli", "ba_perturbed", "fm", "photometric")
    out = {k: {"rot": z[f"{k}_rot"], "reproj_med": float(z[f"{k}_reproj_med"]), "xyz": z[f"{k}_xyz"]} for k in stages}
    out["built"] = {"reproj_med": float(z["built_reproj_med"])}
    out["seconds"] = {k: float(z[f"{k}_seconds"]) for k in stages}
    out["photometric_moved"] = float(z["photometric_moved"])
    return out


class NestedTimer:
    """Exclusive host-clock times (synchronised) of wrapped functions: a
    wrapped call's time less the time of wrapped calls inside it."""

    def __init__(self):
        self.times, self.stack = {}, []

    def wrap(self, fn, part):
        import torch

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            self.stack.append(0.0)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            inner = self.stack.pop()
            self.times[part] = self.times.get(part, 0.0) + total - inner
            if self.stack:
                self.stack[-1] += total
            return out
        return run

    @contextlib.contextmanager
    def patched(self, parts):
        """``parts``: (object, attribute, part) triples, restored on exit; a
        part that no call reached fails the phase."""
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in parts]
        for (obj, name, fn), (_, _, part) in zip(saved, parts):
            setattr(obj, name, self.wrap(fn, part))
        try:
            yield self
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)
        missed = [part for _, _, part in parts if part not in self.times]
        check(not missed, f"stage split: no call reached {missed}")


class TimedExtractor:
    """The mapper's extractor behind a timer: the featuremetric stages call
    it and read its ``device``."""

    def __init__(self, extractor, timer: NestedTimer):
        self.extractor, self.device = extractor, extractor.device
        self.call = timer.wrap(extractor.__call__, "extraction")

    def __call__(self, image, image_scale: int = 1):
        return self.call(image, image_scale)


def rig_images(work, scene) -> dict:
    """{image_id: uint8 image} of phase 22's renders, read back from the mapping dir."""
    from pixtrack_tpu_torch.mapping.mesh_render import read_png
    from pixtrack_tpu_torch.pipelines import assets

    mapping = assets.layout(work)["mapping"]
    return {int(i): read_png(mapping / scene.images[int(i)].name) for i in scene.image_ids}


def phase_bundle_adjust(work, scene, ref, diameter):
    """``bundle-adjust`` through the CLI on phase 22's model as built, then
    ``bundle_adjust_scene`` on a perturbed copy; both on the card."""
    import torch

    from pixtrack_tpu_torch.mapping.bundle import bundle_adjust_scene
    from pixtrack_tpu_torch.pipelines import assets, cli
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    out = work / "ba_sfm"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["bundle-adjust", "--model", str(assets.layout(work)["ref_sfm"]), "--out", str(out)])
    wall = time.perf_counter() - t0
    ba = SceneModel.load(out)
    before = float(np.median(reprojection_errors(scene)))
    got = refine_outcome(ba, scene)
    log(f"[bundle-adjust] CLI, {len(ba.image_ids)} views, {len(ba.point_ids)} points, 20 iterations: {wall:.2f} s "
        f"(JAX on the CPU {ref['seconds']['ba_cli']:.2f} s); reprojection median {before:.4f} px as built (JAX "
        f"{ref['built']['reproj_med']:.4f}) -> {got['reproj_med']:.4f}; per-view rotation error vs the truth, deg: "
        f"{[round(float(r), 4) for r in got['rot']]}")
    hold_to_jax("bundle-adjust", got, ref["ba_cli"], diameter)

    pert = perturb_scene(scene, diameter)
    start = rotation_errors_deg(pert, scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = bundle_adjust_scene(pert, iters=PERTURB_ITERS)
    wall = time.perf_counter() - t0
    got = refine_outcome(rec, scene)
    log(f"[bundle-adjust] perturbed ({PERTURB_DEG} deg, {PERTURB_FRAC} of the diameter, seed {PERTURB_SEED}; rotation "
        f"error median {np.median(start):.4f} deg at the start), {PERTURB_ITERS} iterations: {wall:.2f} s (JAX on the "
        f"CPU {ref['seconds']['ba_perturbed']:.2f} s)")
    hold_to_jax("bundle-adjust, perturbed", got, ref["ba_perturbed"], diameter)


def phase_featuremetric(work, scene, images, ref, diameter):
    """KA over the model's tracks, BA, then featuremetric BA (2 rounds), the
    mapper's polish order and extractor; the wall time split by part."""
    from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
    from pixtrack_tpu_torch.mapping import bundle, featuremetric
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    timer = NestedTimer()
    ex = TimedExtractor(FeatureExtractor(HandcraftedExtractor(), resize=1024), timer)
    t0 = time.perf_counter()
    with timer.patched([(featuremetric, "refine_scene_keypoints", "KA"), (bundle, "bundle_adjust_scene", "BA"),
                        (featuremetric, "featuremetric_ba", "pose block"),
                        (featuremetric, "point_adjustment", "point block")]):
        s = featuremetric.refine_scene_keypoints(scene, images, ex)
        s = bundle.bundle_adjust_scene(s)
        s = featuremetric.featuremetric_ba(s, images, ex, rounds=2)
    wall = time.perf_counter() - t0
    moved = float(np.mean(np.concatenate([np.abs(s.images[i].xys - scene.images[i].xys).max(axis=1) > 1e-6
                                          for i in scene.images])))
    log(f"[featuremetric] KA -> BA -> featuremetric BA (2 rounds), handcrafted extractor: {wall:.2f} s (JAX on the "
        f"CPU {ref['seconds']['fm']:.2f} s): " + ", ".join(f"{k} {v:.2f} s" for k, v in timer.times.items())
        + f"; keypoints moved by KA {moved:.4f}")
    hold_to_jax("featuremetric", refine_outcome(s, scene), ref["fm"], diameter, FM_ROT_MAX_SLACK, FM_NEAR_FRAC)
    out = work / "refined_sfm"
    out.mkdir(parents=True, exist_ok=True)
    s.save(out)
    return out, timer.times


def phase_photometric(scene, images, ref, diameter):
    """Photometric track refinement, then BA; the share of observations it
    moved beside JAX's."""
    import torch

    from pixtrack_tpu_torch.mapping.bundle import bundle_adjust_scene
    from pixtrack_tpu_torch.mapping.track_refine import refine_tracks_photometric

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = refine_tracks_photometric(scene, images)
    t_refine = time.perf_counter() - t0
    moved = s._track_refine_applied / int(scene.track_lengths.sum())
    s = bundle_adjust_scene(s)
    wall = time.perf_counter() - t0
    log(f"[photometric] refine_tracks_photometric {t_refine:.2f} s, then BA: {wall:.2f} s in all (JAX on the CPU "
        f"{ref['seconds']['photometric']:.2f} s); observations moved {moved:.4f} (JAX {ref['photometric_moved']:.4f})")
    hold_to_jax("photometric", refine_outcome(s, scene), ref["photometric"], diameter)


def phase_rebuild(device, work: Path):
    """Phases 21-33, each timed, in the work directory ``work`` (the object
    folder of phases 21-24; phase 38 tracks it); returns phase 23's K1 / K2
    launches, phase 25's results and K1 launches, and the results of phases
    26-29 and 30-33."""
    from pixtrack_tpu_torch.nerf import fused_mlp

    obj = timed_phase("phase 21, the procedural house", phase_house, work)
    scene = timed_phase("phase 22, sfm-from-obj", phase_sfm_from_obj, work, obj)
    nerf_sfm_launches = timed_phase("phase 23, train-nerf and nerf-sfm", phase_nerf_sfm, work,
                                    len(scene.point_ids))
    aug_sfm = timed_phase("phase 24, augment", phase_augment, work, scene)
    fused_mlp.reset_launch_counts()
    _, _, mesh, _ = timed_phase("phase 25, the mesh world over the card-built model", phase_mesh, device,
                                aug_sfm=aug_sfm, gates=REBUILT_GATES, label="rebuilt")
    launches = fused_mlp.launch_count(fused_mlp.K1)
    log(f"[rebuilt] closed loop over the card-built model: chains {mesh['chains']} (JAX on its own model "
        f"{[ok for ok, _ in JAX_REBUILT_CHAINS]}; phase 7 on the shipped model above), open loop "
        f"{mesh['open']}/20 (JAX 20/20)")
    refined = phase_refine(device, work, scene)
    unposed = phase_unposed(device, work)
    return nerf_sfm_launches, mesh, launches, refined, unposed


def phase_refine(device, work, scene):
    """Phases 26-29 over phase 22's model; returns phase 27's time split and
    phase 29's open loop and K1 launches."""
    from pixtrack_tpu_torch.nerf import fused_mlp

    ref = jax_refine_reference()
    diameter = float(json.loads((REPO / "assets" / "mesh_world" / "meta.json").read_text())["diameter"])
    images = rig_images(work, scene)
    timed_phase("phase 26, bundle adjustment", phase_bundle_adjust, work, scene, ref, diameter)
    refined, split = timed_phase("phase 27, featuremetric refinement", phase_featuremetric, work, scene, images, ref,
                                 diameter)
    timed_phase("phase 28, photometric track refinement", phase_photometric, scene, images, ref, diameter)
    fused_mlp.reset_launch_counts()
    _, _, opened, _ = timed_phase("phase 29, the mesh world's open loop over the refined model", phase_mesh, device,
                                  aug_sfm=refined, label="refined", open_only=True)
    return {"split": split, "open": opened["open"], "k1": fused_mlp.launch_count(fused_mlp.K1)}


# ------------------------------------------------------------ phases 30-33 --
# Unposed reconstruction (pixtrack_tpu_torch/mapping/incremental.py and
# global_init.py) on the card. Phase 30 is the JAX package's headline mapper
# rig (tests/test_incremental_sfm.py::test_arc_10view_ka_subdegree): ARC_VIEWS
# views of a textured cube over a 17-degree-step arc at ARC_RES px with the
# rig's PINHOLE camera (f = 1.1 * ARC_RES), reconstructed at the
# ``reconstruct`` defaults. Phase 32 is a ring capture of the house
# reconstructed without its poses. Their references are the JAX package's
# outcomes of the same runs on the CPU (scripts_dev/reconstruct_jax.py).
ARC_VIEWS, ARC_RES, ARC_STEP_DEG = 10, 192, 17.0
RECONSTRUCT_JAX = REPO / "scripts_dev" / "reconstruct_jax.npz"
# The mapper's outcome on this rig turns with its RANSAC draws (`seed`). Over
# seeds 0-7 (scripts_dev/reconstruct_card_seeds.py --seeds 8 --cpu; H100 80GB
# HBM3, 700 W) the JAX test's gates (below) held for 3 of 8 seeds on the card
# and 4 of 8 for the port on the CPU; JAX on the CPU holds them for 2 of its
# seeds 0-2 (seed 2: reprojection 0.361 px). Medians over the 8 seeds, card /
# CPU: global rotation 0.889 / 0.851 deg, centres 0.075 / 0.048 of the radius,
# reprojection 0.340 / 0.340 px. The card's seed 0 misses the reprojection
# gate (0.429 px; the CPU's seed 0: 0.338). So phase 30 runs ARC_SEEDS seeds
# and holds the median outcome to the gates, as phase 7 never judges one chain.
ARC_SEEDS = 8
# Worker processes for the mapper runs of phases 30-31 beyond the traced
# ones (the card's machine has 8 cores).
MAPPER_WORKERS = 4
# The margin over JAX's global rotation median (phases 30-31): the larger of
# the spread (max - min) of JAX's median over seeds 0-2 on the arc rig (CPU:
# 0.829, 0.867, 0.878 deg: 0.049) and that of the port's over seeds 0-2 on
# the card (0.745, 0.693, 0.928 deg: 0.235).
ARC_MARGIN_DEG = 0.235
# Phase 31, what ``reconstruct`` runs (its inferred f = 230.4 against the
# rig's 211.2, 1024 keypoints) turns with the seed too: JAX on the CPU at
# seeds 0-6 (reconstruct_jax.py cli SEED) 1.569, 1.513, 1.803, 1.267, 2.559,
# 1.934, 2.221 deg (median 1.803); the port on the card at seeds 0-2
# (reconstruct_card_seeds.py --cli 3) 2.275, 1.757, 2.219, and on the CPU at
# seeds 0-11 a median of 2.127 (reconstruct_card_seeds.py --device cpu --cli
# 12). On equal draws the two packages part by up to 0.8 deg here
# (scripts_dev/repeat_rule.py replay). So the phase runs the CLI (seed 0) and its
# mapper at seeds 1-6 and holds the median to JAX's median over seeds 0-6 plus
# the margin, the larger spread over seeds 0-2: JAX 0.290, the card 0.518.
CLI_SEEDS, CLI_MARGIN_DEG = 7, 0.518
# Phase 30's RANSAC calls run again on the CPU on the same draws: the share of
# correspondences whose inlier flag agrees with the card's.
RANSAC_AGREE_SHARE = 0.99
# Phase 32: a user's capture of the house, RING_VIEWS renders at RING_RES px
# (the mapping rig's camera, f = RING_FOCAL, white background) on a ring about
# its centroid at the rig's distance (RING_MARGIN times the mesh's radius) and
# the mesh world's orbit elevation (RING_ELEV rad), 10 degrees apart. (Phase
# 22's 42 icosphere views are reconstructed by neither package: the chain
# initialisation assumes an ordered capture, the icosphere is not one, and the
# global averaging's coverage rule then keeps the chain; JAX on the CPU at
# seeds 0-2: global rotation medians 68.9 / 36.8 / 83.1 deg.)
RING_VIEWS, RING_RES, RING_FOCAL, RING_ELEV, RING_MARGIN = 36, 448, 450.0, 0.35, 2.8
# The reference: JAX on the CPU at seeds 0-2 (reconstruct_jax.py ring SEED)
# registers 36 / 36 / 36 views with 581 / 584 / 578 points at global rotation
# medians 0.992 / 1.776 / 1.409 deg; its global averaging covers 29 / 27 / 19
# of the 36 views and falls back to the chain. Phase 32 runs seed 0 and is
# held to JAX's median: registered at least JAX's less one, points within
# RING_POINTS_TOL, and the global median within RING_MARGIN_DEG, the larger
# seed spread (max - min) of JAX's seeds 0-2 (0.784 deg) and of the port's on
# the card at seeds 1-3, seed 0 left out as the run judged
# (reconstruct_card_seeds.py --ring 0 1 2 3; H100 80GB HBM3, 700 W: 1.087,
# 0.878, 0.547 deg, 0.540; 623, 625, 596 points).
RING_POINTS_TOL, RING_MARGIN_DEG = 0.15, 0.784


def arc_rig_poses(n_views: int = ARC_VIEWS, step_deg: float = ARC_STEP_DEG):
    """{image id: (R, t)} of the arc rig, world-to-camera, f32 as the look-at
    poses of both packages; ids from 1."""
    out = {}
    for i in range(n_views):
        ang = np.deg2rad(step_deg) * i
        c = 0.9 * np.array([np.sin(ang), 0.4 + 0.1 * np.sin(2 * ang), np.cos(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross(z, [0.0, 1.0, 0.0])
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], axis=0).astype(np.float32)
        out[i + 1] = (R, (-R @ c).astype(np.float32))
    return out


def ring_rig_poses(vertices: np.ndarray, n_views: int = RING_VIEWS):
    """{image id: (R, t)} of phase 32's ring, world-to-camera, f32 look-at
    poses (y up) about the mesh's centroid; ids from 1."""
    center = vertices.astype(np.float64).mean(axis=0)
    dist = np.linalg.norm(vertices - center, axis=1).max() * RING_MARGIN
    out = {}
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = center + dist * np.array([np.cos(RING_ELEV) * np.sin(ang), np.sin(RING_ELEV),
                                        np.cos(RING_ELEV) * np.cos(ang)])
        z = (center - eye) / np.linalg.norm(center - eye)
        x = np.cross(z, [0.0, 1.0, 0.0])
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], axis=0).astype(np.float32)
        out[i + 1] = (R, (-R @ eye).astype(np.float32))
    return out


def _rot_deg(A, B) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(A @ B.T) - 1) / 2, -1.0, 1.0))))


def rig_outcome(scene, truth: dict) -> dict:
    """The numbers of tests/test_incremental_sfm.py::_check_rig_reconstruction
    for either package's SceneModel against ``truth`` ({image name: (R, t)}):
    registered views, points, the median rotation error of consecutive
    registered views' relative rotations, the gauge-free global rotation
    median, the median camera-centre error after a similarity alignment as a
    fraction of the rig's mean radius, and the mean reprojection error."""
    ids = sorted(int(i) for i in scene.image_ids)
    names = [scene.images[i].name for i in ids]
    R = quat_rotmats(np.stack([scene.images[i].qvec for i in ids]))
    t = np.stack([scene.images[i].tvec for i in ids]).astype(np.float64)
    Rg = np.stack([np.asarray(truth[n][0], np.float64) for n in names])
    tg = np.stack([np.asarray(truth[n][1], np.float64) for n in names])
    pair = [_rot_deg(R[a + 1] @ R[a].T, Rg[a + 1] @ Rg[a].T) for a in range(len(ids) - 1)]
    D = np.einsum("pji,pjk->pik", Rg, R)
    ref = min(range(len(ids)), key=lambda i: np.median([_rot_deg(D[i], D[j]) for j in range(len(ids))]))
    glob = [_rot_deg(D[i], D[ref]) for i in range(len(ids))]
    c = -np.einsum("pji,pj->pi", R, t)
    cg = -np.einsum("pji,pj->pi", Rg, tg)
    E0, G0 = c - c.mean(0), cg - cg.mean(0)
    U, S, Vt = np.linalg.svd(G0.T @ E0)
    Dm = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    sc = np.trace(np.diag(S) @ Dm) / (E0 ** 2).sum()
    cerr = np.linalg.norm(sc * E0 @ (U @ Dm @ Vt).T - G0, axis=1)
    return {"registered": len(ids), "points": len(scene.point_ids),
            "pairwise_deg": float(np.median(pair)) if pair else float("nan"),
            "global_deg": float(np.median(glob)), "centre_frac": float(np.median(cerr) / np.linalg.norm(G0, axis=1).mean()),
            "reproj_px": float(np.mean(scene.point_errors)) if len(scene.point_ids) else float("nan"),
            "names": names}


def jax_reconstruct_reference() -> dict:
    """{run: outcome} of scripts_dev/reconstruct_jax.py: arc0-arc2 (the arc
    rig at seeds 0-2), cli (``reconstruct`` over its images) and cli1-cli6
    (what it runs, at seeds 1-6), ring0-ring2 (phase 32's ring at seeds
    0-2), each with its seconds; and the seed-0 ring model's COLMAP files."""
    z = np.load(RECONSTRUCT_JAX)
    keys = ("registered", "points", "pairwise_deg", "global_deg", "centre_frac", "reproj_px", "seconds")
    runs = ("arc0", "arc1", "arc2", "cli") + tuple(f"cli{k}" for k in range(1, CLI_SEEDS)) + \
        tuple(f"ring{k}" for k in range(3))
    out = {run: {k: float(z[f"{run}_{k}"]) for k in keys} for run in runs}
    out["ring_model"] = {f: z[f"ring_model_{f}"].tobytes() for f in ("cameras", "images", "points3D")}
    return out


def arc_rig(work: Path):
    """The arc rig rendered by the port: ({id: image}, {name: (R, t)}, the
    PINHOLE record)."""
    from pixtrack_tpu_torch.geometry import Camera, Pose
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
    from pixtrack_tpu_torch.sfm import colmap_io
    from smoke_worlds import make_cube_obj

    res = ARC_RES
    mesh = load_obj(make_cube_obj(work))
    camera = Camera.pinhole(res * 1.1, res * 1.1, (res - 1) / 2, (res - 1) / 2, res, res)
    views, truth = {}, {}
    for iid, (R, t) in arc_rig_poses().items():
        views[iid] = render_mesh(mesh, Pose.from_Rt(R, t), camera)
        truth[f"view_{iid:04d}.png"] = (R, t)
    return views, truth, colmap_io.CameraRecord(1, "PINHOLE", res, res, np.array([res * 1.1, res * 1.1, res / 2.0,
                                                                                    res / 2.0]))


def mapper_parts():
    """The mapper's stages for NestedTimer, each a function its caller looks
    up at call time; what no part covers is registration, BA and culling."""
    from pixtrack_tpu_torch.mapping import detector, featuremetric, global_init, incremental, triangulate

    return [(detector, "detect_and_describe", "detect + describe"), (incremental, "_verify_pairs", "match + verify"),
            (featuremetric, "keypoint_adjustment", "KA"), (incremental, "_chain_initialize", "init"),
            (global_init, "global_initialize", "init"), (triangulate, "triangulate_scene", "final assembly"),
            (featuremetric, "featuremetric_ba", "featuremetric BA")]


@contextlib.contextmanager
def recorded_ransacs(calls: list):
    """Record every RANSAC call of the mapper inside the block: (kind, the
    two point sets, the threshold, the hypothesis indices it drew, the
    inlier mask it returned), all moved to the CPU."""
    from pixtrack_tpu_torch.mapping import incremental

    saved = {n: getattr(incremental, n) for n in ("_draw_indices", "_essential_ransac", "_homography_ransac",
                                                    "_pnp_ransac")}
    drawn = []

    def draw(*args, **kwargs):
        idx = saved["_draw_indices"](*args, **kwargs)
        drawn.append(idx.cpu())
        return idx

    def recorder(kind, name):
        def run(a, b, generator, thresh=None, **kw):
            kw = dict(kw, **({} if thresh is None else {"thresh": thresh}))
            out = saved[name](a, b, generator, **kw)
            calls.append({"kind": kind, "a": a.cpu(), "b": b.cpu(), "kw": kw, "idx": drawn[-1], "inl": out[1].cpu()})
            return out
        return run

    incremental._draw_indices = draw
    for kind, name in (("E", "_essential_ransac"), ("H", "_homography_ransac"), ("P", "_pnp_ransac")):
        setattr(incremental, name, recorder(kind, name))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(incremental, n, fn)


def ransac_choice(call: dict, device) -> int:
    """The hypothesis a recorded RANSAC call chooses on ``device``."""
    import torch

    from pixtrack_tpu_torch._device import true_f32
    from pixtrack_tpu_torch.mapping import incremental as inc

    a, b, idx = call["a"].to(device), call["b"].to(device), call["idx"].to(device)
    defaults = {"E": 1e-5, "H": 1e-5, "P": 2e-3}
    thresh = call["kw"].get("thresh", defaults[call["kind"]])
    with true_f32(), torch.no_grad():
        if call["kind"] == "E":
            inl = inc._sampson(inc._eight_point(a[idx], b[idx]), a, b) < thresh
        elif call["kind"] == "H":
            inl = inc._h_transfer(inc._four_point_h(a[idx], b[idx]), a, b) < thresh
        else:
            inl = inc._score_P(inc._dlt_pnp(a[idx], b[idx]), a, b[None], thresh)
        return int(inc._best(inl.sum(dim=1), inc._repeats(a[idx], b[idx])))


def ransacs_card_vs_cpu(calls: list) -> dict:
    """Each recorded call of the card run again on the CPU on its own draws:
    the share of correspondences whose inlier flag agrees, and the share of
    calls whose chosen hypothesis differs, by kind and in all."""
    import torch

    from pixtrack_tpu_torch.mapping import incremental as inc

    cpu, card = torch.device("cpu"), torch.device("cuda")
    fns = {"E": inc._essential_ransac, "H": inc._homography_ransac, "P": inc._pnp_ransac}
    saved = inc._draw_indices
    stats = {}
    try:
        for c in calls:
            inc._draw_indices = lambda *args, _idx=c["idx"], **kw: _idx
            _, inl_cpu, _ = fns[c["kind"]](c["a"], c["b"], None, **c["kw"])
            st = stats.setdefault(c["kind"], {"calls": 0, "entries": 0, "agree": 0, "other_choice": 0})
            st["calls"] += 1
            st["entries"] += int(inl_cpu.numel())
            st["agree"] += int((inl_cpu == c["inl"]).sum())
            st["other_choice"] += int(ransac_choice(c, card) != ransac_choice(c, cpu))
    finally:
        inc._draw_indices = saved
    total = {k: sum(st[k] for st in stats.values()) for k in ("calls", "entries", "agree", "other_choice")}
    return {"by_kind": stats, "agree_share": total["agree"] / max(total["entries"], 1),
            "other_choice_share": total["other_choice"] / max(total["calls"], 1), "calls": total["calls"]}


def run_mapper(images, cam_rec, label: str, names=None, detector=None, match_kw=None, **kw):
    """``incremental_sfm`` on the card at the ``reconstruct`` settings (KA,
    two featuremetric BA rounds, min_score 0.5, ratio 0.98 unless
    ``match_kw`` says otherwise), ``detector`` (Harris + patches when None)
    and ``kw``, timed by stage; returns (model, wall seconds, {stage:
    seconds})."""
    import torch

    from pixtrack_tpu_torch.mapping.incremental import incremental_sfm

    timer = NestedTimer()
    parts = mapper_parts()
    if detector is not None:  # a learned detector takes detect_and_describe's place and its part
        parts = [p for p in parts if p[2] != "detect + describe"]
        detector = timer.wrap(detector, "detect + describe")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer.patched(parts):
        rec = incremental_sfm(images, cam_rec, names=names, match_kw=match_kw or dict(min_score=0.5, ratio=0.98),
                              featuremetric_ka=True, featuremetric_ba_rounds=2, detector=detector, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = dict(timer.times)
    split["registration + BA + cull"] = wall - sum(split.values())
    log(f"[{label}] incremental_sfm {wall:.1f} s: " + ", ".join(f"{k} {v:.2f} s" for k, v in split.items()))
    return rec, wall, split


def mapper_job(images, cam_rec, truth: dict, label: str, kw: dict):
    """One ``run_mapper`` in a worker process: (its outcome on the rig, its
    split by stage)."""
    rec, wall, split = run_mapper(images, cam_rec, label, **kw)
    return dict(rig_outcome(rec, truth), seconds=wall), split


def _worker_init():
    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def worker_pool(n_workers: int):
    """Worker processes (spawned, one CPU thread each) for host-bound runs
    whose outcome does not depend on the process: phases 30-31's mapper
    seeds and phase 36's three benchmarks run side by side (the wall times
    they print are then those of runs that share the host). Shut down, and
    the workers gone, on leaving."""
    import concurrent.futures
    import multiprocessing
    import os

    keys = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})  # read by the workers' libraries as they start
    try:
        with concurrent.futures.ProcessPoolExecutor(n_workers, mp_context=multiprocessing.get_context("spawn"),
                                                    initializer=_worker_init) as pool:
            try:
                yield pool
            except BaseException:
                pool.shutdown(wait=True, cancel_futures=True)
                raise
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def report_outcome(label: str, out: dict, ref: dict, wall: float):
    log(f"[{label}] registered {out['registered']:g}, points {out['points']:g} (JAX on the CPU {int(ref['registered'])}, "
        f"{int(ref['points'])}); rotation error of consecutive views' relative rotations, median "
        f"{out['pairwise_deg']:.3f} deg (JAX {ref['pairwise_deg']:.3f}); global rotation median {out['global_deg']:.3f} "
        f"deg (JAX {ref['global_deg']:.3f}); centre error median {out['centre_frac']:.4f} of the rig's radius (JAX "
        f"{ref['centre_frac']:.4f}); mean reprojection {out['reproj_px']:.3f} px (JAX {ref['reproj_px']:.3f}); "
        f"{wall:.1f} s (JAX on the CPU {ref['seconds']:.1f} s)")


def outcome_median(outs: list) -> dict:
    """Each number of ``rig_outcome`` as its median over several runs."""
    keys = ("registered", "points", "pairwise_deg", "global_deg", "centre_frac", "reproj_px", "seconds")
    return {k: float(np.median([o[k] for o in outs])) for k in keys if k in outs[0]}


def phase_arc(views: dict, truth: dict, cam_rec, ref: dict, jobs: list):
    """Phase 30: the arc rig through ``incremental_sfm`` on the card at seeds
    0..ARC_SEEDS-1 (seed 0 here, its RANSACs recorded; the others in the
    mapper workers, ``jobs``), the median outcome held to its JAX test's
    gates and to JAX's median over seeds 0-2; seed 0's RANSACs again on the
    CPU."""
    calls = []
    with recorded_ransacs(calls):
        rec, wall, split = run_mapper(views, cam_rec, "arc, seed 0", max_keypoints=768, nms_radius=1, seed=0)
    t0 = time.perf_counter()
    cmp = ransacs_card_vs_cpu(calls)
    cmp_seconds = time.perf_counter() - t0
    outs, splits = [], []
    for seed, (out, sp) in enumerate([(dict(rig_outcome(rec, truth), seconds=wall), split)]
                                     + [job.result() for job in jobs]):
        outs.append(out)
        splits.append(sp)
        log(f"[arc, seed {seed}] registered {out['registered']}, points {out['points']}, pairwise "
            f"{out['pairwise_deg']:.3f} deg, global {out['global_deg']:.3f} deg, centres {out['centre_frac']:.4f}, "
            f"reprojection {out['reproj_px']:.3f} px")
    med = outcome_median(outs)
    jax_med = outcome_median([ref[f"arc{k}"] for k in range(3)])
    report_outcome(f"arc, median over seeds 0-{ARC_SEEDS - 1} (JAX: 0-2)", med, jax_med, med["seconds"])
    log(f"[arc] seed 0's {cmp['calls']} RANSAC calls again on the CPU on their draws ({cmp_seconds:.1f} s): "
        f"inlier flags agree on {cmp['agree_share']:.5f} of the correspondences, the chosen hypothesis differs in "
        f"{cmp['other_choice_share']:.4f} of the calls; by kind " + json.dumps(cmp["by_kind"]))
    check(med["registered"] >= 9 and med["points"] > 150, f"arc: {med['registered']} registered, {med['points']} points")
    check(med["pairwise_deg"] < 3.0 and med["global_deg"] < 1.1, f"arc: rotations {med['pairwise_deg']:.3f} / "
          f"{med['global_deg']:.3f} deg")
    check(med["centre_frac"] < 0.08 and med["reproj_px"] < 0.35, f"arc: centres {med['centre_frac']:.4f}, reprojection "
          f"{med['reproj_px']:.3f} px")
    check(med["global_deg"] <= jax_med["global_deg"] + ARC_MARGIN_DEG,
          f"arc: global rotation {med['global_deg']:.3f} deg over JAX's {jax_med['global_deg']:.3f} + {ARC_MARGIN_DEG}")
    check(cmp["agree_share"] >= RANSAC_AGREE_SHARE, f"arc: RANSAC inlier flags agree on {cmp['agree_share']:.5f}")
    return {k: float(np.median([sp[k] for sp in splits])) for k in splits[0]}, med


def cli_camera(h: int, w: int):
    """The camera ``reconstruct`` infers for an h x w folder."""
    from pixtrack_tpu_torch.sfm import colmap_io
    from pixtrack_tpu_torch.tracking.refiner import infer_camera_from_image

    cam = infer_camera_from_image((h, w), device="cpu")
    return colmap_io.CameraRecord(1, "SIMPLE_RADIAL", w, h, np.array([float(cam.f[0]), w / 2.0, h / 2.0, 0.0]))


def phase_reconstruct_cli(work: Path, views: dict, truth: dict, ref: dict, jobs: list):
    """Phase 31: ``reconstruct`` through the port's CLI over phase 30's
    images written to a mapping folder, the camera inferred from the size;
    with what it runs (``incremental_sfm`` with that camera and its
    settings) at seeds 1..CLI_SEEDS-1 in the mapper workers (``jobs``), the
    median held to JAX's."""
    import torch

    from pixtrack_tpu_torch.mapping.mesh_render import write_png
    from pixtrack_tpu_torch.pipelines import assets, cli
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    paths = assets.layout(work)
    paths["mapping"].mkdir(parents=True, exist_ok=True)
    for iid, img in views.items():
        write_png(paths["mapping"] / f"view_{iid:04d}.png", img)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["reconstruct", "--object_path", str(work)])
    wall = time.perf_counter() - t0
    rec = SceneModel.load(paths["ref_sfm"])
    outs = [dict(rig_outcome(rec, truth), seconds=wall)]
    cam = next(iter(rec.cameras.values()))
    log(f"[reconstruct] camera {cam.model} {[round(float(v), 3) for v in cam.params]} (the rig's f "
        f"{ARC_RES * 1.1:.1f})")
    report_outcome("reconstruct", outs[0], ref["cli"], wall)
    outs += [job.result()[0] for job in jobs]
    log("[reconstruct] global rotation medians at seeds 0-{}: {} deg (JAX {})".format(
        CLI_SEEDS - 1, [round(o["global_deg"], 3) for o in outs],
        [round(ref["cli" if k == 0 else f"cli{k}"]["global_deg"], 3) for k in range(CLI_SEEDS)]))
    med = outcome_median(outs)
    jax_med = outcome_median([ref["cli" if k == 0 else f"cli{k}"] for k in range(CLI_SEEDS)])
    report_outcome(f"reconstruct, median over seeds 0-{CLI_SEEDS - 1}", med, jax_med, med["seconds"])
    check(med["registered"] >= jax_med["registered"] - 1, f"reconstruct: {med['registered']} registered")
    check(med["global_deg"] <= jax_med["global_deg"] + CLI_MARGIN_DEG,
          f"reconstruct: global rotation {med['global_deg']:.3f} deg over JAX's {jax_med['global_deg']:.3f} + "
          f"{CLI_MARGIN_DEG}")


def ring_rig(work: Path):
    """Phase 32's capture rendered by the port: ({id: image}, {name: (R, t)},
    {id: name}, the PINHOLE record)."""
    from pixtrack_tpu_torch.geometry import Camera, Pose
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
    from pixtrack_tpu_torch.sfm import colmap_io

    mesh = load_obj(REPO / "assets" / "mesh_world" / "src" / "house.obj")
    res, f = RING_RES, RING_FOCAL
    camera = Camera.pinhole(f, f, (res - 1) / 2, (res - 1) / 2, res, res)
    views, truth, names = {}, {}, {}
    for iid, (R, t) in ring_rig_poses(mesh["vertices"]).items():
        views[iid] = render_mesh(mesh, Pose.from_Rt(R, t), camera, background=(1, 1, 1))
        names[iid] = f"ring_{iid - 1:04d}.png"
        truth[names[iid]] = (R, t)
    return views, truth, names, colmap_io.CameraRecord(1, "PINHOLE", res, res, np.array([f, f, res / 2.0, res / 2.0]))


def phase_ring(work: Path, ref: dict):
    """Phase 32: the ring capture of the house reconstructed without its
    poses at the CLI's settings for 448 px and the rig's PINHOLE camera,
    held to JAX's outcome on the same renders; returns the model's
    directory, the rig's poses and the time split."""
    views, truth, names, cam_rec = ring_rig(work)
    rec, wall, split = run_mapper(views, cam_rec, "ring, unposed", names=names, max_keypoints=1024, nms_radius=2)
    out = rig_outcome(rec, truth)
    jax_runs = [ref[f"ring{k}"] for k in range(3)]
    jax_med = outcome_median(jax_runs)
    report_outcome("ring, unposed", out, jax_med, wall)
    log(f"[ring, unposed] JAX at seeds 0-2: registered {[int(r['registered']) for r in jax_runs]}, points "
        f"{[int(r['points']) for r in jax_runs]}, global {[round(r['global_deg'], 3) for r in jax_runs]} deg; gates: "
        f"registered >= {jax_med['registered'] - 1:.0f}, points within {RING_POINTS_TOL:.0%} of "
        f"{jax_med['points']:.0f}, global <= {jax_med['global_deg']:.3f} + {RING_MARGIN_DEG} deg")
    check(out["registered"] >= jax_med["registered"] - 1, f"ring: {out['registered']} registered")
    check(abs(out["points"] - jax_med["points"]) <= RING_POINTS_TOL * jax_med["points"],
          f"ring: {out['points']} points against JAX's {jax_med['points']:.0f}")
    check(out["global_deg"] <= jax_med["global_deg"] + RING_MARGIN_DEG,
          f"ring: global rotation {out['global_deg']:.3f} deg over JAX's {jax_med['global_deg']:.3f} + "
          f"{RING_MARGIN_DEG}")
    d = work / "unposed_sfm"
    d.mkdir(parents=True, exist_ok=True)
    rec.save(d)
    return d, truth, split


def aligned_to_rig(model_dir: Path, truth: dict, out: Path) -> Path:
    """The model mapped onto the rig's frame by the similarity that best
    aligns its camera centres to the rig's (``truth``: {name: (R, t)},
    ``umeyama_alignment``), saved to ``out``; the tracks as they are."""
    import dataclasses

    from scipy.spatial.transform import Rotation

    from pixtrack_tpu_torch.eval.metrics import umeyama_alignment
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    m = SceneModel.load(model_dir)
    R = quat_rotmats(m.qvecs)
    c = -np.einsum("pji,pj->pi", R, m.tvecs)
    cg = np.stack([-truth[n][0].T @ truth[n][1] for n in m.names])
    s, Ra, ta = umeyama_alignment(c, cg)
    images = {}
    for k, iid in enumerate(m.image_ids):
        Rw = R[k] @ Ra.T
        q = np.roll(Rotation.from_matrix(Rw).as_quat(), 1)
        images[int(iid)] = dataclasses.replace(m.images[int(iid)], qvec=q if q[0] >= 0 else -q,
                                               tvec=-Rw @ (s * Ra @ c[k] + ta))
    points = {int(p): dataclasses.replace(m.points3D[int(p)], xyz=s * Ra @ m.points3D[int(p)].xyz + ta)
              for p in m.point_ids}
    out.mkdir(parents=True, exist_ok=True)
    SceneModel(m.cameras, images, points).save(out)
    return out


def phase_track_unposed(device, work: Path, model_dir: Path, truth: dict, ref: dict):
    """Phase 33: phase 7's fused frame in open loop over phase 32's model and
    over JAX's model of the same capture, each aligned to the rig's frame."""
    from pixtrack_tpu_torch.nerf import fused_mlp

    jax_dir = work / "unposed_jax"
    jax_dir.mkdir(parents=True, exist_ok=True)
    for f, data in ref["ring_model"].items():
        (jax_dir / f"{f}.bin").write_bytes(data)
    fused_mlp.reset_launch_counts()
    free = {"open_ok": 0, "open_med": 180.0}
    _, _, got_jax, _ = phase_mesh(device, aug_sfm=aligned_to_rig(jax_dir, truth, work / "unposed_jax_aligned"),
                                  gates=free, label="unposed, JAX's model", open_only=True)
    jax_ok = got_jax["open"]
    gates = MESH_GATES if jax_ok >= MESH_MIN_OK else {"open_ok": jax_ok - 1, "open_med": 180.0}
    _, _, got, _ = phase_mesh(device, aug_sfm=aligned_to_rig(model_dir, truth, work / "unposed_aligned"), gates=gates,
                              label="unposed", open_only=True)
    k1 = fused_mlp.launch_count(fused_mlp.K1)
    log(f"[unposed] open loop over the card's unposed model {got['open']}/20, over JAX's {jax_ok}/20 (gate: "
        f"{'phase 7' if gates is MESH_GATES else 'JAX less one'}); K1 launches {k1}")
    return {"open": got["open"], "jax_open": jax_ok, "k1": k1}


def phase_unposed(device, work: Path):
    """Phases 30-33; returns phase 32's time split and phase 33's result."""
    ref = jax_reconstruct_reference()
    arc_dir = work / "arc"
    arc_dir.mkdir()
    views, truth, cam_rec = arc_rig(arc_dir)
    h, w = next(iter(views.values())).shape[:2]
    with worker_pool(MAPPER_WORKERS) as pool:
        arc_jobs = [pool.submit(mapper_job, views, cam_rec, truth, f"arc, seed {seed}",
                                dict(max_keypoints=768, nms_radius=1, seed=seed)) for seed in range(1, ARC_SEEDS)]
        cli_jobs = [pool.submit(mapper_job, views, cli_camera(h, w), truth, f"reconstruct's mapper, seed {seed}",
                                dict(max_keypoints=1024, nms_radius=1, seed=seed)) for seed in range(1, CLI_SEEDS)]
        arc_split, arc_med = timed_phase("phase 30, the arc rig unposed", phase_arc, views, truth, cam_rec, ref,
                                         arc_jobs)
        timed_phase("phase 31, reconstruct (the CLI)", phase_reconstruct_cli, arc_dir, views, truth, ref, cli_jobs)
    model, ring_truth, split = timed_phase("phase 32, the house's ring unposed", phase_ring, work, ref)
    tracked = timed_phase("phase 33, tracking over the unposed model", phase_track_unposed, device, work, model,
                          ring_truth, ref)
    return {"arc_split": arc_split, "arc_median": arc_med, "split": split, **tracked}


# ------------------------------------------------------------ phases 34-37 --
# The UNet trained on the card: warp-consistency InfoNCE
# (pixtrack_tpu_torch/features/train.py) and basin training through the
# unrolled aligner (features/train_basin.py), the held-out alignment
# benchmark (features/evaluate.py) on the JAX package's own scenes, and phase
# 7's open loop with the UNet trained here. Training shapes are the recipes'
# (InfoNCE: FeatureTrainConfig's defaults; basin: the shipped run,
# scripts_dev/train_basin_run.py:30-33, each step one CUDA graph replay); only
# the step counts are cut, to keep the script inside its time limit (the
# uncut basin run: scripts_dev/train_basin_card.py).
INFONCE_STEPS, INFONCE_LOG_EVERY = 200, 50     # of FeatureTrainConfig's 2000
BASIN_STEPS, BASIN_LOG_EVERY = 500, 50         # of the shipped run's 2000
EVAL_JAX = REPO / "scripts_dev" / "evaluate_jax.npz"
# Phase 36 holds the port's shipped UNet and handcrafted pyramid to JAX's
# per-start outcome on the same stored scenes (scripts_dev/evaluate_jax.py):
# converged flags equal on EVAL_FLAGS_SHARE of the starts and the converged
# counts within EVAL_COUNT_SLACK.
EVAL_FLAGS_SHARE, EVAL_COUNT_SLACK = 0.9, 3
# The card-trained UNet must converge on more starts than the handcrafted
# pyramid and on at least the shipped UNet's count less BASIN_MARGIN: the
# spread (max - min) of the recipe's outcome at seeds 1 and 2 over the
# second half of phase 35's run, steps 250-500, with the graphed trainer
# (scripts_dev/train_basin_card.py --eval-at 250 500, uncut; H100 80GB HBM3,
# 700 W): seed 1 34, 43, seed 2 32, 34 of 48 (at 2000 steps 45 and 38; seed
# 0 35, 47, 46). Seed 0, the run judged, sets nothing.
BASIN_MARGIN = 43 - 32


def basin_step_split(device, cfg, steps=3) -> dict:
    """CUDA events over one eager basin-training step at ``cfg`` (a fresh
    UNet, after warm-up steps): draws, scene synthesis, UNet forward (both
    images of every scene), observation, the unrolled GN steps with their
    loss, backward, clip + Adam; the host's wall time of that step; and the
    time of one replay of the step's CUDA graph, as the trainer runs it. ms."""
    import torch

    from pixtrack_tpu_torch.features.train_basin import (
        clip_by_global_norm,
        graphed_loss_and_grads,
        make_basin_loss_fn,
    )
    from pixtrack_tpu_torch.features.unet import init_unet
    from pixtrack_tpu_torch.nerf.optim import Adam

    model = init_unet(torch.Generator().manual_seed(99), device=device)
    loss_fn = make_basin_loss_fn(model, cfg)
    params = list(model.parameters())
    opt = Adam(params, lambda k: cfg.lr)
    gen = torch.Generator(device=device).manual_seed(99)
    for _ in range(steps):
        events = []

        def mark(label):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((label, ev))

        loss_fn.timer = mark
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        draws = loss_fn.draws(gen)
        mark("draws")
        loss = loss_fn(draws=draws)
        loss.backward()
        mark("backward")
        clip_by_global_norm(params, 1.0)
        opt.step()
        mark("clip + Adam")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = {"step (events)": events[0][1].elapsed_time(events[-1][1]),
             **{label: events[i - 1][1].elapsed_time(ev) for i, (label, ev) in enumerate(events) if i},
             "step (host wall)": wall}
    # the same step as the trainer runs it on the card: one CUDA graph replay, then Adam. The
    # eager step's autograd graph must be gone first: its gradient accumulators belong to the
    # default stream, which a capture may not depend on.
    del loss
    run = graphed_loss_and_grads(loss_fn, params, draws)
    replay = cuda_time_ms(lambda: run(draws), 10)
    return {**split, "graph replay (loss, backward, clip)": replay}


def infonce_step_split(device, cfg, steps=3) -> dict:
    """CUDA events over one InfoNCE training step at ``cfg`` (a fresh UNet,
    after warm-up steps): draws, textures and warps, UNet forward (both
    copies), the InfoNCE losses, backward, Adam; and the host's wall time of
    the step. ms."""
    import torch

    from pixtrack_tpu_torch.features.train import make_loss_fn
    from pixtrack_tpu_torch.features.unet import init_unet
    from pixtrack_tpu_torch.nerf.optim import Adam

    model = init_unet(torch.Generator().manual_seed(99), device=device)
    loss_fn = make_loss_fn(model, cfg)
    opt = Adam(list(model.parameters()), lambda k: cfg.lr)
    gen = torch.Generator(device=device).manual_seed(99)
    for _ in range(steps):
        events = []

        def mark(label):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((label, ev))

        loss_fn.timer = mark
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        loss = loss_fn(draws=loss_fn.draws(gen))
        loss.backward()
        mark("backward")
        opt.step()
        mark("Adam")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return {"step (events)": events[0][1].elapsed_time(events[-1][1]),
            **{label: events[i - 1][1].elapsed_time(ev) for i, (label, ev) in enumerate(events) if i},
            "step (host wall)": wall}


def phase_infonce(device):
    """Phase 34: InfoNCE training at FeatureTrainConfig's widths (batch 4,
    128 px, 256 pairs a level, lr 1e-3), INFONCE_STEPS steps; the loss on a
    fixed batch before and after."""
    import torch

    from pixtrack_tpu_torch.features.train import FeatureTrainConfig, make_loss_fn, train_features
    from pixtrack_tpu_torch.features.unet import init_unet

    cfg = FeatureTrainConfig(n_steps=INFONCE_STEPS, log_every=INFONCE_LOG_EVERY)
    split = infonce_step_split(device, cfg)
    log("[infonce] one step at its widths (CUDA events, ms; the draws are inside the first part): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    model = init_unet(torch.Generator().manual_seed(0), device=device)
    fixed = make_loss_fn(model, cfg).draws(torch.Generator(device=device).manual_seed(42))
    with torch.no_grad():
        before = float(make_loss_fn(model, cfg)(draws=fixed))
    model, info = train_features(cfg, seed=0, model=model, device=device)
    with torch.no_grad():
        after = float(make_loss_fn(model, cfg)(draws=fixed))
    hist = info["history"]
    log(f"[infonce] {cfg.n_steps} steps (batch {cfg.batch}, {cfg.size} px, {cfg.n_pairs} pairs a level): loss "
        f"{[(k, round(v, 4)) for k, v in hist]}; {cfg.n_steps / info['seconds']:.2f} steps/s "
        f"({info['seconds']:.1f} s); the fixed batch's loss {before:.4f} -> {after:.4f}")
    check(all(np.isfinite(v) for _, v in hist), f"infonce: a logged loss is not finite: {hist}")
    check(hist[-1][1] < hist[0][1], f"infonce: the loss did not go down: {hist}")
    check(after < before, f"infonce: the fixed batch's loss rose: {before:.4f} -> {after:.4f}")
    return {"steps_per_s": cfg.n_steps / info["seconds"], "split": split}


def phase_basin(device, work: Path):
    """Phase 35: basin training at the shipped run's config, seed 0,
    BASIN_STEPS steps: loss and global gradient norm at each logged step,
    steps/s, the one-step split; the weights saved with save_unet_weights
    and read back with load_unet_weights, parameters equal bit for bit."""
    import torch

    from pixtrack_tpu_torch.features.train import load_unet_weights, save_unet_weights
    from pixtrack_tpu_torch.features.train_basin import BasinTrainConfig, train_basin_features

    cfg = BasinTrainConfig(n_steps=BASIN_STEPS, batch=2, n_perturb=4, size=192, tex_size=256, n_points=512,
                           k_steps=5, scan_steps=False, log_every=BASIN_LOG_EVERY)
    split = basin_step_split(device, cfg)
    log("[basin] one step at the shipped run's config (CUDA events, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    torch.cuda.reset_peak_memory_stats()
    model, info = train_basin_features(cfg, seed=0, device=device)
    hist, norms = info["history"], info["grad_norms"]
    log(f"[basin] {cfg.n_steps} steps ({cfg.batch} scenes x {cfg.n_perturb} starts, {cfg.size} px, {cfg.n_points} "
        f"points, {cfg.k_steps} GN steps a level): loss {[(k, round(v, 4)) for k, v in hist]}; global gradient "
        f"norm {[(k, round(v, 3)) for k, v in norms]}; {cfg.n_steps / info['seconds']:.2f} steps/s "
        f"({info['seconds']:.1f} s), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(all(np.isfinite(v) for _, v in hist + norms), "basin: a logged loss or gradient norm is not finite")
    path = work / "unet_card.npz"
    save_unet_weights(path, model)
    back = load_unet_weights(path, device=device).state_dict()
    for k, v in model.state_dict().items():
        check(back[k].dtype == v.dtype and torch.equal(back[k], v), f"basin: {k} differs after the round trip")
    log(f"[basin] saved {path.name} ({path.stat().st_size / 2**20:.1f} MiB) and read it back: "
        f"{len(back)} tensors equal bit for bit")
    return model, {"steps_per_s": cfg.n_steps / info["seconds"], "split": split, "weights": path}


def eval_job(name: str, weights):
    """Phase 36's benchmark of one extractor in a worker process: the
    handcrafted pyramid, or the UNet of ``weights``; (per-start errors,
    seconds)."""
    import torch

    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
    from pixtrack_tpu_torch.features.evaluate import evaluate_starts, load_scenes
    from pixtrack_tpu_torch.features.unet import load_unet_weights

    device = torch.device("cuda:0")
    model = HandcraftedExtractor(device=device) if weights is None else load_unet_weights(weights, device=device)
    scenes = load_scenes(EVAL_JAX, device)
    t0 = time.perf_counter()
    starts = evaluate_starts(FeatureExtractor(model, resize=None), align_cfg=AlignConfig(num_iters=100, robust_c=1.0),
                             device=device, scenes=scenes)
    return starts, time.perf_counter() - t0


def eval_weights(card_weights: Path) -> dict:
    """Phase 36's extractors: the shipped UNet, the handcrafted pyramid and
    phase 35's UNet (read back from ``card_weights``)."""
    return {"unet_basin": REPO / "assets" / "unet_basin.npz", "handcrafted": None, "card-trained": card_weights}


def phase_feature_eval(jobs: dict):
    """Phase 36: the held-out benchmark (FeatureEvalConfig(n_scenes=12,
    n_perturb=4), the production LM at 100 iterations) on the JAX package's
    scenes for ``eval_weights``' three extractors, run side by side in worker
    processes (``jobs``: their futures); the first two held to JAX's
    per-start outcome, the third to the other two."""
    from pixtrack_tpu_torch.features.evaluate import converged, summarize

    tpu = json.loads((REPO / "assets" / "unet_basin_eval.json").read_text())
    results = {name: job.result() for name, job in jobs.items()}
    counts = {}
    with np.load(EVAL_JAX) as ref:
        for name, (starts, seconds) in results.items():
            res, conv = summarize(starts), converged(starts)
            counts[name] = int(conv.sum())
            text = (f"[eval] {name}: converged {counts[name]}/{res['n']} ({res['convergence_rate']:.3f}), rotation "
                    f"median {res['rot_err_median']:.3f} deg, mean {res['rot_err_mean']:.3f}, translation median "
                    f"{res['t_err_median']:.4f}; {seconds:.1f} s")
            if name in ("unet_basin", "handcrafted"):
                j_rot, j_init = ref[f"{name}_rot"], ref[f"{name}_rot_init"]
                j_conv = (j_rot < 1.0) & (j_rot < 0.25 * np.maximum(j_init, 1e-6))
                same = float((conv == j_conv).mean())
                log(f"{text}; JAX on the CPU, same scenes: converged {int(j_conv.sum())}/48, rotation median "
                    f"{np.median(j_rot):.3f} deg; flags equal on {same:.3f} of the starts; the TPU's run "
                    f"(assets/unet_basin_eval.json, its own scenes): {tpu[name]['convergence_rate']:.3f}, median "
                    f"{tpu[name]['rot_err_median']:.3f} deg")
                check(same >= EVAL_FLAGS_SHARE and abs(counts[name] - int(j_conv.sum())) <= EVAL_COUNT_SLACK,
                      f"eval: {name} against JAX: flags equal on {same:.3f}, converged {counts[name]} vs "
                      f"{int(j_conv.sum())}")
            else:
                log(text)
    check(counts["card-trained"] > counts["handcrafted"],
          f"eval: the card-trained UNet converged {counts['card-trained']} <= the handcrafted "
          f"{counts['handcrafted']}")
    check(counts["card-trained"] >= counts["unet_basin"] - BASIN_MARGIN,
          f"eval: the card-trained UNet converged {counts['card-trained']} < the shipped {counts['unet_basin']} "
          f"less {BASIN_MARGIN}")
    return counts


def phase_track_card_unet(device, card_model):
    """Phase 37: phase 7's fused frame in open loop on the mesh world with
    phase 35's UNet in place of the shipped one; K1 once per fused frame plus
    the cold start's."""
    from pixtrack_tpu_torch.features import FeatureExtractor
    from pixtrack_tpu_torch.nerf import fused_mlp

    fused_mlp.reset_launch_counts()
    _, _, opened, _ = phase_mesh(device, label="card-trained UNet", open_only=True,
                                 extractor=FeatureExtractor(card_model.eval(), resize=1024))
    k1 = fused_mlp.launch_count(fused_mlp.K1)
    check(k1 == 21, f"card-trained UNet: K1 launched {k1} times, not the cold start's 1 and 20 fused frames")
    log(f"[card-trained UNet] open loop {opened['open']}/20 (the shipped UNet: phase 7); K1 launches {k1}")
    return {"open": opened["open"], "k1": k1}


def phase_unet_training(device):
    """Phases 34-37, each timed, in a work directory of their own."""
    import tempfile

    infonce = timed_phase("phase 34, InfoNCE training", phase_infonce, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_unet_") as tmp:
        model, basin = timed_phase("phase 35, basin training", phase_basin, device, Path(tmp))
        weights = eval_weights(basin["weights"])
        with worker_pool(len(weights)) as pool:
            # phase 36's benchmarks run in the workers while phase 37 runs here
            jobs = {name: pool.submit(eval_job, name, w) for name, w in weights.items()}
            tracked = timed_phase("phase 37, tracking with the card-trained UNet", phase_track_card_unet, device,
                                  model)
            counts = timed_phase("phase 36, the held-out alignment benchmark (after phase 37)", phase_feature_eval,
                                 jobs)
    return {"infonce": infonce, "basin": basin, "counts": counts, **tracked}


# ------------------------------------------------------------ phases 38-40 --
# The rest of the command line and the learned SfM components at inference.
# Phase 38 drives the subcommands a user calls to track: ``demo`` (an
# analytic world, no kernel), ``track`` over phases 21-24's object folder
# (its 300-step snapshot baked, so no kernel either) with the mesh world's
# queries, ``eval`` and ``visualize`` of its poses. Phase 39 holds the
# dense descriptor, SuperPoint and the attention matcher on the card to the
# port on the CPU, times them, and reruns the deployment A/B behind
# assets/dense_descriptor_eval.json. Phase 40 is phase 30's arc rig through
# ``reconstruct --detector dense``. The JAX package's numbers come from
# scripts_dev/learned_mapping_jax.py (JAX on the CPU).
LEARNED_JAX = REPO / "scripts_dev" / "learned_mapping_jax.json"
# tests/test_config_cli.py::test_demo_subcommand's gate (3 frames there, 6 here)
DEMO_FRAMES, DEMO_GATE = 6, 2 / 3
TRACK_FRAMES, CLI_POSE_TOL = 10, 1e-5
# the nets on the card against the port on the CPU; the learned matcher's
# matches0 equal on this share of one arc-rig pair's keypoints
NET_TOL, MATCH_SHARE = 1e-4, 0.99
# the deployment A/B (scripts_dev/train_dense_descriptor_run.py's protocol)
AB = dict(n_scenes=2, n_views=12, res=192, max_kp=256, min_deg=20.0, max_deg=52.0, seed=31)
AB_MATCH = {"patch": (0.5, 0.98), "learned": (0.1, 0.98)}
AB_COUNT_TOL = 0.03  # each count within 3 % of JAX's on the CPU
TPU_AB = {"patch": (2292, 4031), "learned": (4499, 6543)}  # assets/dense_descriptor_eval.json: correct, proposed
# Phase 40 runs ``reconstruct --detector dense`` (seed 0) and what it runs at
# seeds 1..DENSE_SEEDS-1 in the mapper workers. At the CLI's camera (f =
# 230.4 against the rig's 211.2) the dense descriptor's mapper lands tens of
# degrees off at some seeds in both packages (the global averaging; JAX on
# the CPU at seeds 0-7: 1.99, 2.47, 1.46, 2.27, 57.37, 7.78, 3.08, 21.45 deg,
# scripts_dev/learned_mapping_jax.py dense SEED), and on equal draws the two
# packages fail at different seeds (scripts_dev/dense_reconstruct_seeds.py
# paired SEED, seeds 0-7: JAX 4, the port 1 beyond 5 deg). So no seed judges
# it, and a spread over three seeds (phase 31's rule) is tens of degrees: the
# phase holds the median over DENSE_SEEDS seeds to JAX's median over its
# seeds 0-7, registered >= JAX's - 1 and the global rotation median <= JAX's
# + DENSE_MARGIN_DEG, the larger over the two packages of the gap between
# the medians of seeds 0-7 and seeds 8-15 on the CPU (JAX: 2.771 against
# 1.922 deg; the port, dense_reconstruct_seeds.py port 0..15: 6.623 against
# 3.279 deg).
DENSE_SEEDS = 8
DENSE_MARGIN_DEG = 6.623 - 3.279


def capture_cli(argv) -> str:
    """What ``pipelines.cli.main(argv)`` prints."""
    import io

    from pixtrack_tpu_torch.pipelines import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def phase_command_line(device, work: Path, assets) -> dict:
    """Phase 38: ``demo``; ``track`` over phases 21-24's object folder
    (``work``) with the mesh world's first TRACK_FRAMES queries as PNGs,
    against the same tracker through the API; ``eval`` of its poses with the
    ground truth added, against ``evaluate_trajectory`` of the API's;
    ``visualize`` of three poses."""
    import pickle

    import torch

    from pixtrack_tpu_torch.eval.metrics import evaluate_trajectory
    from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
    from pixtrack_tpu_torch.mapping.mesh_render import write_png
    from pixtrack_tpu_torch.mapping.nerf_dataset import estimate_aabb_from_scene
    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf.testbed import initialize_testbed
    from pixtrack_tpu_torch.pipelines.assets import layout
    from pixtrack_tpu_torch.sfm.scene import SceneModel
    from pixtrack_tpu_torch.tracking import PixTrackTracker
    from pixtrack_tpu_torch.utils.config import ObjectConfig, RunConfig
    from pixtrack_tpu_torch.utils.io import ImageIterator

    fused_mlp.reset_launch_counts()
    t0 = time.perf_counter()
    out = capture_cli(["demo", "--frames", str(DEMO_FRAMES)])
    demo = json.loads(out[out.index("{"):])
    log(f"[demo] {demo['n_frames']} frames, success (10 cm, 10 deg) {demo['success_10cm10deg']:.3f}, rotation error "
        f"mean {demo['mean_r_deg']:.3f} deg, median {demo['median_r_deg']:.3f}; {time.perf_counter() - t0:.1f} s")
    check(demo["n_frames"] == DEMO_FRAMES and demo["success_10cm10deg"] >= DEMO_GATE,
          f"demo: {demo['n_frames']} frames, success {demo['success_10cm10deg']:.3f} < {DEMO_GATE:.3f}")

    query = work / "queries"
    query.mkdir(exist_ok=True)
    frames = assets.frames[:TRACK_FRAMES]
    for name, img in frames:
        write_png(query / name, img)
    out_dir = work / "track_out"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = json.loads(capture_cli(["track", "--object_path", str(work), "--query", str(query), "--frames",
                                    str(TRACK_FRAMES), "--out_dir", str(out_dir)]).strip().splitlines()[-1])
    cli_wall = time.perf_counter() - t0
    with open(out_dir / "poses.pkl", "rb") as f:
        poses = pickle.load(f)
    paths = layout(work)
    scene, tf = SceneModel.load(paths["aug_sfm"]), NerfTransform.load(paths["nerf2sfm"])
    t0 = time.perf_counter()
    testbed = initialize_testbed(paths["snapshot"], aabb=estimate_aabb_from_scene(scene, tf), tighten=True,
                                 device=device)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    run_cfg = RunConfig()
    tracker = PixTrackTracker(scene, run_cfg.make_extractor(device), testbed, tf,
                              run_cfg.tracker_config(ObjectConfig()), align_cfg=run_cfg.align_config())
    tracker.run(ImageIterator(query, max_frames=TRACK_FRAMES), max_frames=TRACK_FRAMES)
    api = tracker.pose_history
    check(sorted(poses) == sorted(api) == sorted(n for n, _ in frames), "track: the CLI's and the API's frames differ")
    diff = max(float(np.abs(poses[n]["T_refined"] - api[n]["T_refined"]).max()) for n in api)
    rot = [rot_err_deg(poses[n]["T_refined"][:3, :3], assets.gt[k].R.cpu().numpy()) for k, (n, _) in enumerate(frames)]
    log(f"[track] {stats}; {cli_wall:.1f} s through the CLI (the snapshot's load, bake and bounds sweep "
        f"{bake_s:.1f} s of it through the API); poses against the same tracker through the API: max "
        f"|dT| {diff:.2e}; rotation errors against the orbit (deg): {[round(r, 2) for r in rot]}, median "
        f"{np.median(rot):.2f}; successes {sum(bool(poses[n]['success']) for n in poses)}/{TRACK_FRAMES}")
    check(diff <= CLI_POSE_TOL, f"track: the CLI's poses are {diff:.2e} from the API's")

    with_gt = {}
    for k, (n, _) in enumerate(frames):
        with_gt[n] = dict(poses[n], gt_pose=assets.gt[k].to_4x4().cpu().numpy())
    with open(out_dir / "poses_gt.pkl", "wb") as f:
        pickle.dump(with_gt, f)
    got = json.loads(capture_cli(["eval", "--poses", str(out_dir / "poses_gt.pkl")]))
    ref = evaluate_trajectory([(api[n]["T_refined"][:3, :3], api[n]["T_refined"][:3, 3]) for n, _ in frames],
                              [(T.R.cpu().numpy(), T.t.cpu().numpy()) for T in assets.gt[:TRACK_FRAMES]])
    gap = max(abs(got[k] - ref[k]) for k in ref)
    log(f"[eval] {json.dumps(got)}; against evaluate_trajectory of the API's poses: max gap {gap:.2e}")
    check(sorted(got) == sorted(ref) and gap <= 1e-6 * max(1.0, max(abs(v) for v in ref.values())),
          f"eval: {got} against {ref}")

    three = {n: poses[n] for n, _ in frames[:3]}
    with open(out_dir / "poses_3.pkl", "wb") as f:
        pickle.dump(three, f)
    t0 = time.perf_counter()
    capture_cli(["visualize", "--object_path", str(work), "--poses", str(out_dir / "poses_3.pkl"), "--out_dir",
                 str(work / "viz")])
    written = sorted(p.name for p in (work / "viz").glob("result_*.jpg"))
    log(f"[visualize] {len(written)} overlays in {time.perf_counter() - t0:.1f} s: {written}")
    check(len(written) == 3, f"visualize: {len(written)} overlays, not 3")
    launches = {k: fused_mlp.launch_count(k) for k in (fused_mlp.K1, fused_mlp.K2)}
    log(f"[command line] K1 / K2 launches over phase 38: {launches[fused_mlp.K1]} / {launches[fused_mlp.K2]} (the "
        "demo's field is analytic, the snapshot is baked: no kernel is on these paths)")
    return {"demo": demo["success_10cm10deg"], "track_rot_median": float(np.median(rot)), "pose_diff": diff}


def host_ms(fn, iters: int = 5) -> float:
    """Host wall time of one call of ``fn`` (which ends in a copy to the host),
    after one warm-up call, synchronised."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def bank_counts(bank: dict, min_score: float, ratio: float) -> dict:
    """Correct / proposed / possible mutual-NN + ratio matches over a pair bank."""
    from pixtrack_tpu_torch.mapping.matcher import match_descriptors

    c = prop = poss = 0
    for p in range(bank["gt"].shape[0]):
        n0, n1 = int(bank["valid0"][p].sum()), int(bank["valid1"][p].sum())
        gt = bank["gt"][p][:n0]
        m0 = np.asarray(match_descriptors(bank["desc0"][p][:n0], bank["desc1"][p][:n1], min_score=min_score,
                                          ratio=ratio)[0])
        prop += int((m0 >= 0).sum())
        c += int(((m0 == gt) & (gt >= 0) & (m0 >= 0)).sum())
        poss += int((gt >= 0).sum())
    return {"correct": c, "proposed": prop, "gt_possible": poss, "pairs": int(bank["gt"].shape[0]),
            "precision": c / max(prop, 1)}


def phase_learned(device, work: Path, arc_views: dict) -> dict:
    """Phase 39: the dense descriptor and SuperPoint (the candidate weights)
    on a 448 px render of the house, and the attention matcher (seeded init
    weights) on one arc-rig pair, card against the port on the CPU; their
    times per call; the deployment A/B on the card."""
    import copy

    import torch

    from pixtrack_tpu_torch.mapping import attention_matcher as am
    from pixtrack_tpu_torch.mapping import dense_descriptor as dd
    from pixtrack_tpu_torch.mapping import superpoint as sp
    from pixtrack_tpu_torch.mapping.detector import detect_and_describe, detect_keypoints
    from pixtrack_tpu_torch.mapping.mesh_render import read_png
    from pixtrack_tpu_torch.mapping.train_matcher import build_mesh_pair_bank
    from pixtrack_tpu_torch.pipelines.assets import layout

    cpu = torch.device("cpu")
    img = read_png(sorted(layout(work)["mapping"].glob("*.png"))[0])
    check(img.shape[:2] == (448, 448), f"learned: the view is {img.shape}")
    net, net_cpu = (dd.load_descriptor_weights(REPO / "assets" / "dense_descriptor.npz", device=d) for d in (device, cpu))
    x = torch.from_numpy(img.astype(np.float32) / 255.0)[None]
    with torch.no_grad():
        err_map = float((net(x.to(device)).cpu() - net_cpu(x)).abs().max())
    kp = detect_keypoints(img, max_keypoints=1024, device=cpu)[0].numpy()
    err_desc = float(np.abs(dd.describe_at_dense(net, img, kp) - dd.describe_at_dense(net_cpu, img, kp)).max())
    log(f"[dense descriptor] 448 px: the map on the card against the CPU {err_map:.2e}, descriptors at "
        f"{len(kp)} Harris keypoints {err_desc:.2e}")
    check(max(err_map, err_desc) <= NET_TOL, f"dense descriptor: card against CPU {err_map:.2e} / {err_desc:.2e}")

    cand = REPO / "assets" / "superpoint_candidate.npz"
    spn, spn_cpu = (sp.load_superpoint_weights(cand, device=d) for d in (device, cpu))
    g = sp._grey(img, cpu)[None, ..., None]
    with torch.no_grad():
        (det, desc), (det_c, desc_c) = (a.cpu() for a in spn(g.to(device))), spn_cpu(g)
    err_det, err_sdesc = float((det - det_c).abs().max()), float((desc - desc_c).abs().max())
    (k1, s1, d1), (k2, s2, d2) = (sp.extract_superpoint(n, img, max_keypoints=1024) for n in (spn, spn_cpu))
    dist = np.linalg.norm(k1[:, None] - k2[None], axis=-1) if len(k1) and len(k2) else np.zeros((0, 0))
    nn = dist.argmin(axis=1) if dist.size else np.zeros(0, int)
    same_set = len(k1) == len(k2) and sorted(nn) == list(range(len(k2))) and (
        dist[np.arange(len(k1)), nn].max(initial=0.0) <= 1e-3)
    log(f"[superpoint] 448 px, candidate weights: logits card against CPU {err_det:.2e} (largest "
        f"{float(det_c.abs().max()):.1f}), descriptors {err_sdesc:.2e}; extraction {len(k1)} / {len(k2)} keypoints, "
        f"the same set {same_set}")
    check(err_det <= NET_TOL * max(1.0, float(det_c.abs().max())) and err_sdesc <= NET_TOL,
          f"superpoint: card against CPU {err_det:.2e} / {err_sdesc:.2e}")
    check(same_set, "superpoint: the card's keypoints are not the CPU's")

    # untrained weights score no pair above the default min_score (0.2): at 0 the mutual argmax
    # that beats the dustbin still decides, so the comparison has matches to compare
    matcher = am.init_matcher(generator=torch.Generator().manual_seed(0), device=device)
    lm, lm_cpu = (am.LearnedMatcher(m, min_score=0.0) for m in (matcher, copy.deepcopy(matcher).to(cpu)))
    feats = [detect_and_describe(arc_views[i], max_keypoints=1024, nms_radius=1, device=device) for i in (1, 2)]
    (kp0, _, d0), (kp1, _, d1_) = ([t.cpu().numpy() for t in f] for f in feats)
    shape = arc_views[1].shape
    m_card, s_card = lm(d0, kp0, shape, d1_, kp1, shape)
    m_cpu, s_cpu = lm_cpu(d0, kp0, shape, d1_, kp1, shape)
    n0, n1 = len(kp0), len(kp1)
    logp_err = float(np.abs(lm.log_probs(d0, kp0, shape, d1_, kp1, shape)[: n0 + 1, : n1 + 1]
                            - lm_cpu.log_probs(d0, kp0, shape, d1_, kp1, shape)[: n0 + 1, : n1 + 1]).max())
    share = float((m_card == m_cpu).mean())
    log(f"[attention matcher] seeded init weights, arc views 1-2 ({n0} / {n1} keypoints, bucket "
        f"{am.bucket_size(n0, n1)}), min_score 0: matches0 equal on {share:.4f} ({int((m_card >= 0).sum())} / "
        f"{int((m_cpu >= 0).sum())} matches), scores {float(np.abs(s_card - s_cpu).max()):.2e}, log-probabilities "
        f"{logp_err:.2e}")
    check(share >= MATCH_SHARE and (m_cpu >= 0).sum() > 0 and logp_err <= NET_TOL,
          f"attention matcher: matches0 equal on {share:.4f}, log-probabilities {logp_err:.2e}")

    rng = np.random.default_rng(0)
    kp_d = detect_keypoints(img, max_keypoints=1024, device=device)[0].cpu().numpy()
    times = {"describe_at_dense, 448 px": host_ms(lambda: dd.describe_at_dense(net, img, kp_d)),
             "extract_superpoint, 448 px": host_ms(lambda: sp.extract_superpoint(spn, img, max_keypoints=1024))}
    for n in (256, 1024):
        dm, km = rng.normal(size=(2, n, 845)).astype(np.float32), rng.uniform(0, 447, (2, n, 2))
        times[f"LearnedMatcher, {n} keypoints"] = host_ms(lambda: lm(dm[0], km[0], (448, 448), dm[1], km[1], (448, 448)))
    log("[learned, ms per call] " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))

    def learned_detector(image, max_keypoints=256, **kw):
        kp_, sc_, _ = detect_and_describe(image, max_keypoints=max_keypoints, device=device, **kw)
        return kp_, sc_, dd.describe_at_dense(net, image, kp_.cpu().numpy())

    ref = json.loads(LEARNED_JAX.read_text())["ab"]
    t0 = time.perf_counter()
    ab = {}
    for name, det_fn in (("patch", None), ("learned", learned_detector)):
        bank = build_mesh_pair_bank(work / "ab" / name, detector=det_fn, device=device, **AB)
        ab[name] = bank_counts(bank, *AB_MATCH[name])
        r = ref[name]
        log(f"[A/B] {name} at {AB_MATCH[name]}: correct {ab[name]['correct']} of {ab[name]['proposed']} proposed "
            f"(precision {ab[name]['precision']:.4f}), {ab[name]['gt_possible']} possible over {ab[name]['pairs']} "
            f"pairs; JAX on the CPU {r['correct']} of {r['proposed']} ({r['precision']:.4f}), {r['gt_possible']}, "
            f"{r['pairs']} pairs; the TPU's run (assets/dense_descriptor_eval.json) {TPU_AB[name][0]} of "
            f"{TPU_AB[name][1]}")
        for k in ("correct", "proposed"):
            check(abs(ab[name][k] - r[k]) <= AB_COUNT_TOL * r[k], f"A/B: {name} {k} {ab[name][k]} against JAX's {r[k]}")
    log(f"[A/B] {time.perf_counter() - t0:.1f} s for both banks")
    check(ab["learned"]["correct"] > ab["patch"]["correct"], f"A/B: learned {ab['learned']['correct']} correct <= "
          f"patch {ab['patch']['correct']}")
    check(ab["learned"]["precision"] >= ab["patch"]["precision"] - 0.01, f"A/B: learned precision "
          f"{ab['learned']['precision']:.4f} < patch {ab['patch']['precision']:.4f} - 0.01")
    return {"ab": ab, "times": times}


def dense_mapper_job(images, cam_rec, truth: dict, label: str, kw: dict):
    """What ``reconstruct --detector dense`` runs, at ``kw``'s seed, in a
    worker process: (its outcome on the rig, its split by stage)."""
    import torch

    from pixtrack_tpu_torch.mapping import default_descriptor

    detector = default_descriptor(device=torch.device("cuda"))
    rec, wall, split = run_mapper(images, cam_rec, label, detector=detector, match_kw=dict(detector.match_kw), **kw)
    return dict(rig_outcome(rec, truth), seconds=wall), split


def phase_dense_reconstruct(work: Path, views: dict, truth: dict, jobs: list, harris: dict) -> dict:
    """Phase 40: ``reconstruct --detector dense`` through the CLI over phase
    30's images (seed 0), with what it runs at seeds 1..DENSE_SEEDS-1 in the
    mapper workers (``jobs``); the median held to JAX's over seeds 0-7."""
    import torch

    from pixtrack_tpu_torch.mapping.mesh_render import write_png
    from pixtrack_tpu_torch.pipelines import assets, cli
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    ref = json.loads(LEARNED_JAX.read_text())
    paths = assets.layout(work)
    paths["mapping"].mkdir(parents=True, exist_ok=True)
    for iid, img in views.items():
        write_png(paths["mapping"] / f"view_{iid:04d}.png", img)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["reconstruct", "--object_path", str(work), "--detector", "dense"])
    wall = time.perf_counter() - t0
    outs = [dict(rig_outcome(SceneModel.load(paths["ref_sfm"]), truth), seconds=wall)]
    outs += [job.result()[0] for job in jobs]
    jax = [ref[f"dense{k}"] for k in range(8)]
    log("[reconstruct --detector dense] global rotation medians at seeds 0-{}: {} deg (JAX at 0-7: {}); registered "
        "{} (JAX {})".format(DENSE_SEEDS - 1, [round(o["global_deg"], 3) for o in outs],
                            [round(o["global_deg"], 3) for o in jax], [o["registered"] for o in outs],
                            [o["registered"] for o in jax]))
    med, jax_med = outcome_median(outs), outcome_median(jax)
    report_outcome(f"reconstruct --detector dense, median over seeds 0-{DENSE_SEEDS - 1} (JAX: 0-7)", med, jax_med,
                   med["seconds"])
    learned_ka = json.loads((REPO / "assets" / "dense_descriptor_eval.json").read_text())["arc_sfm"]["learned_ka"]
    log(f"[reconstruct --detector dense] beside it: assets/dense_descriptor_eval.json's arc_sfm.learned_ka "
        f"{learned_ka['global_rot_med_deg']} deg (its own gate 0.92), and Harris + patches on this rig: phase 30's "
        f"median {harris['global_deg']:.3f} deg (mapper settings), JAX's reconstruct over seeds 0-6 "
        f"{harris['jax_cli_deg']:.3f} deg")
    check(med["registered"] >= jax_med["registered"] - 1, f"reconstruct --detector dense: {med['registered']} registered")
    check(med["global_deg"] <= jax_med["global_deg"] + DENSE_MARGIN_DEG,
          f"reconstruct --detector dense: global rotation {med['global_deg']:.3f} deg over JAX's "
          f"{jax_med['global_deg']:.3f} + {DENSE_MARGIN_DEG}")
    return {"median": med, "seeds": [o["global_deg"] for o in outs]}


def phase_cli_and_learned(device, work: Path, assets, harris_median: float) -> dict:
    """Phases 38-40, each timed; phase 40's mapper seeds run in the mapper
    workers while phases 38-39 run here."""
    ref = jax_reconstruct_reference()
    arc_dir = work / "arc_dense"
    arc_dir.mkdir()
    views, truth, _ = arc_rig(arc_dir)
    h, w = next(iter(views.values())).shape[:2]
    with worker_pool(MAPPER_WORKERS) as pool:
        jobs = [pool.submit(dense_mapper_job, views, cli_camera(h, w), truth, f"reconstruct --detector dense, seed {k}",
                            dict(max_keypoints=1024, nms_radius=1, seed=k)) for k in range(1, DENSE_SEEDS)]
        cli_out = timed_phase("phase 38, the command line", phase_command_line, device, work, assets)
        learned = timed_phase("phase 39, the learned SfM components", phase_learned, device, work, views)
        harris = {"global_deg": harris_median,
                  "jax_cli_deg": outcome_median([ref["cli" if k == 0 else f"cli{k}"] for k in range(CLI_SEEDS)])[
                      "global_deg"]}
        dense = timed_phase("phase 40, reconstruct --detector dense", phase_dense_reconstruct, arc_dir, views, truth,
                            jobs, harris)
    return {"cli": cli_out, "learned": learned, "dense": dense}


# ------------------------------------------------------------ phases 41-43 --
# Phase 41: offline tracking at batch (parallel/video.py), B videos of the
# mesh world's 20-frame orbit (frames 0-19 of phase 7's world) refined in
# lockstep, video b started from frame 0's true pose retracted by
# uniform(-1, 1, 6) * VIDEO_DELTA from np.random.default_rng(b) (the draw of
# tests/test_parallel_production.py), AlignConfig(num_iters=30), the fused
# loop's renders (96 coarse samples, no fine pass: K1 renders every video's
# reference in one launch a timestep) and the shipped UNet in bf16. The JAX
# package's make_production_video_tracker + track_video_batch over the same
# videos 0-7 on the CPU (scripts_dev/video_batch_jax.py, which also stores the
# initial poses used here) drifts: 2-3 successes of 20 a video, rotation
# medians 12.8-26.1 deg, its costs rising frame after frame (no gate, no
# relocalization, and all of the model's points observed from one rendered
# view, the far side's included). Each video at each B is held to JAX's run of
# the same video in three ways:
# - while the two trackers are in the same basin, the frames before JAX's
#   first miss (2-3 a video; success is phase 7's: a finite cost within 110 %
#   of the video's first-frame cost, at least cost_threshold_min): each
#   frame's pose within VIDEO_POSE_DEG of JAX's pose of that frame (the
#   issue's 0.5 deg), its cost within VIDEO_COST_REL of JAX's (ROADMAP's cost
#   tolerance for the synthetic world) and a success in the port too;
# - successes over the 20 frames >= JAX's less VIDEO_OK_SLACK, as PERF.md
#   §2's rule for the variants;
# - the rotation median over the 20 frames, a coarse drift bound: once
#   drifting, a video's median moves by degrees with the last bits of its
#   start. Measured: the port at B = 8 on the card (H100 80GB HBM3, 700 W)
#   from starts moved by k * 1e-6 along x (phase 7's perturbation), k = 0,
#   1, 2: video 1's median 18.56 / 17.55 / 26.21 deg, video 7's 17.51 /
#   20.45 / 17.64, every success count unchanged; JAX on the CPU at k = 0, 1
#   (scripts_dev/video_batch_jax.py 20 1): video 1's 26.09 / 18.61, video
#   7's 17.59 / 20.35. So each video's median is held to JAX's +
#   VIDEO_SPREAD_DEG, the larger of the two packages' spreads (max - min
#   over the starts, the largest over the videos: the port's 8.66 deg
#   against JAX's 7.48; phases 31-32 and 40 take their margins the same
#   way), and the median over the eight videos of their medians at B = 8,
#   which those starts move by 0.18 deg (the port) and 0.24 (JAX) at most,
#   to JAX's + VIDEO_MED_SLACK_DEG. A video's median is not held to JAX's
#   + 0.5 deg: video 0's, 0.56 deg over JAX's at k = 0, is 12.75 / 12.75 /
#   13.33 / 13.31 deg in JAX at k = 0-3 and 13.31 / 13.32 / 13.32 / 12.76
#   in the port on the card (scripts_dev/video_frame_split.py spread 20,
#   all eight videos, scripts_dev/video_split_card.json): both packages
#   land in both minima of its frame 8 (0.1297 and 0.1307, 1.6 deg apart),
#   picked by the last bits of the start and of the inputs; JAX's stored
#   run took the lower one. The phase prints video 0's per-frame gap to JAX
#   at B = 8, where the two tracks part.
VIDEO_JAX = REPO / "scripts_dev" / "video_batch_jax.npz"
# B = 2 and 4 and the k·1e-6 batch of video 0 (a spread of 0.064 deg) were
# cut for time; B = 8 holds every video to JAX's, B = 1 is the
# unbatched call and the batch-invariance check.
VIDEO_BS, VIDEO_FRAMES, VIDEO_ITERS = (1, 8), 20, 30
VIDEO_DELTA = np.array([0.01] * 3 + [0.015] * 3)
VIDEO_OK_SLACK, VIDEO_MED_SLACK_DEG, VIDEO_COST_MIN = 1, 0.5, 0.05
VIDEO_POSE_DEG, VIDEO_COST_REL = 0.5, 2e-3
VIDEO_SPREAD_DEG = 26.214 - 17.554  # the port's video 1 over k = 0, 1, 2 (JAX's video 1: 26.09 - 18.61)
# track-batch through the CLI over phases 21-24's object folder: 3 copies of
# phase 38's TRACK_FRAMES query frames, held to the same calls through the API
TRACK_BATCH_VIDEOS = 3
# Phase 42: the dense descriptor's recipe (scripts_dev/train_dense_descriptor_run.py:
# DescBankConfig's widths, 192 px, 192 keypoints, 10 views; DescTrainConfig's,
# 8 pairs a step, lr 3e-4) cut to DESC_SCENES training scenes (four banks of
# DESC_SCENES / 4 built side by side in the workers, seeds 500-503; the recipe's
# 120 scenes) and DESC_STEPS steps (its 4000); held-out InfoNCE on
# DESC_HOLDOUT_PAIRS pairs of a bank of two scenes at seed 900 (the recipe's
# val bank is seeds 9xx), no jitter. Then phase 39's deployment A/B with the
# trained net in place of the shipped one.
DESC_SCENES, DESC_STEPS, DESC_LOG_EVERY, DESC_HOLDOUT_PAIRS = 16, 600, 100, 32
# Phase 43: the matcher. The plane-pair trainer at MatcherTrainConfig's widths
# (160 px, 96 + 32 keypoints, batch 4) cut to PLANE_STEPS steps, held to the
# JAX test's gate (tests/test_attention_matcher.py:93-107); the bank trainer
# (scripts_dev/train_matcher_run.py's batch 8, lr 2e-4) on a mesh-pair bank of
# MBANK_SCENES scenes (build_mesh_pair_bank's widths, one scene a worker,
# seeds 1..MBANK_SCENES; the recipe's 40 scenes), BANK_STEPS steps on the
# host path at seeds 0-2 and on the device-resident path at seed 0 (chunks of
# BANK_CHUNK steps; all but the host path's seed 0 in the workers, their
# steps/s those of runs that share the card); the device path's held-out NLL must
# lie within the host path's spread (max - min over the seeds) of their
# median. Measured (H100 80GB HBM3, 700 W): at 300 steps host 9.2382,
# 8.9969, 9.2643, device 9.2381; at 150, host 9.2534, 9.2566, 9.2741, device
# 9.2531; untrained 9.59-10.48. Cut to 100 steps for time: the logged NLLs
# sit on the plateau from step 25.
PLANE_STEPS, PLANE_LOG_EVERY = 100, 10
MBANK_SCENES, BANK_STEPS, BANK_LOG_EVERY, BANK_CHUNK = 4, 100, 25, 10
# Phase 44: SuperPoint's two trainers at their recipes' widths. The MagicPoint
# trainer (scripts_dev/train_superpoint_run.py: SPTrainConfig, batch 8 + 8
# bank crops, 120 px, grid 3) on a texture label bank of SP_TEX_SCENES of its
# 32 scenes (6 views, 12 warps, 160 px); the dense trainer
# (scripts_dev/train_superpoint_dense_run.py: SPDenseConfig, batch 8, 160 px)
# on a dense pair bank of SP_DENSE_SCENES of its 24 mesh and 24 shape scenes
# (8 views, 10 warps); both cut to SP_STEPS of 3000 / 4000 steps. The banks
# are the recipes' first scenes, built in the workers (device "cpu") while
# phases 41-43 run. The reference (scripts_dev/superpoint_jax.npz, JAX on the
# CPU) holds repeatability's six scenes, JAX's two gates for the candidate
# weights and Harris, and a fixed held-out batch of each recipe with JAX's
# (detector, descriptor) terms at the candidate's weights and at JAX's
# init_superpoint(PRNGKey(0)). The candidate's and Harris's gates are held to
# JAX's: each mean within SP_REP_TOL, each pair's count within SP_COUNT_REL of
# JAX's; the candidate's terms on the held-out batches within SP_TERM_RTOL.
SP_STEPS, SP_LOG_EVERY = 300, 50
SP_TEX_SCENES, SP_DENSE_SCENES = 4, 4
SP_REP_TOL, SP_COUNT_REL, SP_TERM_RTOL = 0.02, 0.03, 1e-3
SP_JAX = REPO / "scripts_dev" / "superpoint_jax.npz"


def same_basin_gaps(out: dict, ref, B: int, n_frames: int = VIDEO_FRAMES) -> list:
    """Per video of a run at B over ``n_frames`` frames, over its frames
    before JAX's first miss: the largest rotation (deg) and relative cost gap
    to JAX's frame, and whether the port counts every one of those frames a
    success."""
    ok = video_success(out["cost"])
    gaps = []
    for b in range(B):
        miss = np.flatnonzero(~ref["success"][:n_frames, b])
        n = int(miss[0]) if miss.size else n_frames
        gaps.append({"frames": n,
                     "rot": max(rot_err_deg(out["R"][k, b], ref["R"][k, b]) for k in range(n)),
                     "cost": float(np.max(np.abs(out["cost"][:n, b] - ref["cost"][:n, b]) / ref["cost"][:n, b])),
                     "ok": bool(ok[:n, b].all())})
    return gaps


def video_success(cost: np.ndarray) -> np.ndarray:
    """Phase 7's success of each frame of (T, B) costs: finite, within 110 %
    of its video's first-frame cost or at most cost_threshold_min."""
    thresh = np.maximum(1.1 * cost[0], VIDEO_COST_MIN)
    return np.isfinite(cost) & (cost <= thresh[None])


def video_outcome(cost: np.ndarray, rot: np.ndarray):
    """(successes, rotation median) per video of (T, B) costs and rotation errors."""
    return video_success(cost).sum(0), np.median(rot, axis=0)


class StageEvents:
    """CUDA events around each named stage of a VideoStep (``stage_timer``)."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self.events.append((name, a, b))

    def split(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.events:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def video_k1_rays(run, R, t):
    """K1's inputs for the batched step's one reference launch at poses (B,)."""
    import torch

    from pixtrack_tpu_torch.geometry import Pose
    from pixtrack_tpu_torch.nerf.render import march_rays, rays_from_camera

    rays = [rays_from_camera(run.c2w_nerf_of(Pose(R[b], t[b])), *run._ref_f, *run._ref_c, run.rW, run.rH)
            for b in range(R.shape[0])]
    return march_rays(torch.cat([o for o, _ in rays]), torch.cat([d for _, d in rays]), run.aabb, None)


def phase_video_batch(device, assets) -> dict:
    """Phase 41: the batched tracker at B = 1, 2, 4, 8 against JAX's run of
    the same videos, its throughput and the B = 8 step's split, and K1 at the
    batched shape against its plain version."""
    import torch

    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.parallel import make_production_video_tracker, track_video_batch

    ref = np.load(VIDEO_JAX)
    jax_ok, jax_med = ref["successes"], ref["rot_median_deg"]
    tb = assets.testbed
    saved = tb.n_coarse, tb.n_fine
    tb.n_coarse, tb.n_fine = 96, 0
    run = make_production_video_tracker(tb, assets.n2s, assets.extractor, assets.scene, assets.camera,
                                        reference_scale=0.5, align_cfg=AlignConfig(num_iters=VIDEO_ITERS))
    video = torch.stack([torch.as_tensor(img, device=device) for _, img in assets.frames[:VIDEO_FRAMES]]).float() / 255.0
    gt_R = [T.R.cpu().numpy() for T in assets.gt[:VIDEO_FRAMES]]
    R0 = torch.as_tensor(ref["R0"], device=device)
    t0 = torch.as_tensor(ref["t0"], device=device)
    check(np.allclose(ref["R0"], np.stack([
        assets.gt[0].retract(torch.as_tensor(np.random.default_rng(b).uniform(-1, 1, 6) * VIDEO_DELTA,
                                             dtype=torch.float32)).R.cpu().numpy() for b in range(8)]), atol=1e-5),
          "video batch: the stored initial poses are not the draws of phase 41")

    outs, fps, k1_by_b, misses = {}, {}, {}, []
    fused_mlp.reset_launch_counts()
    for B in VIDEO_BS:
        videos = video[None].expand(B, *video.shape)
        k1_before = fused_mlp.launch_count(fused_mlp.K1)
        run(R0[:B], t0[:B], videos[:, 0])  # warm-up step
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = track_video_batch(run, R0[:B], t0[:B], videos)
        wall = time.perf_counter() - t_start
        k1_by_b[B] = fused_mlp.launch_count(fused_mlp.K1) - k1_before
        fps[B] = B * VIDEO_FRAMES / wall
        rot = np.asarray([[rot_err_deg(out["R"][k, b], gt_R[k]) for b in range(B)] for k in range(VIDEO_FRAMES)])
        ok, med = video_outcome(out["cost"], rot)
        outs[B] = dict(out, rot=rot, ok=ok, med=med)
        log(f"[video batch] B={B}: {fps[B]:.2f} frames/s ({B * VIDEO_FRAMES} frames in {wall:.2f} s after one "
            f"warm-up step); successes {ok.tolist()} (JAX {jax_ok[:B].tolist()}), rotation medians "
            f"{[round(float(m), 2) for m in med]} deg (JAX {[round(float(m), 2) for m in jax_med[:B]]}); LM "
            f"iterations a frame, mean {float(out['num_iters'].mean()):.1f} (JAX {float(ref['num_iters'][:, :B].mean()):.1f}); "
            f"K1 launches {k1_by_b[B]} over {VIDEO_FRAMES + 1} steps")
        check(k1_by_b[B] == VIDEO_FRAMES + 1, f"video batch B={B}: K1 launched {k1_by_b[B]} times")
        check(np.isfinite(out["cost"]).all(), f"video batch B={B}: non-finite cost")
        misses += [f"B={B}, video {b}: {ok[b]} successes at {med[b]:.2f} deg against JAX's {jax_ok[b]} at "
                   f"{jax_med[b]:.2f}" for b in range(B)
                   if not (ok[b] >= jax_ok[b] - VIDEO_OK_SLACK and med[b] <= jax_med[b] + VIDEO_SPREAD_DEG)]
        basin = same_basin_gaps(out, ref, B)
        log(f"[video batch] B={B}: the frames before JAX's first miss ({[g['frames'] for g in basin]} a video), "
            f"against JAX's: pose gaps {[round(g['rot'], 3) for g in basin]} deg (<= {VIDEO_POSE_DEG}), cost gaps "
            f"{[round(g['cost'], 6) for g in basin]} relative (<= {VIDEO_COST_REL:g}), each a success in the port "
            f"{[g['ok'] for g in basin]}")
        misses += [f"B={B}, video {b}, frames 0-{g['frames'] - 1}: {g['rot']:.3f} deg and {g['cost']:.1e} of the cost "
                   f"from JAX's, successes {g['ok']}" for b, g in enumerate(basin)
                   if not (g["rot"] <= VIDEO_POSE_DEG and g["cost"] <= VIDEO_COST_REL and g["ok"])]
    check(not misses, "video batch: " + "; ".join(misses))
    all_med, jax_all_med = float(np.median(outs[8]["med"])), float(np.median(jax_med))
    log(f"[video batch] B=8: the median over the videos of their rotation medians {all_med:.3f} deg (JAX "
        f"{jax_all_med:.3f}); each video's median held to JAX's + {VIDEO_SPREAD_DEG:.3f} deg, this one to JAX's + "
        f"{VIDEO_MED_SLACK_DEG}")
    check(all_med <= jax_all_med + VIDEO_MED_SLACK_DEG, f"video batch: the median over the videos {all_med:.3f} deg")
    gap0 = [rot_err_deg(outs[8]["R"][k, 0], ref["R"][k, 0]) for k in range(VIDEO_FRAMES)]
    log(f"[video batch] video 0 at B=8, each frame's rotation against JAX's (deg): {[round(g, 2) for g in gap0]}; "
        f"costs {[round(float(c), 4) for c in outs[8]['cost'][:, 0]]} (JAX {[round(float(c), 4) for c in ref['cost'][:, 0]]})")
    launches = fused_mlp.launch_count(fused_mlp.K1)
    gaps = {}
    for B in VIDEO_BS[:-1]:
        rot = [[rot_err_deg(outs[B]["R"][k, b], outs[8]["R"][k, b]) for b in range(B)] for k in range(VIDEO_FRAMES)]
        cost = np.abs(outs[B]["cost"] - outs[8]["cost"][:, :B]) / outs[8]["cost"][:, :B]
        gaps[B] = (max(rot[0]), float(cost[0].max()), float(np.max(rot)), float(cost.max()))
    log("[video batch] batch invariance, the same videos at B against B=8 (rotation by the arccos of the trace, "
        "~0.03 deg of f32 noise), frame 0 / the largest over the 20 frames: "
        + "; ".join(f"B={B}: {r0:.3f} / {r:.3f} deg, cost {c0:.2e} / {c:.2e} relative"
                    for B, (r0, c0, r, c) in gaps.items()))

    # one batched step's split at B = 8, CUDA events
    ev = StageEvents()
    run.stage_timer = ev
    torch.cuda.synchronize()
    with torch.no_grad():
        _, _, _, iters = run(R0, t0, video[None].expand(8, *video.shape)[:, 1])
    split = ev.split()
    run.stage_timer = None
    log(f"[video batch] one step at B=8, CUDA events (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f", total {sum(split.values()):.2f}; LM iterations {iters.tolist()} (the pyramid's, per video)")

    # K1 at the batched shape, against its plain version (phase 3's rules); these launches are not counted
    k1 = phase_k1({f"video_batch_8x{run.rW}x{run.rH}": (run.field, video_k1_rays(run, R0, t0), run.rcfg.n_coarse)},
                  device)[0]
    tb.n_coarse, tb.n_fine = saved
    return {"fps": fps, "split": split, "k1": k1, "launches": launches, "gaps": gaps}


def track_batch_job(work: str) -> dict:
    """Phase 41's ``track-batch`` through the CLI over phases 21-24's object
    folder (phase 38's query PNGs, TRACK_BATCH_VIDEOS copies), then the same
    calls through the API, in one worker process: the summary, the largest
    gap between their poses, the API's poses."""
    import pickle

    import torch

    from pixtrack_tpu_torch.parallel import make_production_video_tracker, track_video_batch
    from pixtrack_tpu_torch.pipelines import cli
    from pixtrack_tpu_torch.tracking.refiner import infer_camera_from_image
    from pixtrack_tpu_torch.utils.config import ObjectConfig, RunConfig
    from pixtrack_tpu_torch.utils.io import ImageIterator

    device, work = torch.device("cuda"), Path(work)
    query = work / "queries"
    out_dir = work / "track_batch_out"
    t0 = time.perf_counter()
    summary = json.loads(capture_cli(["track-batch", "--object_path", str(work), "--query",
                                      *[str(query)] * TRACK_BATCH_VIDEOS, "--out_dir", str(out_dir)]
                                     ).strip().splitlines()[-1])
    scene, tf, testbed = cli._object_assets(work, device, tighten=False)
    run_cfg = RunConfig()
    vids = [list(ImageIterator(query)) for _ in range(TRACK_BATCH_VIDEOS)]
    camera = infer_camera_from_image(vids[0][0][1], device=device)
    api_run = make_production_video_tracker(testbed, tf, run_cfg.make_extractor(device), scene, camera,
                                            reference_scale=run_cfg.reference_scale, align_cfg=run_cfg.align_config())
    batch = np.stack([np.stack([np.asarray(img, np.float32) / 255.0 for _, img in v]) for v in vids])
    T0 = scene.pose_w2c(scene.name2id[ObjectConfig().upright_ref_img or scene.names[0]])
    api = track_video_batch(api_run, np.tile(T0.R.numpy(), (TRACK_BATCH_VIDEOS, 1, 1)),
                            np.tile(T0.t.numpy(), (TRACK_BATCH_VIDEOS, 1)), batch)
    diff = 0.0
    for b, v in enumerate(vids):
        with open(out_dir / f"poses_{b:02d}.pkl", "rb") as f:
            poses = pickle.load(f)
        for k, (name, _) in enumerate(v):
            T = poses[str(name).split("/")[-1]]["T_refined"]
            diff = max(diff, float(np.abs(T[:3, :3] - api["R"][k, b]).max()), float(np.abs(T[:3, 3] - api["t"][k, b]).max()))
    return {"summary": summary, "diff": diff, "R": api["R"], "seconds": time.perf_counter() - t0}


def phase_track_batch(job, assets) -> dict:
    """Phase 41's ``track-batch`` (``track_batch_job``, run in a worker while
    phases 42-43 run here), held to the API to the bit."""
    out = job.result()
    summary, diff = out["summary"], out["diff"]
    rot = [rot_err_deg(out["R"][k, 0], assets.gt[k].R.cpu().numpy()) for k in range(out["R"].shape[0])]
    log(f"[track-batch] {summary}; poses against the same calls through the API: max |dT| {diff:.1e}; video 0's "
        f"rotation errors against the orbit (deg): {[round(r, 2) for r in rot]}; {out['seconds']:.1f} s in the worker "
        f"(the CLI and the API, each loading and baking the snapshot)")
    check(summary["n_videos"] == TRACK_BATCH_VIDEOS and summary["mesh"] == {"dp": 1, "tp": 1}, f"track-batch: {summary}")
    check(diff == 0.0, f"track-batch: the CLI's poses are {diff:.1e} from the API's")
    return {"summary": summary, "diff": diff}


def merge_banks(banks: list) -> dict:
    """Descriptor banks side by side: the pairs' view indices offset."""
    out, offset, pairs = {}, 0, []
    for b in banks:
        pairs.append(b["pairs"] + offset)
        offset += b["images"].shape[0]
    for k in banks[0]:
        out[k] = np.concatenate(pairs) if k == "pairs" else np.concatenate([b[k] for b in banks])
    return out


def descriptor_bank_job(workdir: str, n_scenes: int, seed: int) -> dict:
    from pixtrack_tpu_torch.mapping.dense_descriptor import DescBankConfig, build_descriptor_bank

    return build_descriptor_bank(workdir, DescBankConfig(n_scenes=n_scenes, seed=seed), device="cpu")


def matcher_bank_job(workdir: str, seed: int) -> dict:
    from pixtrack_tpu_torch.mapping.train_matcher import build_mesh_pair_bank

    return build_mesh_pair_bank(workdir, n_scenes=1, seed=seed, device="cpu")


def phase_descriptor_training(device, work: Path, banks, heldout, ab_patch: dict) -> dict:
    """Phase 42: the dense descriptor trained on the card at its recipe's
    widths, cut; held-out InfoNCE against the untrained net; phase 39's A/B
    with the trained net."""
    import torch

    from pixtrack_tpu_torch.mapping import dense_descriptor as dd
    from pixtrack_tpu_torch.mapping.detector import detect_and_describe
    from pixtrack_tpu_torch.mapping.train_matcher import build_mesh_pair_bank

    bank = merge_banks([b.result() for b in banks])
    held = heldout.result()
    cfg = dd.DescTrainConfig(n_steps=DESC_STEPS, log_every=DESC_LOG_EVERY)
    net = dd.init_descriptor(torch.Generator().manual_seed(cfg.seed), device=device)
    hb = dd.bank_tensors(held, device)
    idx = torch.arange(min(DESC_HOLDOUT_PAIRS, held["pairs"].shape[0]), device=device)

    def heldout_loss():
        with torch.no_grad():
            return float(sum(dd.infonce_loss(net, hb, idx[s:s + 8], cfg) * len(idx[s:s + 8])
                             for s in range(0, len(idx), 8)) / len(idx))

    before = heldout_loss()
    net, info = dd.train_descriptor(bank, cfg, net=net, device=device)
    after = heldout_loss()
    hist = [v for _, v in info["history"]]
    sps = cfg.n_steps / info["seconds"]
    log(f"[descriptor training] bank {bank['images'].shape[0]} views of {DESC_SCENES} scenes, {bank['pairs'].shape[0]} "
        f"pairs; {cfg.n_steps} steps at {sps:.2f} steps/s; logged InfoNCE {[round(v, 4) for v in hist]}; held-out "
        f"InfoNCE on {len(idx)} pairs of the seed-900 bank {before:.4f} untrained, {after:.4f} trained")
    check(all(np.isfinite(hist)), "descriptor training: a non-finite logged loss")
    check(hist[-1] < hist[0], f"descriptor training: the last logged loss {hist[-1]:.4f} >= the first {hist[0]:.4f}")
    check(after < before, f"descriptor training: held-out InfoNCE {after:.4f} >= the untrained net's {before:.4f}")

    def learned_detector(image, max_keypoints=256, **kw):
        kp_, sc_, _ = detect_and_describe(image, max_keypoints=max_keypoints, device=device, **kw)
        return kp_, sc_, dd.describe_at_dense(net, image, kp_.cpu().numpy())

    t0 = time.perf_counter()
    ab_bank = build_mesh_pair_bank(work / "ab" / "cut", detector=learned_detector, device=device, **AB)
    ab = bank_counts(ab_bank, *AB_MATCH["learned"])
    log(f"[descriptor A/B] the net trained here at {AB_MATCH['learned']}: correct {ab['correct']} of {ab['proposed']} "
        f"proposed (precision {ab['precision']:.4f}); the patch descriptor (phase 39) {ab_patch['correct']} of "
        f"{ab_patch['proposed']} ({ab_patch['precision']:.4f}); {time.perf_counter() - t0:.1f} s")
    check(ab["correct"] > ab_patch["correct"], f"descriptor A/B: {ab['correct']} correct <= patch {ab_patch['correct']}")
    check(ab["precision"] >= ab_patch["precision"] - 0.01,
          f"descriptor A/B: precision {ab['precision']:.4f} < patch {ab_patch['precision']:.4f} - 0.01")
    return {"steps_per_s": sps, "heldout": (before, after), "ab": ab}


def bank_trainer_run(bank: dict, seed: int, chunk: int, device) -> dict:
    """One run of the bank trainer at the recipe's batch and rate, seed
    ``seed``, on the host path (``chunk`` 0) or the device-resident one; its
    held-out NLL beside the untrained matcher's on the same split."""
    import dataclasses

    import torch

    from pixtrack_tpu_torch.mapping import train_matcher as tm
    from pixtrack_tpu_torch.mapping.attention_matcher import MatcherConfig, init_matcher

    mcfg = MatcherConfig(desc_dim=bank["desc0"].shape[-1])
    c = tm.MatcherTrainConfig(n_steps=BANK_STEPS, batch=8, lr=2e-4, log_every=BANK_LOG_EVERY, seed=seed)
    _, untrained = tm.train_matcher_on_bank(bank, dataclasses.replace(c, n_steps=0), mcfg,
                                            model=init_matcher(mcfg, torch.Generator().manual_seed(seed), device),
                                            device=device)
    model = init_matcher(mcfg, torch.Generator().manual_seed(seed), device)
    _, info = tm.train_matcher_on_bank(bank, c, mcfg, model=model, scan_chunk=chunk, device=device)
    return {"nll": info["holdout_nll"], "untrained": untrained["holdout_nll"], "sps": c.n_steps / info["seconds"],
            "hist": [v for _, v in info["history"]], "pairs": int(bank["gt"].shape[0])}


def bank_trainer_job(bank_path: str, seed: int, chunk: int) -> dict:
    """``bank_trainer_run`` in a worker process, the bank read from disk."""
    import torch

    with np.load(bank_path) as z:
        bank = {k: z[k] for k in z.files}
    return bank_trainer_run(bank, seed, chunk, torch.device("cuda"))


def phase_matcher_training(device, mbanks, pool, work: Path) -> dict:
    """Phase 43: the plane-pair trainer and both bank-trainer paths on the
    card; the host path's seeds 1-2 and the device-resident path in the
    workers while the host path's seed 0 runs here."""
    from pixtrack_tpu_torch.mapping import train_matcher as tm

    cfg = tm.MatcherTrainConfig(n_steps=PLANE_STEPS, log_every=PLANE_LOG_EVERY)
    _, info = tm.train_matcher(cfg, device=device)
    hist = [v for _, v in info["history"]]
    plane_sps = cfg.n_steps / info["seconds"]
    log(f"[matcher, plane pairs] {cfg.n_steps} steps at {plane_sps:.2f} steps/s (batch {cfg.batch}, {cfg.size} px, "
        f"{cfg.n_match} + {cfg.n_distract} keypoints); logged loss {[round(v, 4) for v in hist]}")
    check(all(np.isfinite(hist)), "matcher, plane pairs: a non-finite logged loss")
    check(min(hist[1:]) < hist[0], f"matcher, plane pairs: no logged loss after the first below it ({hist})")

    parts = [b.result() for b in mbanks]
    bank = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    bank_path = work / "mbank.npz"
    np.savez(bank_path, **bank)
    jobs = {("host", s): pool.submit(bank_trainer_job, str(bank_path), s, 0) for s in (1, 2)}
    jobs[("device", 0)] = pool.submit(bank_trainer_job, str(bank_path), 0, BANK_CHUNK)
    runs = {("host", 0): bank_trainer_run(bank, 0, 0, device)}
    runs.update({k: j.result() for k, j in jobs.items()})
    for (label, seed), r in sorted(runs.items()):
        where = " (here)" if (label, seed) == ("host", 0) else " (in a worker)"
        log(f"[matcher, bank, {label} path, seed {seed}] {r['pairs']} pairs of {MBANK_SCENES} scenes; {BANK_STEPS} "
            f"steps at {r['sps']:.2f} steps/s{where}; logged loss "
            f"{[round(v, 4) for v in r['hist']]}; held-out NLL {r['nll']:.4f} (untrained {r['untrained']:.4f})")
        check(np.isfinite(r["nll"]) and r["nll"] < r["untrained"],
              f"matcher, bank, {label} path, seed {seed}: held-out NLL {r['nll']:.4f} against {r['untrained']:.4f}")
    host = [runs[("host", s)]["nll"] for s in range(3)]
    spread, dev_nll = max(host) - min(host), runs[("device", 0)]["nll"]
    log(f"[matcher, bank] device-resident path's held-out NLL {dev_nll:.4f}; the host path's over seeds 0-2 "
        f"{[round(v, 4) for v in host]}, median {float(np.median(host)):.4f}, spread {spread:.4f}")
    check(abs(dev_nll - float(np.median(host))) <= spread,
          f"matcher, bank: the device path's held-out NLL {dev_nll:.4f} is not within the host path's spread")
    return {"plane_sps": plane_sps, "host_sps": runs[("host", 0)]["sps"], "device_sps": runs[("device", 0)]["sps"],
            "nll": {"host": host, "device": dev_nll}}


def texture_bank_job(n_scenes: int) -> tuple:
    """The MagicPoint recipe's texture label bank, its first ``n_scenes``
    scenes, on the worker's CPU; (bank, seconds)."""
    from pixtrack_tpu_torch.mapping.train_superpoint import build_texture_label_bank

    t0 = time.perf_counter()
    return build_texture_label_bank(n_scenes=n_scenes, device="cpu"), time.perf_counter() - t0


def dense_bank_job(workdir: str, n_scenes: int, n_shape_scenes: int) -> tuple:
    """The dense recipe's pair bank, its first mesh and shape scenes, on the
    worker's CPU; (bank, seconds)."""
    from pixtrack_tpu_torch.mapping.train_superpoint_dense import build_dense_pair_bank

    t0 = time.perf_counter()
    bank = build_dense_pair_bank(workdir, n_scenes=n_scenes, n_shape_scenes=n_shape_scenes, device="cpu")
    return bank, time.perf_counter() - t0


def sp_heldout(ref: dict, recipe: str, device) -> tuple:
    """A recipe's fixed held-out batch from the reference, on the card, in
    its trainer's batch layout."""
    import torch

    b = {k.split("/", 1)[1]: v for k, v in ref.items() if k.startswith(recipe + "/")}
    names = ("img0", "img1", "lab0", "lab1", "H") if recipe == "magic" else ("img0", "img1", "v0", "v1", "corr",
                                                                              "cvalid")
    out = []
    for k in names:
        v = b[k]
        v = v.astype(np.float32) if v.dtype == np.float16 else v.astype(np.int64) if v.dtype == np.uint8 else v
        out.append(torch.as_tensor(v, device=device))
    return tuple(out)


def sp_step_split(train, cfg, steps=3) -> dict:
    """CUDA events over the last of ``steps`` steps of a SuperPoint trainer,
    run through its own loop from its own start (``train(cfg, mark)``, the
    trainer's ``mark`` hook): the batch (its draws and synthesis or
    sampling), the forward of each view, the loss terms, backward, clip +
    Adam; and the host's wall time of the step. ms."""
    import dataclasses

    import torch

    events, wall = [], {}

    def mark(label):
        if label == "start":
            torch.cuda.synchronize()
            events.clear()
            wall["t0"] = time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((label, ev))
        if label == "clip + Adam":
            torch.cuda.synchronize()
            wall["ms"] = (time.perf_counter() - wall["t0"]) * 1e3

    train(dataclasses.replace(cfg, n_steps=steps), mark)
    return {"step (events)": events[0][1].elapsed_time(events[-1][1]),
            **{label: events[i - 1][1].elapsed_time(ev) for i, (label, ev) in enumerate(events) if i},
            "step (host wall)": wall["ms"]}


def sp_trainer_run(label: str, cfg, train, terms, held, device) -> dict:
    """One trainer at ``cfg`` on the card (``train(cfg, mark=None)``): its
    step split, the run, and the held-out batch's two terms for the
    untrained net (the trainer's own start, seeded ``cfg.seed``) and the
    trained one, each term gated apart."""
    import torch

    from pixtrack_tpu_torch.mapping.superpoint import init_superpoint
    from pixtrack_tpu_torch.mapping.train_superpoint import forward_views

    def held_terms(net):
        with torch.no_grad():
            return [float(x) for x in terms(cfg, held, *forward_views(net, held))]

    split = sp_step_split(train, cfg)
    before = held_terms(init_superpoint(torch.Generator().manual_seed(cfg.seed), device))
    net, info = train(cfg)
    after = held_terms(net)
    hist = [v for _, v in info["history"]]
    sps = cfg.n_steps / info["seconds"]
    log(f"[superpoint, {label}] one step at its widths (CUDA events, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    log(f"[superpoint, {label}] {cfg.n_steps} steps at {sps:.2f} steps/s ({info['seconds']:.1f} s); logged loss "
        f"{[(k, round(v, 4)) for k, v in info['history']]}; held-out (detector, descriptor) terms untrained "
        f"({before[0]:.4f}, {before[1]:.4f}), trained ({after[0]:.4f}, {after[1]:.4f})")
    check(all(np.isfinite(hist)), f"superpoint, {label}: a logged loss is not finite: {hist}")
    check(hist[-1] < hist[0], f"superpoint, {label}: the last logged loss {hist[-1]:.4f} >= the first {hist[0]:.4f}")
    for k, name in enumerate(("detector", "descriptor")):
        check(after[k] < before[k], f"superpoint, {label}: the held-out {name} term {after[k]:.4f} >= the untrained "
                                    f"net's {before[k]:.4f}")
    return {"net": net, "steps_per_s": sps, "split": split, "terms": (before, after)}


def phase_superpoint(device, tex_job, dense_jobs) -> dict:
    """Phase 44: both SuperPoint trainers on the card at their recipes'
    widths, steps cut; labels on the card against the CPU; both
    repeatability gates for the candidate weights and Harris held to JAX's,
    and for the untrained and the two trained nets."""
    import torch

    from pixtrack_tpu_torch.mapping import train_superpoint as ts
    from pixtrack_tpu_torch.mapping import train_superpoint_dense as td
    from pixtrack_tpu_torch.mapping.superpoint import init_superpoint, load_superpoint_weights

    with np.load(SP_JAX) as z:
        ref = {k: z[k] for k in z.files}
    tex, tex_s = tex_job.result()
    parts = [j.result() for j in dense_jobs]
    dense = merge_banks([b for b, _ in parts])
    log(f"[superpoint, banks] texture label bank: {tex['images'].shape[0]} views of {SP_TEX_SCENES} scenes, "
        f"{int(tex['valid'].sum())} labels, built in {tex_s:.1f} s; dense pair bank: {dense['images'].shape[0]} views, "
        f"{dense['pairs'].shape[0]} pairs of {SP_DENSE_SCENES} mesh + {SP_DENSE_SCENES} shape scenes, built in "
        + " + ".join(f"{t:.1f}" for _, t in parts) + " s (in the workers, side by side)")

    # labels: one bank batch's corners on the card, labelled there and on the CPU
    cfg = ts.SPTrainConfig(n_steps=SP_STEPS, log_every=SP_LOG_EVERY)
    bank_dev = ts.bank_tensors(tex, device)
    d = ts.bank_draws(cfg, *bank_dev["images"].shape[:2], (cfg.bank_batch,),
                      torch.Generator(device=device).manual_seed(5), device)
    kp, kv = ts.bank_corners(cfg, bank_dev, d)
    H = ts.random_homography(d["homography"], cfg.size, cfg.max_warp)
    shared = 0
    for corners in (kp, ts.apply_homography(H, kp)):
        card = ts.cell_labels(corners, kv, cfg.size).cpu()
        cpu = ts.cell_labels(corners.cpu(), kv.cpu(), cfg.size)
        check(torch.equal(card, cpu), f"superpoint: cell labels on the card differ from the CPU's in "
                                      f"{int((card != cpu).sum())} cells")
        xi, yi = torch.round(corners.cpu()).long().unbind(-1)
        inb = kv.cpu() & (xi >= 0) & (xi < cfg.size) & (yi >= 0) & (yi < cfg.size)
        cell = ((yi // 8) * (cfg.size // 8) + xi // 8)[inb]
        per = torch.bincount(cell + inb.nonzero()[:, 0] * (cfg.size // 8) ** 2)
        shared += int((per > 1).sum())
    log(f"[superpoint, labels] {cfg.bank_batch} bank crops and their warps: labels on the card equal to the CPU's in "
        f"every cell; {shared} cells hold more than one corner")
    check(shared > 0, "superpoint: no cell of the label check holds two corners")

    magic = sp_trainer_run(
        "MagicPoint", cfg, lambda c, mark=None: ts.train_superpoint(c, bank=tex, device=device, mark=mark),
        ts.loss_terms, sp_heldout(ref, "magic", device), device)
    dcfg = td.SPDenseConfig(n_steps=SP_STEPS, log_every=SP_LOG_EVERY)
    dense_run = sp_trainer_run(
        "dense", dcfg, lambda c, mark=None: td.train_superpoint_dense(c, dense, device=device, mark=mark),
        td.dense_loss_terms, sp_heldout(ref, "dense", device), device)

    cand = load_superpoint_weights(REPO / "assets" / "superpoint_candidate.npz", device=device)
    for recipe, c, terms in (("magic", cfg, ts.loss_terms), ("dense", dcfg, td.dense_loss_terms)):
        held = sp_heldout(ref, recipe, device)
        with torch.no_grad():
            got = [float(x) for x in terms(c, held, *ts.forward_views(cand, held))]
        want, jinit = ref[f"{recipe}/candidate"], ref[f"{recipe}/init"]
        log(f"[superpoint, {recipe} held-out batch] the candidate's (detector, descriptor) terms ({got[0]:.6f}, "
            f"{got[1]:.6f}), JAX on the CPU ({want[0]:.6f}, {want[1]:.6f}); JAX's init_superpoint(PRNGKey(0)) "
            f"({jinit[0]:.4f}, {jinit[1]:.4f})")
        check(np.allclose(got, want, rtol=SP_TERM_RTOL, atol=0),
              f"superpoint: the candidate's {recipe} terms {got} against JAX's {list(want)}")

    rep_draws = {"scene": {k.rsplit("/", 1)[1]: v for k, v in ref.items() if k.startswith("rep/scene/")},
                 "homography": ref["rep/homography"]}
    nets = {"candidate": cand, "harris": None,
            "untrained": init_superpoint(torch.Generator().manual_seed(0), device),
            "MagicPoint (here)": magic["net"], "dense (here)": dense_run["net"]}
    gates = {}
    for name, net in nets.items():
        det = "harris" if net is None else "superpoint"
        t0 = time.perf_counter()
        rep, counts = ts.repeatability(net, detector=det, draws=rep_draws, device=device)
        mrep, mcounts = ts.mesh_repeatability(net, detector=det, device=device)
        gates[name] = {"rep": rep, "counts": counts, "mesh": mrep, "mesh_counts": mcounts}
        jax_ref = ""
        if name in ("candidate", "harris"):
            key = "superpoint" if name == "candidate" else "harris"
            jr, jc = float(ref[f"rep_{key}"]), ref[f"rep_{key}_counts"].tolist()
            jm, jmc = float(ref[f"mesh_{key}"]), ref[f"mesh_{key}_counts"].tolist()
            jax_ref = f" (JAX on the CPU {jr:.4f} {jc}; mesh {jm:.4f} {jmc})"
            for what, a, b, ca, cb in (("repeatability", rep, jr, counts, jc), ("mesh", mrep, jm, mcounts, jmc)):
                check(abs(a - b) <= SP_REP_TOL, f"superpoint, {name}: {what} {a:.4f} against JAX's {b:.4f}")
                check(len(ca) == len(cb) and all(abs(x - y) <= SP_COUNT_REL * y for x, y in zip(ca, cb)),
                      f"superpoint, {name}: {what} counts {ca} against JAX's {cb}")
        log(f"[superpoint, gates] {name}: repeatability {rep:.4f} {counts}; mesh repeatability {mrep:.4f} "
            f"{mcounts}{jax_ref}; {time.perf_counter() - t0:.1f} s")
    return {"magic_sps": magic["steps_per_s"], "dense_sps": dense_run["steps_per_s"], "gates": gates}


def phase_batch_and_trainers(device, work: Path, assets, ab_patch: dict) -> dict:
    """Phases 41-44, each timed. The trainers' banks are built in the workers
    (on their CPU) while phase 41 runs here; ``track-batch`` and three of
    the bank trainer's four runs run in the workers while phases 42-43 run
    here (the steps/s printed are then those of runs that share the card and
    the host)."""
    with worker_pool(MAPPER_WORKERS) as pool:
        per = DESC_SCENES // 4
        desc = [pool.submit(descriptor_bank_job, str(work / "descbank" / str(k)), per, 500 + k) for k in range(4)]
        held = pool.submit(descriptor_bank_job, str(work / "descbank" / "held"), 2, 900)
        mbanks = [pool.submit(matcher_bank_job, str(work / "mbank" / str(s)), s) for s in range(1, MBANK_SCENES + 1)]
        tex = pool.submit(texture_bank_job, SP_TEX_SCENES)
        dense = [pool.submit(dense_bank_job, str(work / "spbank" / "mesh"), SP_DENSE_SCENES, 0),
                 pool.submit(dense_bank_job, str(work / "spbank" / "shape"), 0, SP_DENSE_SCENES)]
        video = timed_phase("phase 41, the video batch", phase_video_batch, device, assets)
        track_batch = pool.submit(track_batch_job, str(work))
        descriptor = timed_phase("phase 42, the dense descriptor trained", phase_descriptor_training, device, work, desc,
                                 held, ab_patch)
        matcher = timed_phase("phase 43, the matcher trained", phase_matcher_training, device, mbanks, pool, work)
        superpoint = timed_phase("phase 44, SuperPoint trained", phase_superpoint, device, tex, dense)
        video["track_batch"] = timed_phase("phase 41, track-batch", phase_track_batch, track_batch, assets)
    return {"video": video, "descriptor": descriptor, "matcher": matcher, "superpoint": superpoint}


# ---------------------------------------------------------------- phase 45 --
# Scale-out over several cards (parallel/mesh.py, parallel/video.py), one
# process a card.
# (a) The production path at this machine's world: NCCL over
#     torch.cuda.device_count() ranks (one rank, in this process, on a
#     one-card machine). One sharded step of the hash-grid NeRF at full width
#     (NGPField defaults) from init_field(1) on phase 17's capture with phase
#     18's first batch (4096 rays x 48 + 16 samples), held to the one-process
#     step on the card: the loss within SCALE_LOSS_REL relative, each
#     gradient (Adam's first moment / (1 - b1)) within SCALE_GRAD_REL of its
#     leaf's largest entry; the sharded step's steps/s over SCALE_TIMED_STEPS
#     more steps. Then track-batch --devices 0 through the CLI over phase
#     41's object folder and queries, held to phase 41's track-batch to the bit.
# (b) A test harness, never the production path: two ranks sharing the one
#     card, over a gloo group built explicitly over CUDA tensors (NCCL refuses
#     two ranks on one device, and a one-card machine has no second card). The
#     step at (dp, tp) = (2, 1) and (1, 2) against the one-process step at
#     (a)'s tolerances; SCALE_TRAIN_STEPS steps of train(mesh=(1, 2)) at
#     phase 18's recipe, every step logged, each logged loss within
#     SCALE_LOSS_REL of the one-process train()'s on the same steps (run
#     here), and the last below the first; videos 0-3 of phase 41 over its
#     first SCALE_FRAMES frames, 2 a rank, each held to JAX's stored run by
#     phase 41's per-frame gates, K1 counted in each rank.
#     Phase 18's own gate (the loss halves) does not fit 30 steps: the
#     recipe's schedule decays the rate 100-fold over n_steps, and the
#     one-process trainer's loss over these 30 steps goes 0.0667 -> 0.0433
#     (measured, H100 80GB HBM3, 700 W; it is the same in every run, and the
#     mesh run's within 8.5e-8 of it); with a 300-step schedule it halves by
#     step 40.
SCALE_LOSS_REL, SCALE_GRAD_REL = 1e-5, 5e-5
SCALE_TRAIN_STEPS, SCALE_TIMED_STEPS, SCALE_FRAMES, SCALE_VIDEOS = 30, 10, 10, 4
SCALE_BATCH, SCALE_COARSE, SCALE_FINE = 4096, 48, 16  # phase 18's recipe


def scale_train_cfg():
    """(b)'s training run: phase 18's recipe over SCALE_TRAIN_STEPS steps,
    every step logged."""
    from pixtrack_tpu_torch.nerf.train import TrainConfig

    return TrainConfig(n_steps=SCALE_TRAIN_STEPS, batch_rays=SCALE_BATCH, n_coarse=SCALE_COARSE,
                       n_fine=SCALE_FINE, log_every=1)


def scale_pool(ds, device):
    """Phase 18's ray pool of the capture on ``device``."""
    from pixtrack_tpu_torch.nerf.train import TrainConfig, ray_pool

    cfg = TrainConfig()
    return ray_pool(ds, cfg.ray_pool_cap, cfg.background, 0, device)


def scale_batch(pool, device):
    """Phase 18's first batch (the first draw of a generator seeded 0 on the
    device) and that generator, whose next draws are the render's noise."""
    import torch

    from pixtrack_tpu_torch.nerf.train import batch_indices

    gen = torch.Generator(device=device).manual_seed(0)
    idx = batch_indices(gen, pool[0].shape[0], SCALE_BATCH)
    return tuple(p[idx] for p in pool), gen


def scale_grads(field, opt, mesh=None) -> dict:
    """The last step's gradient of each parameter, read as Adam's first
    moment / (1 - b1); a sharded table's gathered over tp."""
    from pixtrack_tpu_torch.parallel.mesh import gather_over_tp

    out = {}
    for (name, _), m in zip(field.named_parameters(), opt.mu):
        g = m / (1.0 - opt.b1)
        out[name] = gather_over_tp(g, field, mesh) if mesh is not None and name == "encoding.tables" else g
    return out


def grad_gaps(grads: dict, ref: dict) -> dict:
    """Each leaf's largest gap over its largest entry in ``ref``."""
    return {k: float((grads[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)) for k, v in ref.items()}


def scale_one_process(pool, aabb, device):
    """The one-process step on the card (nerf/train.py's loss, Adam at the
    sharded step's default rate) from init_field(1): (loss, gradients)."""
    from pixtrack_tpu_torch.nerf.field import init_field
    from pixtrack_tpu_torch.nerf.optim import Adam
    from pixtrack_tpu_torch.nerf.train import TrainConfig, make_loss_fn

    field = init_field(1, device=device)
    opt = Adam(field.parameters(), lambda k: 1e-2, b1=0.9, b2=0.99, eps=1e-15)
    (o, d, rgb), gen = scale_batch(pool, device)
    cfg = TrainConfig(batch_rays=SCALE_BATCH, n_coarse=SCALE_COARSE, n_fine=SCALE_FINE)
    loss = make_loss_fn(field, cfg, aabb)(o, d, rgb, gen)
    loss.backward()
    opt.step()
    return float(loss.detach()), scale_grads(field, opt)


def scale_sharded(pool, aabb, mesh, timed: int = 0):
    """One sharded step over ``mesh`` from init_field(1) on phase 18's first
    batch, then ``timed`` more steps on the generator's next batches, timed:
    (the first step's loss, its gradients, steps/s or None)."""
    import torch

    from pixtrack_tpu_torch.nerf.field import init_field
    from pixtrack_tpu_torch.nerf.train import batch_indices
    from pixtrack_tpu_torch.parallel import sharded_nerf_train_step

    field = init_field(1, device=mesh.device)
    step, opt = sharded_nerf_train_step(field, mesh, aabb, n_coarse=SCALE_COARSE, n_fine=SCALE_FINE)
    (o, d, rgb), gen = scale_batch(pool, mesh.device)
    loss = float(step(o, d, rgb, gen))
    grads = scale_grads(field, opt, mesh)
    sps = None
    if timed:
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        for _ in range(timed):
            idx = batch_indices(gen, pool[0].shape[0], SCALE_BATCH)
            last = step(pool[0][idx], pool[1][idx], pool[2][idx], gen)
        float(last)
        sps = timed / (time.perf_counter() - t0)
    return loss, grads, sps


def scale_nccl_rank(ds, aabb, world: int) -> dict:
    """Phase 45 (a) in one rank of the production layout (NCCL, rank r on
    cuda:r, dp = world): the sharded step against the one-process step (rank
    0), and its steps/s."""
    import torch

    from pixtrack_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(world, 1, "cuda")
    pool = scale_pool(ds, mesh.device)
    ref = scale_one_process(pool, aabb, mesh.device) if mesh.rank == 0 else None
    loss, grads, sps = scale_sharded(pool, aabb, mesh, timed=SCALE_TIMED_STEPS)
    out = {"world": mesh.world, "backend": mesh.backend, "loss": loss, "sps": sps}
    if ref is not None:
        out.update(ref_loss=ref[0], gaps=grad_gaps(grads, ref[1]))
    return out


def scale_harness_rank(ds, aabb, frames, R0, t0) -> dict:
    """Phase 45 (b) in one of two ranks sharing cuda:0 over gloo (the test
    harness): the steps at (2, 1) and (1, 2) against the one-process step
    (rank 0), train(mesh=(1, 2)), and this rank's share of the videos."""
    import os

    import torch
    import torch.distributed as dist

    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf.train import train
    from pixtrack_tpu_torch.parallel import make_mesh, make_production_video_tracker, track_video_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, rank = torch.device("cuda:0"), int(os.environ["RANK"])
    t_start = time.perf_counter()
    pool = scale_pool(ds, dev)
    ref = scale_one_process(pool, aabb, dev) if rank == 0 else None
    steps = {}
    for tp in (1, 2):
        mesh = make_mesh(2, tp, "cuda", shared_device=dev)
        loss, grads, _ = scale_sharded(pool, aabb, mesh)
        if ref is not None:
            steps[mesh.dp, mesh.tp] = {"loss": loss, "gaps": grad_gaps(grads, ref[1])}
        del grads
    del pool
    t_steps = time.perf_counter()
    _, info = train(ds, aabb, scale_train_cfg(), seed=0, mesh=make_mesh(2, 2, "cuda", shared_device=dev))
    t_train = time.perf_counter()

    mesh = make_mesh(2, 1, "cuda", shared_device=dev)
    a = mesh_assets(dev, n_frames=0)
    a.testbed.n_coarse, a.testbed.n_fine = 96, 0
    run = make_production_video_tracker(a.testbed, a.n2s, a.extractor, a.scene, a.camera, reference_scale=0.5,
                                        align_cfg=AlignConfig(num_iters=VIDEO_ITERS))
    video = torch.as_tensor(frames, device=dev).float() / 255.0
    videos = video[None].expand(len(R0), *video.shape)
    per = len(R0) // mesh.dp
    mine = slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)
    R0t, t0t = torch.as_tensor(R0, device=dev), torch.as_tensor(t0, device=dev)
    run(R0t[mine], t0t[mine], videos[mine, 0])  # warm-up step
    torch.cuda.synchronize(dev)
    fused_mlp.reset_launch_counts()
    t_video = time.perf_counter()
    out = track_video_batch(run, R0, t0, videos, mesh=mesh)
    wall = time.perf_counter() - t_video
    k1 = fused_mlp.launch_count(fused_mlp.K1)
    # this rank's K1 launches and frames/s, to rank 0 (CPU tensors over the gloo group)
    stats = torch.zeros(2, 2)
    stats[mesh.rank] = torch.tensor([float(k1), per * video.shape[0] / wall])
    dist.all_reduce(stats)
    return {"steps": steps, "history": info["history"], "train_sps": SCALE_TRAIN_STEPS / info["seconds"],
            "video": out, "k1": stats[:, 0].tolist(), "fps": stats[:, 1].tolist(), "backend": mesh.backend,
            "seconds": {"start and steps": t_steps - t_start, "train": t_train - t_steps,
                        "videos": time.perf_counter() - t_train}}


def in_background(fn):
    """Run ``fn()`` in a thread; call the returned function for its result
    (or its error)."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # raised by result()
            box["err"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return result


def phase_scaleout(device, work: Path, cap, assets, smi: str) -> dict:
    """Phase 45: (a) and (b) above; (b)'s ranks start in the background
    while (a) runs here."""
    import pickle

    import torch
    import torch.distributed as dist

    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf.train import train
    from pixtrack_tpu_torch.parallel.mesh import launch

    t_phase = time.perf_counter()
    ref = np.load(VIDEO_JAX)
    frames = np.stack([img for _, img in assets.frames[:SCALE_FRAMES]])
    R0, t0 = ref["R0"][:SCALE_VIDEOS], ref["t0"][:SCALE_VIDEOS]
    harness = in_background(lambda: launch(scale_harness_rank, 2, cap.ds, cap.aabb, frames, R0, t0, threads=2,
                                           join_timeout=600.0))

    world = torch.cuda.device_count()
    if world == 1:
        try:
            a = scale_nccl_rank(cap.ds, cap.aabb, 1)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    else:
        a = launch(scale_nccl_rank, world, cap.ds, cap.aabb, world, join_timeout=600.0)
    worst = max(a["gaps"].values())
    log(f"[scale-out (a)] {smi}: production layout, world {a['world']} over {a['backend']} (one rank a card; "
        f"this machine has {world}): one sharded step at full width, phase 18's batch, loss {a['loss']:.7f} "
        f"against the one-process step's {a['ref_loss']:.7f} ({abs(a['loss'] - a['ref_loss']) / a['ref_loss']:.1e} "
        f"relative); gradients' largest gap {worst:.1e} of the leaf's largest entry ("
        + ", ".join(f"{k} {v:.1e}" for k, v in a["gaps"].items()) + f"); {a['sps']:.2f} steps/s "
        f"over {SCALE_TIMED_STEPS} steps")
    check(a["backend"] == "nccl" and a["world"] == world, f"scale-out (a): {a['backend']} over {a['world']} ranks")
    check(abs(a["loss"] - a["ref_loss"]) <= SCALE_LOSS_REL * abs(a["ref_loss"]) and worst <= SCALE_GRAD_REL,
          f"scale-out (a): loss {a['loss']} against {a['ref_loss']}, gradient gaps {a['gaps']}")

    # the one-process train() over (b)'s 30 steps, (b)'s reference
    _, one = train(cap.ds, cap.aabb, scale_train_cfg(), seed=0, device=device)
    one = [v for _, v in one["history"]]

    # track-batch --devices 0 (every visible card) through the CLI, held to phase 41's track-batch
    fused_mlp.reset_launch_counts()
    t_cli = time.perf_counter()
    out_dir = work / "track_batch_devices0"
    summary = json.loads(capture_cli(["track-batch", "--object_path", str(work), "--query",
                                      *[str(work / "queries")] * TRACK_BATCH_VIDEOS, "--out_dir", str(out_dir),
                                      "--devices", "0"]).strip().splitlines()[-1])
    t_cli = time.perf_counter() - t_cli
    cli_k1 = fused_mlp.launch_count(fused_mlp.K1)
    diff = 0.0
    for v in range(TRACK_BATCH_VIDEOS):
        with open(out_dir / f"poses_{v:02d}.pkl", "rb") as f, \
                open(work / "track_batch_out" / f"poses_{v:02d}.pkl", "rb") as g:
            mine, theirs = pickle.load(f), pickle.load(g)
        check(sorted(mine) == sorted(theirs), "scale-out (a): track-batch --devices 0 wrote other frames")
        diff = max([diff] + [float(np.abs(mine[n]["T_refined"] - theirs[n]["T_refined"]).max()) for n in mine])
    log(f"[scale-out (a)] track-batch --devices 0: {summary}, {t_cli:.1f} s; poses against phase 41's track-batch: "
        f"max |dT| {diff:.1e}; K1 launches {cli_k1} (the baked hash field renders plain)")
    check(summary["mesh"] == {"dp": world, "tp": 1} and diff == 0.0,
          f"scale-out (a): track-batch --devices 0: {summary}, {diff:.1e} from phase 41's")

    b = harness()
    log(f"[scale-out (b)] {smi}: TEST HARNESS, not the production path: 2 ranks sharing cuda:0 over an explicitly "
        f"built {b['backend']} group over CUDA tensors (NCCL refuses two ranks on one device; this machine has "
        f"{world} card(s)); rank time split (s): " + ", ".join(f"{k} {v:.1f}" for k, v in b["seconds"].items()))
    misses = []
    for layout, r in b["steps"].items():
        gap = max(r["gaps"].values())
        rel = abs(r["loss"] - a["ref_loss"]) / a["ref_loss"]
        log(f"[scale-out (b)] (dp, tp) = {layout}: loss {r['loss']:.7f} ({rel:.1e} from the one-process step's), "
            f"gradients' largest gap {gap:.1e} of the leaf's largest entry")
        if not (rel <= SCALE_LOSS_REL and gap <= SCALE_GRAD_REL):
            misses.append(f"step at {layout}: loss {rel:.1e}, gradients {gap:.1e}")
    hist = [v for _, v in b["history"]]
    train_gaps = [abs(h - o) / o for h, o in zip(hist, one)]
    log(f"[scale-out (b)] train(mesh=(1, 2)) {SCALE_TRAIN_STEPS} steps at {b['train_sps']:.2f} steps/s (2 ranks on "
        f"one card): loss {[round(v, 5) for v in hist]}; against the one-process train() on the same steps: largest "
        f"gap {max(train_gaps):.1e} relative (<= {SCALE_LOSS_REL:g}); first -> last {hist[0]:.5f} -> {hist[-1]:.5f} "
        f"(one process {one[0]:.5f} -> {one[-1]:.5f}; the rate decays 100-fold over the 30 steps)")
    if not (all(np.isfinite(hist)) and len(hist) == len(one) == SCALE_TRAIN_STEPS
            and max(train_gaps) <= SCALE_LOSS_REL and hist[-1] < hist[0]):
        misses.append(f"train(mesh=(1, 2)): loss {hist[0]} -> {hist[-1]}, {max(train_gaps):.1e} from the one-process "
                      f"run")
    out = b["video"]
    gaps = same_basin_gaps(out, ref, SCALE_VIDEOS, n_frames=SCALE_FRAMES)
    ok = video_success(out["cost"]).sum(0)
    log(f"[scale-out (b)] videos 0-{SCALE_VIDEOS - 1} of phase 41, {SCALE_FRAMES} frames, "
        f"{SCALE_VIDEOS // 2} a rank: K1 launches per rank {[int(k) for k in b['k1']]}, frames/s per rank "
        f"{[round(f, 2) for f in b['fps']]}; successes {ok.tolist()}; the frames before JAX's first miss "
        f"({[g['frames'] for g in gaps]} a video) against JAX's: pose gaps {[round(g['rot'], 3) for g in gaps]} "
        f"deg (<= {VIDEO_POSE_DEG}), cost gaps {[round(g['cost'], 6) for g in gaps]} relative "
        f"(<= {VIDEO_COST_REL:g}), each a success {[g['ok'] for g in gaps]}")
    misses += [f"video {v}: {g}" for v, g in enumerate(gaps)
               if not (g["rot"] <= VIDEO_POSE_DEG and g["cost"] <= VIDEO_COST_REL and g["ok"])]
    if not (out["R"].shape == (SCALE_FRAMES, SCALE_VIDEOS, 3, 3) and np.isfinite(out["cost"]).all()):
        misses.append(f"videos: shape {out['R'].shape}, finite {np.isfinite(out['cost']).all()}")
    if [int(k) for k in b["k1"]] != [SCALE_FRAMES] * 2:
        misses.append(f"K1 launched {b['k1']} times per rank")
    check(not misses, "scale-out (b): " + "; ".join(misses))
    wall = time.perf_counter() - t_phase
    return {"k1": int(sum(b["k1"])) + cli_k1, "a": a, "b": b, "seconds": wall}


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
        # one ptxas entry per instantiation (8 and 10 octaves, and K1's first pass)
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", info["log"])]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", info["log"])]
        stack = [int(n) for n in re.findall(r"(\d+) bytes stack frame", info["log"])]
        log(f"[build] {name}.cu: nvcc {info['seconds']:.2f} s; ptxas over {len(regs)} kernels: registers "
            f"{sorted(set(regs))}, spill bytes {sum(spills)}, stack frame {max(stack, default=0)} bytes; "
            f"warnings {sum('arning' in ln for ln in info['log'].splitlines())}")
        check(sum(spills) == 0, f"{name}.cu spills registers: {info['log']}")
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
    k1 = timed_phase("phase 3, K1 against its plain version", phase_k1, k1_sets, device)

    # phase 4: K2 against its plain version at the staged render's shapes
    k2 = timed_phase("phase 4, K2 against its plain version", phase_k2, device, meta["aabb"])

    # phase 5: the staged render of the mesh view through K2 and through plain
    timed_phase("phase 5, the staged render", phase_staged, device, mesh_field, m_box, c2w_m)

    # phases 6-7: the fused main path, counted
    fused_mlp.reset_launch_counts()
    blob = timed_phase("phase 6, the blob world", phase_blob, device)
    tracker, queries, mesh, assets = timed_phase("phase 7, the mesh world's fused loop", phase_mesh, device)
    fused_launches = {k: fused_mlp.launch_count(k) for k in (fused_mlp.K1, fused_mlp.K2)}

    # phase 8: per-stage times of one steady fused frame
    timed_phase("phase 8, the fused frame's stages", phase_stages, tracker, queries, device)

    # phase 9: the stepwise reference-exact path, each run counted on its own
    timed_phase("phase 9, stepwise, UNet f32", phase_stepwise, device, torch.float32)
    step_tracker, step_frames, step_gt, step_launches = timed_phase(
        "phase 9, stepwise, UNet bf16", phase_stepwise, device, torch.bfloat16)

    # phase 10: per-stage times of one steady stepwise frame
    timed_phase("phase 10, the stepwise frame's stages", phase_stepwise_stages, step_tracker, step_frames, step_gt)

    # phase 11: each path went through its kernel
    log(f"[launches] phases 6-7 (fused frames): K1 {fused_launches[fused_mlp.K1]}, "
        f"K2 {fused_launches[fused_mlp.K2]}; phase 9 (stepwise, UNet bf16): K1 {step_launches[fused_mlp.K1]}, "
        f"K2 {step_launches[fused_mlp.K2]}")
    check(fused_launches[fused_mlp.K1] > 0, "K1 was never launched on the fused main path")

    # phase 12: jittered renders, every sample through K2 (counted inside)
    jitter_launches = timed_phase("phase 12, jittered renders", phase_jittered, device, assets)

    # phases 13-15: the lineage and the YCB protocol, each run counted on its own
    variant_launches = {name: timed_phase(f"phases 13-15, {name}", phase_variant, device, assets, name)
                        for name in ("r6", "r7", "r3", "ycb")}

    # phase 16: the optimizer trace
    timed_phase("phase 16, the optimizer trace", phase_debug_trace, device, assets)

    # phases 17-20: the asset path, the student's renders counted
    asset_launches, student_k1_err, student_staged_err, _, _, cap, _, _ = phase_assets(device)

    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sfm_") as tmp:
        # phases 21-33: the SfM model rebuilt through the asset subcommands, refined, tracked; then
        # reconstructed without poses and tracked
        nerf_sfm_launches, rebuilt, rebuilt_k1, refined, unposed = phase_rebuild(device, Path(tmp))

        # phases 34-37: the UNet trained on the card, benchmarked, and tracked with (K1 counted)
        unet = phase_unet_training(device)

        # phases 38-40: the rest of the command line over phases 21-24's object folder, the learned SfM
        # components, and reconstruct --detector dense (no kernel on these paths)
        later = phase_cli_and_learned(device, Path(tmp), assets, unposed["arc_median"]["global_deg"])

        # phases 41-44: the video batch over the mesh world (K1 counted) and track-batch over phases 21-24's
        # object folder; the dense descriptor, the matcher and SuperPoint trained on the card (no kernel)
        batch = phase_batch_and_trainers(device, Path(tmp), assets, later["learned"]["ab"]["patch"])

        # phase 45: scale-out, NCCL at this machine's world and two ranks sharing the card over gloo (the
        # harness), K1 counted in each rank
        scale = timed_phase("phase 45, scale-out", phase_scaleout, device, Path(tmp), cap, assets, smi)
    log("[launches] phase 12 (jittered renders, spp=4): K2 "
        + ", ".join(f"{n} at {w}x{h}" for (w, h), n in jitter_launches.items()) + "; phases 13-15 (K1, K2): "
        + ", ".join(f"{name} {n[fused_mlp.K1]}, {n[fused_mlp.K2]}" for name, n in variant_launches.items()))

    main_shape = k1[0]
    log(json.dumps({"kernels": [
        {
            "name": "fused_march_render",
            "route": "cuda",
            "source": "pixtrack_tpu_torch/csrc/march_render.cu",
            "replaces": "pixtrack_tpu/nerf/fused_mlp.py:300",
            "launches": fused_launches[fused_mlp.K1] + unet["k1"] + batch["video"]["launches"] + scale["k1"],
            "launches_by_path": {"fused frames": fused_launches[fused_mlp.K1],
                                 "open loop with the card-trained UNet (phase 37)": unet["k1"],
                                 **{name: n[fused_mlp.K1] for name, n in variant_launches.items()},
                                 "card-built student": asset_launches[fused_mlp.K1],
                                 "nerf-sfm (phase 23)": nerf_sfm_launches[fused_mlp.K1],
                                 "fused frames over the card-built model (phase 25)": rebuilt_k1,
                                 "open loop over the refined model (phase 29)": refined["k1"],
                                 "open loops over the unposed models (phase 33)": unposed["k1"],
                                 "video batch (phase 41)": batch["video"]["launches"],
                                 "scale-out, videos over 2 ranks on the card (phase 45)": scale["k1"]},
            "max_abs_err": max(max(r["err"] for r in k1), student_k1_err, batch["video"]["k1"]["err"]),
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": None,
            "by_shape": {r["shape"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                         for r in k1 + [batch["video"]["k1"]]},
        },
        {
            "name": "fused_distilled_eval",
            "route": "cuda",
            "source": "pixtrack_tpu_torch/csrc/distilled_eval.cu",
            "replaces": "pixtrack_tpu/nerf/fused_mlp.py:232",
            "launches": step_launches[fused_mlp.K2],
            "launches_by_path": {"stepwise": step_launches[fused_mlp.K2],
                                 "jittered renders": sum(jitter_launches.values()),
                                 "card-built student": asset_launches[fused_mlp.K2],
                                 "nerf-sfm (phase 23)": nerf_sfm_launches[fused_mlp.K2]},
            "max_abs_err": max(k2["err"], student_staged_err),
            "ms": k2["ms"],
            "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"],
            "bound_by": k2["bound_by"],
            "library_ms": None,
        },
    ]}))
    log(f"[summary] {smi}: blob FPS {blob['fps']:.2f}, mesh closed-loop FPS {mesh['fps']:.2f}, over the "
        f"card-built model {rebuilt['fps']:.2f}; refinement split (s) "
        + ", ".join(f"{k} {v:.2f}" for k, v in refined["split"].items())
        + f"; open loop over the refined model {refined['open']}/20; unposed mapper split at the ring's 36 views (s) "
        + ", ".join(f"{k} {v:.2f}" for k, v in unposed["split"].items())
        + f"; open loop over the unposed model {unposed['open']}/20 (over JAX's {unposed['jax_open']}/20); "
        f"InfoNCE {unet['infonce']['steps_per_s']:.2f} steps/s, basin {unet['basin']['steps_per_s']:.2f} steps/s; "
        f"held-out convergence of 48 " + ", ".join(f"{k} {v}" for k, v in unet["counts"].items())
        + f"; open loop with the card-trained UNet {unet['open']}/20; demo success {later['cli']['demo']:.3f}, the "
        f"CLI's track against the API {later['cli']['pose_diff']:.1e}; A/B correct of proposed: patch "
        f"{later['learned']['ab']['patch']['correct']}/{later['learned']['ab']['patch']['proposed']}, learned "
        f"{later['learned']['ab']['learned']['correct']}/{later['learned']['ab']['learned']['proposed']}; "
        f"reconstruct --detector dense global median {later['dense']['median']['global_deg']:.3f} deg; video batch "
        f"frames/s " + ", ".join(f"B={B} {v:.2f}" for B, v in batch["video"]["fps"].items())
        + f"; K1 at {batch['video']['k1']['shape']} {batch['video']['k1']['ms']:.3f} ms (bound "
        f"{batch['video']['k1']['bound_ms']:.3f}); descriptor training {batch['descriptor']['steps_per_s']:.2f} "
        f"steps/s, matcher plane pairs {batch['matcher']['plane_sps']:.2f}, bank host {batch['matcher']['host_sps']:.2f}, "
        f"bank device-resident {batch['matcher']['device_sps']:.2f} steps/s; SuperPoint MagicPoint "
        f"{batch['superpoint']['magic_sps']:.2f}, dense {batch['superpoint']['dense_sps']:.2f} steps/s; scale-out: "
        f"NeRF {scale['a']['sps']:.2f} steps/s at world {scale['a']['world']} ({scale['a']['backend']}), "
        f"{scale['b']['train_sps']:.2f} at 2 ranks sharing the card (gloo harness), the video batch "
        f"{[round(f, 2) for f in scale['b']['fps']]} frames/s per shared rank, phase 45 {scale['seconds']:.1f} s")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
