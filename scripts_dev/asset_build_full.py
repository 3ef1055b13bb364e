"""The asset path at its full budget on one NVIDIA GPU: chip_smoke.py's
phases 17-20 (the mesh world's capture, the hash-grid field trained at full
width, snapshot and bake, distillation and photometric fine-tune, the
student through K1 and K2) at 3000 training steps (the mesh world's build,
scripts_dev/build_mesh_bench_assets.py:39), 4000 distillation steps and 3000
fine-tune steps (DistillConfig's and finetune_photometric's defaults).
Prints chip_smoke.py's lines for those phases, each phase's wall time and
the total; the student's kernels are compared with their plain versions and
reported, not gated (chip_smoke.py gates them at its own step counts).

Phase 20's student distils the baked field, as Testbed.load_snapshot
installs it. With ``--compare N`` the same snapshot is then distilled again
at seeds 0..N-1 from both teachers, the vertex field (the recipe of the
shipped student, build_mesh_bench_assets.py:155-161) and the baked field
(phase 20's student is its seed 0), and each student's hold-out PSNR is
printed beside the JAX build's (assets/mesh_world/meta.json), then one JSON
line of them all.

Then it places K1's tail on phase 20's fine-tuned student: over the
224x224x96 ray set, each ray of K1 and of its plain version against the
exact (f64) sums (chip_smoke.py phase 3's per-ray rule: the kernel's share
of rays beyond 5e-3 at most 1.5 times the plain version's plus 1e-4); and
for the ray furthest from the exact sums through K1, its 96 samples
evaluated three ways (K2, which runs the same network from
csrc/distilled_mlp.cuh; the plain version; the exact sums) and each set
composited in f64, beside K1's own output for the ray. If K2's samples
composite to within 1e-3 of K1's output, K1's compositing is not the fault
and the tail is the network's.

    python3 scripts_dev/asset_build_full.py [TRAIN_STEPS DISTILL_STEPS FINETUNE_STEPS] [--compare N]
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def trace_k1_tail(device, rays):
    """K1's worst ray against the exact sums on the saved student, traced."""
    import torch

    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf.distill import load_distilled
    from pixtrack_tpu_torch.nerf.render import _composite, _sample_stratified

    student = load_distilled(chip_smoke.ASSET_WORKDIR / "field.npz", device=device)
    o, d, tn, tf = rays
    S, cut = 96, 1e-7
    with torch.no_grad():
        out = fused_mlp.fused_march_render(student, *rays, S, cut)
        plain = fused_mlp.march_render_reference(student, *rays, S, cut)
        exact = fused_mlp.march_render_reference(chip_smoke.ExactField(student), *rays, S, cut)

        def per_ray(a, b):
            return torch.maximum((a["alpha"] - b["alpha"]).abs(), (a["rgb"] - b["rgb"]).abs().amax(dim=1))

        e_k, e_p = per_ray(out, exact), per_ray(plain, exact)
        share_k, share_p = (float((e > chip_smoke.K1_TOL).float().mean()) for e in (e_k, e_p))
        i = int(e_k.argmax())
        # the ray's samples, where K1 and its plain version take them
        ts = _sample_stratified(tn[i:i + 1], tf[i:i + 1], S)
        x = (o[i][:, None] + ts * d[i][:, None]).clamp(0.0, 1.0).contiguous()
        dn = d[i] / (d[i, 0] * d[i, 0] + d[i, 1] * d[i, 1] + d[i, 2] * d[i, 2]).sqrt().clamp_min(1e-9)
        dT = dn[:, None].expand(3, S).contiguous()
        samples = {"K2": fused_mlp.fused_distilled_eval(student, x, dT), "plain": student.field_T(x, dT),
                   "exact": chip_smoke.exact_field(student, x, dT)}
        hit = tf[i:i + 1] > tn[i:i + 1]
        comp = {k: _composite(sg.double()[None], rgb.double()[:, None], ts.double(), tf[i:i + 1].double(), hit, cut,
                              1.0) for k, (sg, rgb) in samples.items()}
    k1_ray = torch.cat([out["alpha"][i:i + 1], out["rgb"][i]]).double()
    rows = {f"{k}'s samples composited in f64": torch.cat([c[1], c[0][0]]) for k, c in comp.items()}
    for k, r in (("plain", plain), ("exact", exact)):
        rows[f"the {k} render (f32)"] = torch.cat([r["alpha"][i:i + 1], r["rgb"][i]]).double()
    k2_vs_exact = max(float((torch.log1p(samples["K2"][0]) - torch.log1p(samples["exact"][0])).abs().max()),
                      float((samples["K2"][1] - samples["exact"][1]).abs().max()))
    plain_vs_exact = max(float((torch.log1p(samples["plain"][0]) - torch.log1p(samples["exact"][0])).abs().max()),
                         float((samples["plain"][1] - samples["exact"][1]).abs().max()))
    k1_vs_k2_comp = float((k1_ray - rows["K2's samples composited in f64"]).abs().max())
    chip_smoke.log(
        f"[K1 tail] per-ray rule against the exact sums over {e_k.numel()} rays: K1 max {float(e_k.max()):.3e}, "
        f"share beyond {chip_smoke.K1_TOL} {share_k:.6f}; plain max {float(e_p.max()):.3e}, share {share_p:.6f}; "
        f"rule (K1 <= 1.5 x plain + 1e-4): {share_k <= 1.5 * share_p + 1e-4}")
    chip_smoke.log(
        f"[K1 tail] ray {i}: K1 {e_k[i]:.3e} and plain {e_p[i]:.3e} from the exact sums; its {S} samples, max over "
        f"log1p(sigma) and rgb: K2 vs exact {k2_vs_exact:.3e}, plain vs exact {plain_vs_exact:.3e}; (alpha, rgb) "
        f"K1 {k1_ray.tolist()}, " + ", ".join(f"{k} {v.tolist()}" for k, v in rows.items())
        + f"; K1 vs K2's samples composited in f64: {k1_vs_k2_comp:.3e} "
        f"({'K1 composites them' if k1_vs_k2_comp <= 1e-3 else 'K1 COMPOSITES DIFFERENTLY'})")


def student_psnr(device, cap, teacher: str, seed: int):
    """Phase 20's recipe on the saved snapshot from ``teacher`` at ``seed``:
    the student's hold-out PSNR (full, object)."""
    from pixtrack_tpu_torch.nerf.distill import DistillConfig
    from pixtrack_tpu_torch.nerf.testbed import Testbed

    tb = Testbed(device=device)
    tb.load_snapshot(chip_smoke.ASSET_WORKDIR / "weights.npz", bake=teacher == "baked")
    tb.tighten_render_bounds()
    tb.distill(config=DistillConfig(steps=chip_smoke.DISTILL_STEPS, octaves=10), seed=seed,
               finetune_dataset=cap.ds, finetune_steps=chip_smoke.FINETUNE_STEPS)
    return chip_smoke.holdout_psnr(tb, cap)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("steps", type=int, nargs="*", default=[3000, 4000, 3000])
    ap.add_argument("--compare", type=int, default=0, help="students from both teachers at seeds 0..N-1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("asset_build_full: no CUDA device", file=sys.stderr)
        return 2
    steps = args.steps
    chip_smoke.TRAIN_STEPS, chip_smoke.DISTILL_STEPS, chip_smoke.FINETUNE_STEPS = steps
    chip_smoke.TRAIN_LOG_EVERY = steps[0] // 10
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.log(chip_smoke.nvidia_smi_line())
    from pixtrack_tpu_torch.nerf import fused_mlp

    fused_mlp.build_kernels()
    t0 = time.perf_counter()
    *_, rays, student, cap, vertex, baked = chip_smoke.phase_assets(device, gate=False)
    chip_smoke.log(f"[full budget] train {steps[0]}, distill {steps[1]}, fine-tune {steps[2]} steps: "
                   f"{time.perf_counter() - t0:.1f} s")
    if args.compare:
        nerf = json.loads((REPO / "assets" / "mesh_world" / "meta.json").read_text())["nerf"]
        jax = {"teacher": [nerf["psnr_holdout_full_db"], nerf["psnr_holdout_object_db"]],
               "student": [nerf["psnr_distilled_vs_gt_db"], nerf["psnr_distilled_object_db"]]}
        students = {"baked_0": list(student)}
        for teacher in ("vertex", "baked"):
            for seed in range(args.compare):
                key = f"{teacher}_{seed}"
                if key not in students:
                    t1 = time.perf_counter()
                    students[key] = list(student_psnr(device, cap, teacher, seed))
                    full, obj = students[key]
                    chip_smoke.log(f"[compare] the {teacher} field's student at seed {seed}: full / object "
                                   f"{full:.2f} / {obj:.2f} dB ({time.perf_counter() - t1:.1f} s)")
        gaps = {k: [round(t - v, 2) for t, v in zip(vertex if k.startswith("vertex") else baked, s)]
                for k, s in students.items()}
        chip_smoke.log(f"[compare] teachers, full / object (dB): vertex {vertex[0]:.2f} / {vertex[1]:.2f}, baked "
                       f"{baked[0]:.2f} / {baked[1]:.2f} (the JAX build's vertex teacher {jax['teacher']}); students "
                       f"{ {k: [round(v, 2) for v in s] for k, s in students.items()} } (the JAX build's student "
                       f"{jax['student']}); each student under its teacher {gaps} (the JAX build's "
                       f"{[round(t - v, 2) for t, v in zip(jax['teacher'], jax['student'])]})")
        print(json.dumps({"steps": steps, "teacher_vertex": list(vertex), "teacher_baked": list(baked),
                          "students": students, "student_under_teacher": gaps, "jax_build": jax}), flush=True)
    trace_k1_tail(device, rays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
