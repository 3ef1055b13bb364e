"""The asset path at its full budget on one NVIDIA GPU: chip_smoke.py's
phases 17-20 (the mesh world's capture, the hash-grid field trained at full
width, snapshot and bake, distillation and photometric fine-tune, the
student through K1 and K2) at 3000 training steps (the mesh world's build,
scripts_dev/build_mesh_bench_assets.py:39), 4000 distillation steps and 3000
fine-tune steps (DistillConfig's and finetune_photometric's defaults).
Prints chip_smoke.py's lines for those phases, each phase's wall time and
the total; the student's kernels are compared with their plain versions and
reported, not gated (chip_smoke.py gates them at its own step counts).

    python3 scripts_dev/asset_build_full.py [TRAIN_STEPS DISTILL_STEPS FINETUNE_STEPS]
"""

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("asset_build_full: no CUDA device", file=sys.stderr)
        return 2
    steps = [int(v) for v in sys.argv[1:4]] if len(sys.argv) > 3 else [3000, 4000, 3000]
    chip_smoke.TRAIN_STEPS, chip_smoke.DISTILL_STEPS, chip_smoke.FINETUNE_STEPS = steps
    chip_smoke.TRAIN_LOG_EVERY = steps[0] // 10
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.log(chip_smoke.nvidia_smi_line())
    from pixtrack_tpu_torch.nerf import fused_mlp

    fused_mlp.build_kernels()
    t0 = time.perf_counter()
    chip_smoke.phase_assets(device, gate=False)
    chip_smoke.log(f"[full budget] train {steps[0]}, distill {steps[1]}, fine-tune {steps[2]} steps: "
                   f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
