#!/usr/bin/env python3
"""K2 and its plain version after an in-place fine-tune step, each against the
exact (f64) sums of the same bf16 products, over many draws of the samples.

The case of tests/test_torch_cuda.py::test_k1_and_k2_follow_an_in_place_finetune_step
(the 10-octave random field of ``_field``, one staged-render Adam step),
with SAMPLES positions and directions (the test's 4099 before it grew to
262,147) drawn from ``torch.Generator`` seeds 0..N-1. Per seed, for rgb and log1p(sigma): the largest kernel-vs-plain gap,
and the share of samples further than 5e-3 from the exact sums for the
kernel and for the plain version (chip_smoke's EXACT_RATIO rule compares
those two shares).

    python3 scripts_dev/k2_finetune_exact.py [N [SAMPLES]]

Needs one CUDA card; prints one JSON line per seed, then a summary line.
"""

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def main(n: int, samples: int):
    import torch

    from chip_smoke import exact_field, nvidia_smi_line
    from pixtrack_tpu_torch.nerf import fused_mlp
    from pixtrack_tpu_torch.nerf.optim import Adam
    from pixtrack_tpu_torch.nerf.render import RenderConfig, render_rays
    from test_torch_cuda import _field

    dev = torch.device("cuda")
    print(nvidia_smi_line(), flush=True)
    field = _field(10, dev)
    params = [t.requires_grad_(True) for t in field.tensors()]
    rng = np.random.default_rng(2)
    o = torch.as_tensor(rng.normal(size=(512, 3)).astype(np.float32), device=dev)
    o = 1.6 * o / o.norm(dim=1, keepdim=True)
    out = render_rays(field, o, -o / 1.6, torch.tensor([[0.25] * 3, [0.75] * 3], device=dev),
                      RenderConfig(n_coarse=32, n_fine=0, fused=False))
    (out["rgb"] - 0.5).square().mean().backward()
    Adam(params, 1e-2, 10, 1e-3).step()
    rows = []
    for seed in range(n):
        g = torch.Generator().manual_seed(seed)
        x = torch.rand(3, samples, generator=g).to(dev)
        dn = torch.nn.functional.normalize(torch.randn(3, samples, generator=g), dim=0).to(dev)
        with torch.no_grad():
            s_k, c_k = fused_mlp.fused_distilled_eval(field, x, dn)
            s_p, c_p = fused_mlp.distilled_eval_reference(field, x, dn)
            s_e, c_e = exact_field(field, x, dn)
        row = {"seed": seed}
        for name, k, p, e in (("rgb", c_k, c_p, c_e), ("log1p_sigma", torch.log1p(s_k), torch.log1p(s_p),
                                                         torch.log1p(s_e))):
            row[name] = {"kernel_vs_plain_max": float((k - p).abs().max()),
                         "kernel_beyond": float(((k - e).abs() > 5e-3).float().mean()),
                         "plain_beyond": float(((p - e).abs() > 5e-3).float().mean()),
                         "kernel_vs_exact_max": float((k - e).abs().max()),
                         "plain_vs_exact_max": float((p - e).abs().max())}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in ("rgb", "log1p_sigma"):
        summary[name] = {k: [min(r[name][k] for r in rows), max(r[name][k] for r in rows)] for k in rows[0][name]}
        summary[name]["seeds_over_1e-2"] = sum(r[name]["kernel_vs_plain_max"] > 1e-2 for r in rows)
        summary[name]["seeds_breaking_exact_rule"] = sum(
            r[name]["kernel_beyond"] > 1.5 * r[name]["plain_beyond"] + 1e-4 for r in rows)
    print(json.dumps({"summary": summary, "seeds": n, "samples": samples}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20, int(sys.argv[2]) if len(sys.argv) > 2 else 262147)
