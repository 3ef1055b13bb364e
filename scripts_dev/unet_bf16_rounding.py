"""Where the JAX package's bf16 UNet rounds, against the port's, on the CPU.

The stepwise tracker on the mesh world splits between the two packages at
frame 2 by the UNet's last bits alone (``stepwise_frame2_unet_swap.py``).
This script runs XLA's bf16 UNet (``assets/unet_basin.npz``) on frame 2's
query image, once with XLA's defaults and once with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (each in a subprocess of
its own, the flag set before JAX starts), capturing every module's output;
and the port's UNet on the same input, two ways:

- ``XLA's rounding``: the port as it is (``features/unet.py``): a
  convolution's output rounded, its bias added in f32 unrounded, GroupNorm's
  statistics from the rounded sum and its normalisation of the unrounded
  one, the heads unrounded; what the compiled HLO of a flax ConvBlock does
  on the CPU with XLA's defaults;
- ``per-op``: every op's result rounded to bf16 and GroupNorm's two-pass
  statistics (the port before that repair, rebuilt here).

For each module it prints the largest difference from XLA's output in bf16
ulps of the output's magnitude and the share of values that differ, and for
the three feature maps the largest absolute difference:

    JAX_PLATFORMS=cpu python scripts_dev/unet_bf16_rounding.py

(about a minute on 8 cores). The port is imported from ``pixtrack_tpu_torch``;
the query is ``chip_smoke.mesh_world``'s frame 2 (640x480, black background).
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
WEIGHTS = REPO / "assets" / "unet_basin.npz"


def jax_run(image_path: str, out_path: str):
    """XLA's bf16 UNet on the image, every module's output saved (f32)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from pixtrack_tpu.features.train import load_unet_weights
    from pixtrack_tpu.features.unet import UNetExtractor

    params = load_unet_weights(WEIGHTS)[1]
    img = jnp.asarray(np.load(image_path))[None]
    fn = jax.jit(lambda p, x: UNetExtractor(dtype=jnp.bfloat16).apply(p, x, capture_intermediates=True))
    out, state = fn(params, img)
    flat = {".".join(k[:-1]): np.asarray(v[0], np.float32)
            for k, v in flatten_dict(state["intermediates"]).items()
            if k[-1] == "__call__" and not isinstance(v[0], (dict, tuple))}
    for i, f in enumerate(out["feature_maps"]):
        flat[f"feature_maps.{i}"] = np.asarray(f, np.float32)
    np.savez(out_path, **flat)


def port_run(image: np.ndarray, variant: str):
    """The port's bf16 UNet on the image: {module name: output (f32, NHWC)}."""
    import torch

    from pixtrack_tpu_torch.features import unet

    model = unet.load_unet_weights(WEIGHTS, device="cpu", dtype=torch.bfloat16)
    if variant == "per-op":
        for m in model.modules():
            if isinstance(m, (unet.Conv2d, unet.GroupNorm)):
                m.forward = _per_op(m)
    outs = {}

    def hook(name):
        def save(m, _, y):
            if isinstance(y, tuple):  # a head: (feat, conf)
                return
            if isinstance(m, unet.Conv2d):  # flax's Conv module returns the rounded sum
                y = y.to(torch.bfloat16)
            outs[name] = y.float().permute(0, 2, 3, 1).numpy()
        return save

    for name, m in model.named_modules():
        if name and not isinstance(m, unet.Head):
            m.register_forward_hook(hook(name))
    with torch.no_grad():
        pred = model(torch.as_tensor(image)[None])
    for i, f in enumerate(pred["feature_maps"]):
        outs[f"feature_maps.{i}"] = f.float().numpy()
    return outs


def _per_op(m):
    """The module rounding every op's result to bf16 (GroupNorm two-pass)."""
    import torch
    import torch.nn.functional as F

    from pixtrack_tpu_torch.features import unet

    if isinstance(m, unet.GroupNorm):
        return lambda y, dtype: F.group_norm(y.to(dtype).float(), m.num_groups, m.weight, m.bias, m.eps).to(dtype)

    def conv(x):
        y = m._conv_forward(x, m.weight.to(x.dtype), None)
        return (y + m.bias.to(x.dtype)[:, None, None]).float()
    return conv


def ulps(a: np.ndarray, b: np.ndarray) -> float:
    """Largest |a - b| in bf16 ulps of max(|a|, |b|) (2^-7 relative)."""
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return float(np.max(np.abs(a - b) / ulp))


def frame2_query() -> np.ndarray:
    import torch

    import chip_smoke

    a = chip_smoke.mesh_assets(torch.device("cpu"), n_frames=2, unet_dtype=torch.bfloat16)
    return a.frames[2][1].astype(np.float32) / 255.0


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--jax":
        return jax_run(sys.argv[2], sys.argv[3])
    image = frame2_query()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        np.save(Path(tmp) / "img.npy", image)
        jax_outs = {}
        for label, flags in (("XLA default", ""), ("XLA excess precision off", "--xla_allow_excess_precision=false")):
            out = str(Path(tmp) / f"{len(jax_outs)}.npz")
            env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu")
            subprocess.run([sys.executable, __file__, "--jax", str(Path(tmp) / "img.npy"), out], env=env, check=True)
            with np.load(out) as d:
                jax_outs[label] = {k: d[k] for k in d.files}
    ports = {v: port_run(image, v) for v in ("XLA's rounding", "per-op")}
    names = [k for k in jax_outs["XLA default"] if not k.startswith("feature_maps")]
    for jl, jo in jax_outs.items():
        for pl, po in ports.items():
            rows, first = [], None
            for k in names:  # the port's module names are flax's paths
                if k not in po:
                    continue
                u = ulps(jo[k], po[k])
                share = float(np.mean(jo[k] != po[k]))
                rows.append((k, u, share))
                if first is None and u > 1.0:
                    first = k
            d = [np.abs(jo[f"feature_maps.{i}"] - po[f"feature_maps.{i}"]) for i in range(3)]
            res[f"{jl} vs port {pl}"] = {
                "first_over_1ulp": first, "feature_max_abs": [float(x.max()) for x in d],
                "feature_mean_abs": [float(x.mean()) for x in d], "feature_share_equal": [float((x == 0).mean()) for x in d],
                "modules": {k: [u, s] for k, u, s in rows}}
            r = res[f"{jl} vs port {pl}"]
            print(f"{jl} vs port {pl}: first module over one bf16 ulp: {first}; feature maps (strides 1, 4, 16): "
                  f"max |diff| {[f'{v:.3e}' for v in r['feature_max_abs']]}, mean "
                  f"{[f'{v:.2e}' for v in r['feature_mean_abs']]}, share equal "
                  f"{[round(v, 4) for v in r['feature_share_equal']]}", flush=True)
            for k, u, s in rows[:4] + rows[-2:]:
                print(f"    {k}: {u:.2f} ulp, {s:.4f} of the values differ")
    dj = [float(np.abs(jax_outs["XLA default"][f"feature_maps.{i}"]
                       - jax_outs["XLA excess precision off"][f"feature_maps.{i}"]).max()) for i in range(3)]
    print(f"XLA default vs excess precision off: feature maps max |diff| {[f'{v:.3e}' for v in dj]}")
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "modules"} for k, v in res.items()}))


if __name__ == "__main__":
    main()
