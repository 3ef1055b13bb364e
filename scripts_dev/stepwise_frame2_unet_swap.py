"""Which part of the stepwise tracker decides frame 2 of the mesh world.

chip_smoke.py's stepwise phase and the JAX package's own run
(``stepwise_mesh_jax.py``) split at frame 2 of the mesh world's orbit: from
the same frame-1 pose the LM lands in one of two minima (cost ~0.0798 or
~0.0842). This script takes JAX's frame-1 pose (UNet bf16) and refines
frame 2 from it, for each UNet dtype, three ways:

- the JAX tracker;
- the port's tracker (``pixtrack_tpu_torch``, on the CPU) with its own UNet;
- the port's tracker with XLA's UNet (same weights, features normalised by
  JAX) in place of its own: everything else (depth mask, staged reference
  render, observations, LM) is the port's.

If the third agrees with the first, the split comes from the UNet's
arithmetic alone. Runs on the CPU at full size (~8 minutes on 8 cores):

    JAX_PLATFORMS=cpu python scripts_dev/stepwise_frame2_unet_swap.py

Prints one line per run: cost, LM iterations and success.
"""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts_dev"))


def main():
    from stepwise_mesh_jax import jax_world  # sets JAX on the CPU

    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from pixtrack_tpu.features.train import load_unet_weights
    from pixtrack_tpu.features.unet import UNetExtractor, normalize_features
    from pixtrack_tpu.geometry import Pose as JPose
    from pixtrack_tpu_torch.features.extractor import FeatureExtractor
    from pixtrack_tpu_torch.geometry import Pose

    jtr, frames, _, _, _ = jax_world(3, "bf16")
    jtr.run(frames[:2])
    T1 = np.asarray(jtr.pose.to_4x4(), np.float32)
    threshold = float(jtr.cost_threshold)
    params = load_unet_weights(REPO / "assets" / "unet_basin.npz")[1]

    class XlaUNet(FeatureExtractor):
        """The port's extractor with XLA's UNet in place of its own."""

        def __init__(self, model, jdtype, tdtype):
            super().__init__(model, resize=1024)
            self.apply = jax.jit(UNetExtractor(dtype=jdtype).apply)
            self.tdtype = tdtype

        def _run(self, img, out_h, out_w):
            img = img.float()
            if tuple(img.shape[:2]) != (out_h, out_w):
                img = torch.nn.functional.interpolate(
                    img.permute(2, 0, 1)[None], size=(out_h, out_w), mode="bilinear",
                    antialias=True, align_corners=False,
                )[0].permute(1, 2, 0)
            pred = self.apply(params, jnp.asarray(img[None].numpy()))

            def to_torch(a):
                return torch.as_tensor(np.asarray(a, np.float32)).to(self.tdtype)

            return (tuple(to_torch(normalize_features(f[0])) for f in pred["feature_maps"]),
                    tuple(to_torch(c[0]) for c in pred["confidences"]))

    def refine_frame2(label, tracker, pose):
        tracker.cold_start, tracker.success, tracker.cost_threshold, tracker.pose = False, True, threshold, pose
        inner = tracker.refiner.refine
        got = {}

        def spy(*args, **kwargs):
            got["res"] = inner(*args, **kwargs)
            return got["res"]

        tracker.refiner.refine = spy
        ok = tracker.refine(frames[2])
        print(f"{label}: frame 2 cost {float(got['res'].cost):.6f}, LM iterations "
              f"{int(got['res'].num_iters)}, success {bool(ok)}", flush=True)

    for name, jdtype, tdtype in (("bf16", jnp.bfloat16, torch.bfloat16), ("f32", jnp.float32, torch.float32)):
        jtr2, _, _, _, _ = jax_world(3, name)
        refine_frame2(f"JAX, UNet {name}", jtr2, JPose.from_4x4(jnp.asarray(T1)))
        for swap in (False, True):
            ttr, camera, _, _, _, _ = chip_smoke.mesh_world(
                torch.device("cpu"), 2, unet_dtype=tdtype, fast_render=False, mask_mode="nerf_depth")
            ttr.camera = camera
            if swap:
                ttr.refiner.extractor = XlaUNet(ttr.refiner.extractor.model, jdtype, tdtype)
            refine_frame2(f"port, {'XLA' if swap else 'its own'} UNet {name}", ttr,
                          Pose.from_Rt(T1[:3, :3], T1[:3, 3]))


if __name__ == "__main__":
    main()
