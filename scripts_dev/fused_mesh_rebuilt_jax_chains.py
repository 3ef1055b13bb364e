"""The JAX package's fused closed loop over a rebuilt mesh-world SfM model.

``chip_smoke.py`` phase 25 tracks the mesh world over the SfM model that the
port built on the card (``sfm-from-obj`` then ``augment``) instead of the
shipped ``assets/mesh_world/aug_sfm``. This script gives that phase its
reference: the JAX package's model of the same rig, built on the CPU by
``scripts_dev/sfm_from_obj_jax.py MODEL_DIR``, augmented here by the JAX
package's ``augment_scene`` (twelve rolls, as the shipped build), and then
the six perturbed closed-loop chains of ``scripts_dev/fused_mesh_jax_chains.py``
over it, with the shipped ``field.npz`` and ``nerf2sfm.pkl``:

    JAX_PLATFORMS=cpu python scripts_dev/fused_mesh_rebuilt_jax_chains.py MODEL_DIR [n_frames] [k ... | open]

(20 frames and k = 0..5 by default; chain 0 comes with the cold start, each
other chain costs a few minutes on 8 cores, so split the k over processes.)
Prints what ``fused_mesh_jax_chains.py`` prints, for the rebuilt model; with
``open``, the same fused frame in open loop instead (each frame started from
the previous frame's ground truth, as chip_smoke's open loop): per-frame
costs, successes and the rotation median, then one JSON line.
"""

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts_dev"))
sys.path.insert(0, str(REPO / "tests"))


def open_loop(n_frames: int):
    """chip_smoke's open loop of the fused frame, in JAX."""
    import jax.numpy as jnp
    from fused_mesh_jax_chains import rot_err_deg
    from stepwise_mesh_jax import jax_world

    tracker, frames, gt, _, _ = jax_world(n_frames + 1, "bf16")
    tracker.config.fast_render = True
    tracker.config.mask_mode = "splat"
    tracker.testbed.n_coarse, tracker.testbed.n_fine = 96, 0
    tracker.run_fused(frames[:2], camera=tracker.camera)  # the cold start sets the threshold
    step, thresh = tracker._fused_step, jnp.float32(tracker.cost_threshold)
    outs = [step(jnp.asarray(np.asarray(gt[k].R)), jnp.asarray(np.asarray(gt[k].t)), jnp.asarray(True), thresh,
                 jnp.asarray(np.asarray(img), jnp.float32) / 255.0)
            for k, (_, img) in enumerate(frames[1:])]
    oks = [bool(np.asarray(o.ok)) for o in outs]
    costs = [float(np.asarray(o.cost)) for o in outs]
    rot = [rot_err_deg(o.R, T.R) for o, T in zip(outs, gt[1:])]
    print(f"open loop: success {sum(oks)}/{len(oks)}, rot med/max {np.median(rot):.2f}/{np.max(rot):.2f} deg; "
          f"cost {[round(c, 4) for c in costs]} vs {tracker.cost_threshold:.4f}", flush=True)
    print(json.dumps({"open_loop": {"successes": sum(oks), "frames": len(oks), "rot_median_deg": float(np.median(rot)),
                                    "costs": costs, "rot_err_deg": rot, "success": oks},
                      "cost_threshold": float(tracker.cost_threshold)}))


def main(model_dir: str, n_frames: int = 20, ks=(0, 1, 2, 3, 4, 5)):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import fused_mesh_jax_chains
    from pixtrack_tpu.mapping.augment import augment_scene
    from pixtrack_tpu.sfm import scene as scene_mod

    ref = scene_mod.SceneModel.load(model_dir)
    aug = augment_scene(ref)
    print(f"rebuilt model {model_dir}: {len(ref.image_ids)} views, {len(ref.point_ids)} points; augmented: "
          f"{len(aug.image_ids)} images", flush=True)
    shipped = (REPO / "assets" / "mesh_world" / "aug_sfm").resolve()
    with tempfile.TemporaryDirectory() as tmp:
        aug.save(tmp)
        load = scene_mod.SceneModel.load.__func__

        # the chains script loads the shipped model: hand it the rebuilt one
        def rebuilt_load(cls, path):
            return load(cls, tmp if Path(path).resolve() == shipped else path)

        scene_mod.SceneModel.load = classmethod(rebuilt_load)
        if ks == "open":
            open_loop(n_frames)
        else:
            fused_mesh_jax_chains.main(n_frames, ks)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 20,
         "open" if sys.argv[3:] == ["open"] else tuple(int(a) for a in sys.argv[3:]) or (0, 1, 2, 3, 4, 5))
