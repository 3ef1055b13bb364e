"""The JAX package's hash-grid NeRF trained on the mesh world's capture, on the
CPU: the yardstick for the PyTorch port's training on the card.

The capture is the mesh world's mapping rig (42 icosphere views of
``assets/mesh_world/src/house.obj``, focal 450, rendered by the JAX package's
rasteriser, moved to NeRF space by ``assets/mesh_world/nerf2sfm.pkl``) at
IMAGE_SIZE (448 as the assets were built; the focal scales with it). The
recipe is ``scripts_dev/build_mesh_bench_assets.py``'s: batch 4096 rays, 48
coarse + 16 importance samples, the default field (16 levels, 2^19 tables)
and TrainConfig's lr schedule over STEPS steps. Every EVAL_EVERY steps it
renders the 6 hold-out views of ``build_mesh_bench_assets.holdout_poses``
(focal 1.2 x 448, 448 x 448, 64 + 32 samples, one deterministic sample a
pixel) and prints one JSON line: step, loss, seconds of training so far,
hold-out PSNR over the full image and over the object region (ground-truth
pixels darker than 250 in some channel).

    JAX_PLATFORMS=cpu python scripts_dev/nerf_train_mesh_jax.py STEPS SEED [EVAL_EVERY] [IMAGE_SIZE]
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts_dev"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def capture(image_size: int):
    from pixtrack_tpu.geometry import Camera
    from pixtrack_tpu.geometry.nerf_transform import NerfTransform
    from pixtrack_tpu.mapping.mesh_render import load_obj, look_at_rig_for_mesh, render_mesh
    from pixtrack_tpu.nerf.dataset import NerfDataset

    mw = REPO / "assets" / "mesh_world"
    mesh = load_obj(mw / "src" / "house.obj")
    n2s = NerfTransform.load(mw / "nerf2sfm.pkl")
    f = 450.0 * image_size / 448
    c = (image_size - 1) / 2
    cam = Camera.pinhole(f, f, c, c, image_size, image_size)
    images, poses = [], []
    for T in look_at_rig_for_mesh(mesh["vertices"], subdiv=1):
        images.append(render_mesh(mesh, T, cam, background=(1, 1, 1)).astype(np.float32) / 255.0)
        poses.append(n2s.pose_sfm_to_nerf(np.asarray(T.inv().to_4x4(), np.float64)))
    ds = NerfDataset(images=np.stack(images), c2w=np.stack(poses).astype(np.float32), fx=f, fy=f, cx=c, cy=c,
                     width=image_size, height=image_size)
    return mesh, n2s, ds


def main():
    steps, seed = int(sys.argv[1]), int(sys.argv[2])
    eval_every = int(sys.argv[3]) if len(sys.argv) > 3 else steps
    image_size = int(sys.argv[4]) if len(sys.argv) > 4 else 448

    from build_mesh_bench_assets import holdout_poses, psnr
    from pixtrack_tpu.geometry import Camera
    from pixtrack_tpu.mapping.mesh_render import render_mesh
    from pixtrack_tpu.mapping.nerf_dataset import estimate_aabb_from_scene
    from pixtrack_tpu.nerf.field import NGPField
    from pixtrack_tpu.nerf.testbed import Testbed
    from pixtrack_tpu.nerf.train import TrainConfig, train
    from pixtrack_tpu.sfm.scene import SceneModel
    from pixtrack_tpu.tracking.render_bridge import render_nerf_view

    mesh, n2s, ds = capture(image_size)
    aabb = estimate_aabb_from_scene(SceneModel.load(REPO / "assets" / "mesh_world" / "aug_sfm"), n2s)
    cam = Camera.pinhole(1.2 * 448, 1.2 * 448, 223.5, 223.5, 448, 448)
    hp = holdout_poses(mesh)
    gt = [render_mesh(mesh, T, cam) for T in hp]
    masks = [g.min(axis=-1) < 250 for g in gt]
    t_train = [0.0, time.perf_counter()]

    def evaluate(done, loss, params):
        t_train[0] += time.perf_counter() - t_train[1]
        if done % eval_every == 0:
            tb = Testbed()
            tb.set_field(NGPField(), params)
            tb.render_aabb.min, tb.render_aabb.max = list(aabb[0]), list(aabb[1])
            views = [render_nerf_view(tb, n2s, T, cam, spp=1, alpha_threshold=-1.0) for T in hp]
            print(json.dumps({
                "seed": seed, "step": done, "loss": loss, "train_seconds": round(t_train[0], 1),
                "image_size": image_size,
                "psnr_full": float(np.mean([psnr(v, g) for v, g in zip(views, gt)])),
                "psnr_object": float(np.mean([psnr(v, g, m) for v, g, m in zip(views, gt, masks)])),
            }), flush=True)
        t_train[1] = time.perf_counter()

    cfg = TrainConfig(n_steps=steps, batch_rays=4096, n_coarse=48, n_fine=16, log_every=min(50, eval_every))
    train(ds, aabb, cfg, seed=seed, callback=evaluate)


if __name__ == "__main__":
    main()
