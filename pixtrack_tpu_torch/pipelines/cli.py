"""The port's command line: the asset subcommands and ``bundle-adjust`` of ``pixtrack_tpu/pipelines/cli.py``.

    python -m pixtrack_tpu_torch.pipelines.cli sfm-from-obj --object_path DIR --obj MESH.obj
    python -m pixtrack_tpu_torch.pipelines.cli train-nerf --object_path DIR
    python -m pixtrack_tpu_torch.pipelines.cli nerf-sfm --object_path DIR
    python -m pixtrack_tpu_torch.pipelines.cli augment --object_path DIR
    python -m pixtrack_tpu_torch.pipelines.cli bundle-adjust --model DIR [--out DIR] [--iters 20]

The same flags and defaults as the JAX package's subcommands, plus
``--device`` (the CUDA card by default; ``cpu`` runs on the CPU) and
``nerf-sfm --no_h5`` (skip features.h5 / matches.h5, which need h5py). The
other subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import json


def _cmd_sfm_from_obj(args):
    from pixtrack_tpu_torch.mapping.mesh_render import create_scene_from_mesh
    from pixtrack_tpu_torch.pipelines.assets import layout

    paths = layout(args.object_path)
    # the renders go to the mapping dir (train-nerf's images); the model to ref_sfm
    scene, _ = create_scene_from_mesh(args.obj, out_dir=paths["mapping"], image_size=args.image_size,
                                      subdiv=args.subdiv, device=args.device)
    paths["ref_sfm"].mkdir(parents=True, exist_ok=True)
    scene.save(paths["ref_sfm"])
    print(f"mesh SfM: {len(scene.images)} views, {len(scene.points3D)} points -> {paths['ref_sfm']}")


def _cmd_train_nerf(args):
    from pixtrack_tpu_torch.pipelines.assets import train_nerf_asset

    _, info = train_nerf_asset(
        args.object_path, n_steps=args.n_steps, downscale=args.downscale, batch_rays=args.batch_rays,
        n_coarse=args.n_coarse, n_fine=args.n_fine, save_every=args.save_every, resume=args.resume,
        verbose=True, devices=args.devices, tp=args.tp, device=args.device)
    print(json.dumps({"seconds": info["seconds"], "history": info["history"]}))


def _cmd_nerf_sfm(args):
    from pixtrack_tpu_torch.pipelines.assets import create_nerf_sfm

    print(create_nerf_sfm(args.object_path, spp=args.spp, write_h5=not args.no_h5, device=args.device))


def _cmd_augment(args):
    from pixtrack_tpu_torch.pipelines.assets import augment_assets

    print(augment_assets(args.object_path, device=args.device))


def _cmd_bundle_adjust(args):
    """Refine an SfM model (the COLMAP bundle_adjuster role); in place
    unless ``--out`` is given."""
    from pathlib import Path

    from pixtrack_tpu_torch._device import resolve
    from pixtrack_tpu_torch.mapping.bundle import bundle_adjust_scene
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    device = resolve(args.device)
    scene = SceneModel.load(args.model)
    refined = bundle_adjust_scene(scene, iters=args.iters, device=device)
    out = Path(args.out or args.model)
    out.mkdir(parents=True, exist_ok=True)
    refined.save(out)
    print(f"bundle-adjusted {len(scene.images)} images -> {out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="pixtrack-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("sfm-from-obj", help="textured mesh -> posed renders -> SfM")
    s.add_argument("--object_path", required=True)
    s.add_argument("--obj", required=True)
    s.add_argument("--subdiv", type=int, default=1)
    s.add_argument("--image_size", type=int, default=512)
    s.set_defaults(fn=_cmd_sfm_from_obj)

    s = sub.add_parser("train-nerf", help="train the hash-grid NeRF")
    s.add_argument("--object_path", required=True)
    s.add_argument("--n_steps", type=int, default=10000)
    s.add_argument("--downscale", type=int, default=1)
    s.add_argument("--batch_rays", type=int, default=1 << 14)
    s.add_argument("--save_every", type=int, default=1000, help="checkpoint the snapshot every N steps (0 = off)")
    s.add_argument("--n_coarse", type=int, default=64, help="stratified samples per ray")
    s.add_argument("--n_fine", type=int, default=32, help="importance samples per ray (0 disables fine pass)")
    s.add_argument("--resume", action="store_true", help="warm-start from an existing snapshot")
    s.add_argument("--devices", type=int, default=0, help="one device only: more than 1 raises")
    s.add_argument("--tp", type=int, default=1, help="one device only: more than 1 raises")
    s.set_defaults(fn=_cmd_train_nerf)

    s = sub.add_parser("nerf-sfm", help="NeRF re-render + triangulation")
    s.add_argument("--object_path", required=True)
    s.add_argument("--spp", type=int, default=2)
    s.add_argument("--no_h5", action="store_true", help="do not write features.h5 / matches.h5 (no h5py)")
    s.set_defaults(fn=_cmd_nerf_sfm)

    s = sub.add_parser("augment", help="rotation-augment the SfM model")
    s.add_argument("--object_path", required=True)
    s.set_defaults(fn=_cmd_augment)

    s = sub.add_parser("bundle-adjust", help="refine an SfM model (BA)")
    s.add_argument("--model", required=True)
    s.add_argument("--out")
    s.add_argument("--iters", type=int, default=20)
    s.set_defaults(fn=_cmd_bundle_adjust)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
