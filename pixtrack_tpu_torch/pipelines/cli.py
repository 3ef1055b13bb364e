"""The port's command line: ``reconstruct``, the asset subcommands and ``bundle-adjust`` of ``pixtrack_tpu/pipelines/cli.py``.

    python -m pixtrack_tpu_torch.pipelines.cli reconstruct --object_path DIR [--images DIR]
    python -m pixtrack_tpu_torch.pipelines.cli sfm-from-obj --object_path DIR --obj MESH.obj
    python -m pixtrack_tpu_torch.pipelines.cli train-nerf --object_path DIR
    python -m pixtrack_tpu_torch.pipelines.cli nerf-sfm --object_path DIR
    python -m pixtrack_tpu_torch.pipelines.cli augment --object_path DIR
    python -m pixtrack_tpu_torch.pipelines.cli bundle-adjust --model DIR [--out DIR] [--iters 20]

The same flags and defaults as the JAX package's subcommands, plus
``--device`` (the CUDA card by default; ``cpu`` runs on the CPU) and
``nerf-sfm --no_h5`` (skip features.h5 / matches.h5, which need h5py).
``reconstruct`` runs the Harris detector and mutual-NN + ratio matching:
the learned detectors and matcher are not ported yet, so ``--detector
superpoint | dense``, ``--matcher learned``, and ``auto`` when their
checkpoint is present, stop with a message. The other subcommands are not
ported yet.
"""

from __future__ import annotations

import argparse
import json


def _learned_not_ported(what: str):
    raise SystemExit(f"{what}: the learned SfM components are not ported to pixtrack_tpu_torch yet; use "
                     "--detector harris --matcher nn (or the JAX package's CLI)")


def _cmd_reconstruct(args):
    """Unposed SfM from raw images (the run_reconstruction.py role): the
    camera inferred from the image size (SIMPLE_RADIAL, f = 1.2 max(w, h)),
    ``incremental_sfm`` with the mapper configuration of the JAX package's
    CLI, the model written to ``ref_sfm``."""
    import shutil
    from pathlib import Path

    import numpy as np

    from pixtrack_tpu_torch._device import resolve
    from pixtrack_tpu_torch.mapping import (default_descriptor_weights_path, default_matcher_weights_path,
                                            default_superpoint_weights_path)
    from pixtrack_tpu_torch.mapping.incremental import incremental_sfm
    from pixtrack_tpu_torch.pipelines.assets import layout
    from pixtrack_tpu_torch.sfm import colmap_io
    from pixtrack_tpu_torch.tracking.refiner import infer_camera_from_image
    from pixtrack_tpu_torch.utils.io import _list_images, _read_rgb

    device = resolve(args.device)
    # `auto` resolves as the JAX package's: a learned component when its
    # checkpoint ships (none does), else Harris + mutual-NN / ratio
    if args.detector == "dense":
        _learned_not_ported(f"--detector dense ({default_descriptor_weights_path()})")
    if args.detector == "superpoint" or (args.detector == "auto" and default_superpoint_weights_path().exists()):
        _learned_not_ported(f"--detector {args.detector} ({default_superpoint_weights_path()})")
    if args.matcher == "learned" or (args.matcher == "auto" and default_matcher_weights_path().exists()):
        _learned_not_ported(f"--matcher {args.matcher} ({default_matcher_weights_path()})")

    paths = layout(args.object_path)
    mapping = paths["mapping"]
    mapping.mkdir(parents=True, exist_ok=True)
    if args.images and str(args.images) != str(mapping):
        for p in _list_images(args.images):
            shutil.copy(p, mapping)
    files = _list_images(mapping)
    images = {i + 1: _read_rgb(f) for i, f in enumerate(files)}
    names = {i + 1: Path(f).name for i, f in enumerate(files)}
    h, w = next(iter(images.values())).shape[:2]
    cam = infer_camera_from_image((h, w))
    cam_rec = colmap_io.CameraRecord(1, "SIMPLE_RADIAL", w, h, np.array([float(cam.f[0]), w / 2.0, h / 2.0, 0.0]))
    # the mapper configuration of the JAX package's tests and CLI: relaxed
    # score / ratio, NMS scaled to the image size, featuremetric KA and two
    # featuremetric BA rounds unless --no-featuremetric
    nms = 1 if max(h, w) <= 320 else (2 if max(h, w) <= 768 else 4)
    scene = incremental_sfm(
        images, cam_rec, names=names, verbose=args.verbose, max_keypoints=args.max_keypoints, nms_radius=nms,
        match_kw=dict(min_score=0.5, ratio=0.98), featuremetric_ka=not args.no_featuremetric,
        featuremetric_ba_rounds=0 if args.no_featuremetric else 2, device=device,
    )
    paths["ref_sfm"].mkdir(parents=True, exist_ok=True)
    scene.save(paths["ref_sfm"])
    print(f"reconstructed {len(scene.images)}/{len(images)} images, {len(scene.points3D)} points -> {paths['ref_sfm']}")


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

    s = sub.add_parser("reconstruct", help="unposed SfM from raw images (run_reconstruction)")
    s.add_argument("--object_path", required=True)
    s.add_argument("--images", help="source image folder (copied to mapping/)")
    s.add_argument("--verbose", action="store_true")
    s.add_argument("--no-featuremetric", action="store_true", help="skip featuremetric keypoint adjustment (pixsfm KA)")
    s.add_argument("--max_keypoints", type=int, default=1024, help="detector budget per image (hloc superpoint_max role)")
    s.add_argument("--matcher", choices=("auto", "nn", "learned"), default="auto",
                   help="pair matcher: mutual-NN + ratio (nn; what auto resolves to with no checkpoint); the "
                        "learned matcher is not ported yet")
    s.add_argument("--detector", choices=("auto", "harris", "superpoint", "dense"), default="auto",
                   help="keypoint detector: multi-scale Harris (harris; what auto resolves to with no checkpoint); "
                        "SuperPoint and the dense descriptor are not ported yet")
    s.set_defaults(fn=_cmd_reconstruct)

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
