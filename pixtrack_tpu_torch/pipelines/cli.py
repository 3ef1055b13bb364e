"""The port's command line: every subcommand of ``pixtrack_tpu/pipelines/cli.py``.

    python -m pixtrack_tpu_torch.pipelines.cli track --object_path DIR --query DIR [--frames N] [--out_dir out]
    python -m pixtrack_tpu_torch.pipelines.cli track-batch --object_path DIR --query DIR [DIR ...] [--frames N]
    python -m pixtrack_tpu_torch.pipelines.cli track-ycb --object_path DIR --ycb_root DIR [--query 0000/:]
    python -m pixtrack_tpu_torch.pipelines.cli visualize --object_path DIR --poses poses.pkl [--video]
    python -m pixtrack_tpu_torch.pipelines.cli eval --poses poses.pkl
    python -m pixtrack_tpu_torch.pipelines.cli demo [--frames 6] [--out_dir DIR]
    python -m pixtrack_tpu_torch.pipelines.cli reconstruct --object_path DIR [--images DIR] [--detector dense]
    python -m pixtrack_tpu_torch.pipelines.cli sfm-from-obj --object_path DIR --obj MESH.obj
    python -m pixtrack_tpu_torch.pipelines.cli train-nerf --object_path DIR
    python -m pixtrack_tpu_torch.pipelines.cli nerf-sfm --object_path DIR
    python -m pixtrack_tpu_torch.pipelines.cli augment --object_path DIR
    python -m pixtrack_tpu_torch.pipelines.cli bundle-adjust --model DIR [--out DIR] [--iters 20]
    python -m pixtrack_tpu_torch.pipelines.cli extract-frames --video FILE --out_dir DIR [--every 1]
    python -m pixtrack_tpu_torch.pipelines.cli convert-images SRC_DIR OUT_DIR [--to png] [--ext heic ...]

The same flags, defaults, printed results and files written as the JAX
package's subcommands, plus ``--device`` (the CUDA card by default; ``cpu``
runs on the CPU) where JAX has ``--platform``, and ``nerf-sfm --no_h5``
(skip features.h5 / matches.h5, which need h5py). ``bench`` stops with a
message: the port has no benchmark yet (``bench.py`` measures the JAX
package). ``track-batch`` refines every video's frame k in one batched
step on the one card; ``--devices`` above 1 stops with a message.
``reconstruct --detector dense | superpoint`` and ``--matcher learned`` run
the learned components when their checkpoints are found (``auto`` picks
them then); asked for without one, they stop with a message.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _load_component(loader, what: str, path):
    """A learned component from its checkpoint, or a stop naming the file
    when the file is there but cannot be read as one."""
    import zipfile

    try:
        return loader()
    except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile) as e:
        raise SystemExit(f"cannot read the {what} checkpoint {path}: {e}") from e


def _learned_components(args, device):
    """(detector, matcher, match_kw) of ``reconstruct``'s --detector and
    --matcher, resolved as the JAX package's CLI resolves them; the
    classical stack (None, None) when a learned one is neither asked for
    nor found."""
    from pixtrack_tpu_torch import mapping

    detector, match_kw = None, dict(min_score=0.5, ratio=0.98)
    if args.detector == "dense":
        path = mapping.default_descriptor_weights_path()
        detector = _load_component(lambda: mapping.default_descriptor(device=device), "dense-descriptor", path)
        if detector is None:
            raise SystemExit(f"no dense-descriptor checkpoint ({path}; PIXTRACK_DENSE_DESCRIPTOR_WEIGHTS "
                             "overrides it); use --detector harris")
        match_kw = dict(detector.match_kw)  # the operating point it was accepted at
    elif args.detector != "harris":
        path = mapping.default_superpoint_weights_path()
        detector = _load_component(lambda: mapping.default_detector(device=device), "SuperPoint", path)
        if detector is None and args.detector == "superpoint":
            raise SystemExit(f"no SuperPoint checkpoint ({path}; PIXTRACK_SUPERPOINT_WEIGHTS overrides it); use "
                             "--detector harris")
    matcher = None
    if args.matcher != "nn":
        path = mapping.default_matcher_weights_path()
        matcher = _load_component(lambda: mapping.default_matcher(device=device), "attention-matcher", path)
        if matcher is None and args.matcher == "learned":
            raise SystemExit(f"no attention-matcher checkpoint ({path}; PIXTRACK_MATCHER_WEIGHTS overrides it); "
                             "use --matcher nn")
        # the matcher is bound to the descriptor space it was trained on
        # (SuperPoint 256-d, the dense descriptor 128-d, Harris patches 845-d)
        det_dim = getattr(detector, "desc_dim", 845)
        if matcher is not None and matcher.desc_dim != det_dim:
            if args.matcher == "learned":
                raise SystemExit(f"attention matcher was trained on {matcher.desc_dim}-d descriptors but the "
                                 f"selected detector produces {det_dim}-d; retrain or change --detector")
            matcher = None
    return detector, matcher, match_kw


def _cmd_reconstruct(args):
    """Unposed SfM from raw images (the run_reconstruction.py role): the
    camera inferred from the image size (SIMPLE_RADIAL, f = 1.2 max(w, h)),
    ``incremental_sfm`` with the mapper configuration of the JAX package's
    CLI, the model written to ``ref_sfm``. The learned components are
    resolved before anything is written."""
    import shutil

    from pixtrack_tpu_torch._device import resolve
    from pixtrack_tpu_torch.mapping.incremental import incremental_sfm
    from pixtrack_tpu_torch.pipelines.assets import layout
    from pixtrack_tpu_torch.sfm import colmap_io
    from pixtrack_tpu_torch.tracking.refiner import infer_camera_from_image
    from pixtrack_tpu_torch.utils.io import _list_images, _read_rgb

    device = resolve(args.device)
    detector, matcher, match_kw = _learned_components(args, device)

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
    # score / ratio (the dense descriptor's own), NMS scaled to the image
    # size, featuremetric KA and two featuremetric BA rounds unless
    # --no-featuremetric
    nms = 1 if max(h, w) <= 320 else (2 if max(h, w) <= 768 else 4)
    scene = incremental_sfm(
        images, cam_rec, names=names, verbose=args.verbose, max_keypoints=args.max_keypoints, nms_radius=nms,
        match_kw=match_kw, featuremetric_ka=not args.no_featuremetric,
        featuremetric_ba_rounds=0 if args.no_featuremetric else 2, matcher=matcher, detector=detector,
        device=device,
    )
    paths["ref_sfm"].mkdir(parents=True, exist_ok=True)
    scene.save(paths["ref_sfm"])
    print(f"reconstructed {len(scene.images)}/{len(images)} images, {len(scene.points3D)} points -> {paths['ref_sfm']}")


def _object_assets(object_path, device, tighten: bool, aabb=None):
    """(scene, nerf2sfm, testbed) of an object folder: the augmented model,
    its NeRF transform, and the snapshot baked on ``device`` with the crop
    box ``aabb``, by default that of the model's points (``tighten`` sweeps
    the occupied bounds)."""
    from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
    from pixtrack_tpu_torch.mapping.nerf_dataset import estimate_aabb_from_scene
    from pixtrack_tpu_torch.nerf.testbed import initialize_testbed
    from pixtrack_tpu_torch.pipelines.assets import layout
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    paths = layout(object_path)
    scene = SceneModel.load(paths["aug_sfm"])
    tf = NerfTransform.load(paths["nerf2sfm"])
    aabb = aabb or estimate_aabb_from_scene(scene, tf)
    testbed = initialize_testbed(paths["snapshot"], aabb=aabb, tighten=tighten, device=device)
    return scene, tf, testbed


def _cmd_track(args):
    """The flagship tracker over a query folder: ``poses.pkl`` and
    ``trackers.pkl`` in ``--out_dir``, the tracker's stats printed."""
    from pixtrack_tpu_torch._device import resolve
    from pixtrack_tpu_torch.tracking import PixTrackTracker
    from pixtrack_tpu_torch.utils.config import ObjectConfig, RunConfig, load_config
    from pixtrack_tpu_torch.utils.io import ImageIterator

    device = resolve(args.device)
    if args.config:
        obj_cfg, run_cfg = load_config(args.config)
    else:
        obj_cfg, run_cfg = ObjectConfig(), RunConfig()
    if args.object_path:
        obj_cfg.object_path = args.object_path
    # tighten: a one-time occupied-bounds sweep, so that every per-frame
    # reference render spends its samples on the object
    scene, tf, testbed = _object_assets(obj_cfg.object_path, device, tighten=True, aabb=obj_cfg.aabb)
    tracker = PixTrackTracker(scene, run_cfg.make_extractor(device), testbed, tf, run_cfg.tracker_config(obj_cfg),
                              align_cfg=run_cfg.align_config(), eval_path=args.out_dir)
    frames = ImageIterator(args.query, max_frames=args.frames)
    tracker.run(frames, max_frames=args.frames)
    tracker.save_poses()
    print(json.dumps(tracker.stats))


def _cmd_track_batch(args):
    """Several videos at once (``parallel/video.py``): each timestep refines
    every video's current frame in one batched step; each video's pose chain
    is its own. The cold start is the upright reference pose for every
    video. Writes ``poses_{b:02d}.pkl`` per video and prints the JAX
    package's summary keys."""
    import pickle

    from pixtrack_tpu_torch._device import resolve
    from pixtrack_tpu_torch.geometry import Pose
    from pixtrack_tpu_torch.parallel.video import make_production_video_tracker, track_video_batch
    from pixtrack_tpu_torch.tracking.refiner import infer_camera_from_image
    from pixtrack_tpu_torch.utils.config import ObjectConfig, RunConfig, load_config
    from pixtrack_tpu_torch.utils.io import ImageIterator

    if args.devices > 1:
        raise SystemExit("track-batch: the port runs on one card; its batch is the tensors' leading axis "
                         f"(--devices {args.devices} asked for a mesh)")
    device = resolve(args.device)
    if args.config:
        obj_cfg, run_cfg = load_config(args.config)
    else:
        obj_cfg, run_cfg = ObjectConfig(), RunConfig()
    if args.object_path:
        obj_cfg.object_path = args.object_path
    scene, tf, testbed = _object_assets(obj_cfg.object_path, device, tighten=False, aabb=obj_cfg.aabb)

    videos = [list(ImageIterator(q, max_frames=args.frames)) for q in args.query]
    if not videos or not all(videos):
        raise SystemExit("track-batch: every --query folder needs frames")
    camera = infer_camera_from_image(videos[0][0][1], device=device)
    run = make_production_video_tracker(testbed, tf, run_cfg.make_extractor(device), scene, camera,
                                        reference_scale=run_cfg.reference_scale, align_cfg=run_cfg.align_config())

    # lockstep batch: a shorter video is padded by repeating its last frame
    T_len = max(len(v) for v in videos)
    batch = np.stack([np.stack([np.asarray(v[min(k, len(v) - 1)][1], np.float32) / 255.0 for k in range(T_len)])
                      for v in videos])
    ref_name = obj_cfg.upright_ref_img or scene.names[0]
    T0 = scene.pose_w2c(scene.name2id[ref_name])
    B = len(videos)
    R0 = np.tile(T0.R.numpy().astype(np.float32), (B, 1, 1))
    t0 = np.tile(T0.t.numpy().astype(np.float32), (B, 1))
    out = track_video_batch(run, R0, t0, batch)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for b, vid in enumerate(videos):
        poses = {}
        for k, (name, _) in enumerate(vid):
            T = Pose.from_Rt(out["R"][k, b], out["t"][k, b])
            poses[str(name).split("/")[-1]] = {
                "success": bool(np.isfinite(out["cost"][k, b])),
                "T_refined": T.to_4x4().numpy(),
                "cost": float(out["cost"][k, b]),
                "query_path": str(name),
            }
        with open(out_dir / f"poses_{b:02d}.pkl", "wb") as f:
            pickle.dump(poses, f)
    print(json.dumps({
        "n_videos": B,
        "n_frames": int(T_len),
        "mesh": {"dp": 1, "tp": 1},
        "mean_cost_final": float(np.mean(out["cost"][-1])),
    }))


def _cmd_track_ycb(args):
    """The YCB-Video evaluation run: the YCB tracker over one video's
    frames, its summary printed."""
    from pixtrack_tpu_torch._device import resolve
    from pixtrack_tpu_torch.tracking.tracker_ycb import YCBTracker, ycb_tracker_config
    from pixtrack_tpu_torch.utils.config import RunConfig
    from pixtrack_tpu_torch.utils.io import YCBVideoIterator, parse_frame_range

    device = resolve(args.device)
    scene, tf, testbed = _object_assets(args.object_path, device, tighten=True)
    run_cfg = RunConfig()
    video, frame_range = parse_frame_range(args.query, 10000)
    it = YCBVideoIterator(args.ycb_root, video, args.object_name, frame_range, device=device)
    tracker = YCBTracker(scene, run_cfg.make_extractor(device), testbed, tf, ycb_tracker_config(),
                         align_cfg=run_cfg.align_config(), eval_path=args.out_dir)
    tracker.run(it)
    tracker.save_poses()
    print(json.dumps(tracker.summary()))


def _cmd_visualize(args):
    """Pose overlays of a ``poses.pkl`` (and an mp4 of them with --video)."""
    from pixtrack_tpu_torch._device import resolve
    from pixtrack_tpu_torch.viz.overlay import render_pose_overlays, write_video

    scene, tf, testbed = _object_assets(args.object_path, resolve(args.device), tighten=False)
    written = render_pose_overlays(args.poses, scene, testbed, tf, args.out_dir,
                                   object_center=np.asarray(scene.xyz).mean(axis=0))
    if args.video:
        write_video(written, Path(args.out_dir) / "overlay.mp4", fps=30)
    print(f"wrote {len(written)} overlays to {args.out_dir}")


def _cmd_eval(args):
    """Trajectory metrics of the entries of a ``poses.pkl`` that carry a ``gt_pose``."""
    import pickle

    from pixtrack_tpu_torch.eval.metrics import evaluate_trajectory

    with open(args.poses, "rb") as f:
        poses = pickle.load(f)
    est, gt = [], []
    for rec in poses.values():
        if "gt_pose" not in rec:
            continue
        est.append((rec["T_refined"][:3, :3], rec["T_refined"][:3, 3]))
        gt.append((rec["gt_pose"][:3, :3], rec["gt_pose"][:3, 3]))
    if not est:
        print(json.dumps({"error": "poses.pkl has no gt_pose entries"}))
        return
    print(json.dumps(evaluate_trajectory(est, gt), indent=2))


def _cmd_demo(args):
    """Synthetic end-to-end run with no data: world -> track -> eval (the
    world of ``pipelines/demo_world.py``, 128 px, the JAX package's tracker
    settings)."""
    from pixtrack_tpu_torch._device import resolve
    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.eval.metrics import evaluate_trajectory
    from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
    from pixtrack_tpu_torch.pipelines.demo_world import build_world
    from pixtrack_tpu_torch.tracking import PixTrackTracker, TrackerConfig

    device = resolve(args.device)
    scene, testbed, nerf2sfm, camera, gt, frames = build_world(res=128, n_frames=args.frames or 6, device=device)
    tracker = PixTrackTracker(
        scene, FeatureExtractor(HandcraftedExtractor(device=device), resize=None), testbed, nerf2sfm,
        TrackerConfig(reference_scale=1.0, cold_multiscale=(1,), covis_threshold=10, cost_threshold_min=0.05,
                      refine_rounds=2),
        align_cfg=AlignConfig(num_iters=60, robust_c=1.0), eval_path=args.out_dir)
    tracker.camera = camera
    tracker.run(frames)
    if args.out_dir:
        tracker.save_poses()
    est, gtl = [], []
    for i, (name, _) in enumerate(frames):
        T = np.asarray(tracker.pose_history[name]["T_refined"])
        est.append((T[:3, :3], T[:3, 3]))
        gtl.append((gt[i].R.cpu().numpy(), gt[i].t.cpu().numpy()))
    print(json.dumps(evaluate_trajectory(est, gtl), indent=2))


def _cmd_bench(args):
    raise SystemExit("bench: the port has no benchmark yet; bench.py measures the JAX package and is not run "
                     "from here")


def _cmd_extract_frames(args):
    """Video -> frame folder (colmap2ingp's ffmpeg role, through cv2)."""
    import cv2

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cap = cv2.VideoCapture(args.video)
    i = saved = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % args.every == 0:
            cv2.imwrite(str(out / f"frame_{saved:05d}.png"), frame)
            saved += 1
        i += 1
    cap.release()
    print(f"extracted {saved} frames -> {out}")


def _cmd_convert_images(args):
    """Batch image conversion (Convert_HEIC_to_PNG.ipynb's role)."""
    from pixtrack_tpu_torch.utils.image_convert import convert_images

    n = convert_images(args.src_dir, args.out_dir, to=args.to, exts=args.ext if args.ext else None)
    print(f"converted {n} images -> {args.out_dir} ({args.to})")


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

    s = sub.add_parser("track", help="track a query image folder")
    s.add_argument("--object_path")
    s.add_argument("--config")
    s.add_argument("--query", required=True)
    s.add_argument("--out_dir", default="out")
    s.add_argument("--frames", type=int)
    s.set_defaults(fn=_cmd_track)

    s = sub.add_parser("track-batch", help="track several videos at once, batched on the one card")
    s.add_argument("--object_path", required=True)
    s.add_argument("--query", nargs="+", required=True, help="one frames dir per video")
    s.add_argument("--config")
    s.add_argument("--out_dir", default="out_batch")
    s.add_argument("--frames", type=int, default=None)
    s.add_argument("--devices", type=int, default=0, help="one device only: more than 1 raises")
    s.set_defaults(fn=_cmd_track_batch)

    s = sub.add_parser("track-ycb", help="YCB-Video evaluation")
    s.add_argument("--object_path", required=True)
    s.add_argument("--ycb_root", required=True)
    s.add_argument("--object_name", default="003_cracker_box")
    s.add_argument("--query", default="0000/:")
    s.add_argument("--out_dir", default="out_ycb")
    s.set_defaults(fn=_cmd_track_ycb)

    s = sub.add_parser("visualize", help="render pose overlays")
    s.add_argument("--object_path", required=True)
    s.add_argument("--poses", required=True)
    s.add_argument("--out_dir", default="results")
    s.add_argument("--video", action="store_true")
    s.set_defaults(fn=_cmd_visualize)

    s = sub.add_parser("eval", help="trajectory metrics from poses.pkl")
    s.add_argument("--poses", required=True)
    s.set_defaults(fn=_cmd_eval)

    s = sub.add_parser("demo", help="synthetic end-to-end smoke run")
    s.add_argument("--frames", type=int, default=6)
    s.add_argument("--out_dir")
    s.set_defaults(fn=_cmd_demo)

    s = sub.add_parser("bench", help="the benchmark (the port has none yet: stops with a message)")
    s.set_defaults(fn=_cmd_bench)

    s = sub.add_parser("reconstruct", help="unposed SfM from raw images (run_reconstruction)")
    s.add_argument("--object_path", required=True)
    s.add_argument("--images", help="source image folder (copied to mapping/)")
    s.add_argument("--verbose", action="store_true")
    s.add_argument("--no-featuremetric", action="store_true", help="skip featuremetric keypoint adjustment (pixsfm KA)")
    s.add_argument("--max_keypoints", type=int, default=1024, help="detector budget per image (hloc superpoint_max role)")
    s.add_argument("--matcher", choices=("auto", "nn", "learned"), default="auto",
                   help="pair matcher: trained attention matcher if its checkpoint ships (auto), mutual-NN+ratio "
                        "(nn), or require the learned one (learned)")
    s.add_argument("--detector", choices=("auto", "harris", "superpoint", "dense"), default="auto",
                   help="keypoint detector: trained SuperPoint if its checkpoint ships (auto), multi-scale Harris "
                        "(harris), require SuperPoint (superpoint), or Harris keypoints + the shipped InfoNCE "
                        "dense descriptor (dense)")
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

    s = sub.add_parser("extract-frames", help="video -> frame folder")
    s.add_argument("--video", required=True)
    s.add_argument("--out_dir", required=True)
    s.add_argument("--every", type=int, default=1)
    s.set_defaults(fn=_cmd_extract_frames)

    s = sub.add_parser("convert-images", help="batch-convert images (HEIC->PNG notebook role)")
    s.add_argument("src_dir")
    s.add_argument("out_dir")
    s.add_argument("--to", default="png", help="target format (default png)")
    s.add_argument("--ext", nargs="*", default=None, help="restrict source extensions (e.g. --ext heic jpg)")
    s.set_defaults(fn=_cmd_convert_images)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
