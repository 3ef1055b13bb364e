"""Asset-creation pipeline stages over the reference's artifact layout.

Port of ``pixtrack_tpu/pipelines/assets.py``: ``sfm-from-obj`` (through
``mapping/mesh_render.py::create_scene_from_mesh``) and the stages after it,
each a function over ``<object_path>/pixtrack/...``: the NeRF transform and
``transforms.json``, training the hash-grid NeRF, re-rendering the views
from it and triangulating them again (``nerf-sfm``), and the rotation
augmentation with its database and covisibility. Detection, matching and
triangulation run on ``device`` (None is the CUDA card); the descriptors
stay there and only the match vectors come back to the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.geometry import Camera, Pose
from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
from pixtrack_tpu_torch.mapping.augment import augment_scene
from pixtrack_tpu_torch.mapping.detector import detect_and_describe
from pixtrack_tpu_torch.mapping.matcher import epipolar_filter, exhaustive_pairs, match_descriptors
from pixtrack_tpu_torch.mapping.nerf_dataset import (
    compute_nerf_transform,
    estimate_aabb_from_scene,
    write_transforms_json,
)
from pixtrack_tpu_torch.mapping.triangulate import triangulate_scene
from pixtrack_tpu_torch.sfm import colmap_io, feature_store
from pixtrack_tpu_torch.sfm.database import create_db_from_scene
from pixtrack_tpu_torch.sfm.scene import SceneModel


def layout(object_path) -> Dict[str, Path]:
    """The reference artifact layout under <object_path>/pixtrack."""
    root = Path(object_path) / "pixtrack"
    return {
        "root": root,
        "mapping": root / "pixsfm" / "dataset" / "mapping",
        "transforms": root / "pixsfm" / "dataset" / "transforms.json",
        "nerf2sfm": root / "pixsfm" / "dataset" / "nerf2sfm.pkl",
        "ref_sfm": root / "pixsfm" / "outputs" / "ref",
        "snapshot": root / "instant-ngp" / "snapshots" / "weights.msgpack",
        "nerf_sfm_dir": root / "nerf_sfm",
        "nerf_sfm_mapping": root / "nerf_sfm" / "mapping",
        "nerf_sfm": root / "nerf_sfm" / "ref",
        "features": root / "nerf_sfm" / "features.h5",
        "matches": root / "nerf_sfm" / "matches.h5",
        "aug_sfm": root / "aug_nerf_sfm" / "aug_sfm",
        "aug_db": root / "aug_nerf_sfm" / "aug_sfm" / "database.db",
    }


def detect_match_views(images: Dict[int, np.ndarray], poses: Dict[int, Pose], camera: Camera,
                       max_keypoints: int = 1024, nms_radius: int = 2, features_h5: Optional[Path] = None,
                       matches_h5: Optional[Path] = None, names: Optional[Dict[int, str]] = None, device=None):
    """Detect, describe and exhaustively match posed views, each match
    vector filtered by the epipolar geometry of the known poses. Returns
    (keypoints, matches) dicts on the host (corner-convention keypoints)."""
    dev = resolve(device)
    kps, descs = {}, {}
    for iid, img in images.items():
        kp, sc, d = detect_and_describe(img, max_keypoints=max_keypoints, nms_radius=nms_radius, device=dev)
        kps[iid] = kp.cpu().numpy() + 0.5
        descs[iid] = d
        if features_h5 is not None and names:
            feature_store.write_features(features_h5, names[iid], kps[iid], d.cpu().numpy(), sc.cpu().numpy(),
                                         image_size=(img.shape[1], img.shape[0]))
    K = camera.K().cpu().numpy().astype(np.float64)
    matches = {}
    for (a, b) in exhaustive_pairs(sorted(images.keys())):
        m0, s0 = match_descriptors(descs[a], descs[b])
        Tab = poses[b] @ poses[a].inv()
        m0 = epipolar_filter(kps[a] - 0.5, kps[b] - 0.5, m0, K, K, Tab.R.cpu().numpy().astype(np.float64),
                             Tab.t.cpu().numpy().astype(np.float64))
        matches[(a, b)] = m0
        if matches_h5 is not None and names:
            feature_store.write_matches(matches_h5, names[a], names[b], m0, s0)
    return kps, matches


def reconstruct_from_posed_views(images: Dict[int, np.ndarray], poses: Dict[int, Pose],
                                 camera_rec: colmap_io.CameraRecord, names: Optional[Dict[int, str]] = None,
                                 out_dir: Optional[Path] = None, device=None, **detect_kw) -> SceneModel:
    """Triangulation against known poses (the mesh renders and the NeRF
    re-renders always have them): detect, match, triangulate, and save the
    model to ``out_dir`` when given."""
    camera = Camera.from_colmap(camera_rec.model, camera_rec.params, camera_rec.width, camera_rec.height)
    names = names or {iid: f"view_{iid:04d}.png" for iid in images}
    kps, matches = detect_match_views(images, poses, camera, names=names, device=device, **detect_kw)
    image_meta = {}
    for iid, T in poses.items():
        q, t = T.to_quat_t()
        image_meta[iid] = {"name": names[iid], "qvec": q.cpu().numpy(), "tvec": t.cpu().numpy(),
                           "camera_id": camera_rec.camera_id}
    scene = triangulate_scene(image_meta, kps, matches, {camera_rec.camera_id: camera_rec}, device=device)
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        scene.save(out_dir)
    return scene


def build_nerf_assets(scene: SceneModel, object_path, aabb_scale: int = 4):
    """The NeRF transform of the scene's rig, ``transforms.json`` and
    ``nerf2sfm.pkl`` written, and the grid-space crop box."""
    paths = layout(object_path)
    tf = compute_nerf_transform(scene)
    paths["transforms"].parent.mkdir(parents=True, exist_ok=True)
    write_transforms_json(scene, tf, paths["transforms"], aabb_scale=aabb_scale)
    tf.save(paths["nerf2sfm"])
    return tf, estimate_aabb_from_scene(scene, tf)


def train_nerf_asset(object_path, n_steps: int = 10000, downscale: int = 1, batch_rays: int = 1 << 14,
                     save_every: int = 0, resume: bool = False, verbose: bool = False, devices: int = 0,
                     tp: int = 1, n_coarse: int = 64, n_fine: int = 32, device=None):
    """Train the hash-grid NeRF on transforms.json and snapshot it, on
    ``device`` (None is the CUDA card). ``save_every`` > 0 checkpoints the
    snapshot every that many steps; ``resume`` warm-starts from an existing
    snapshot. ``devices`` > 1 runs the same loop in that many processes
    over a (dp, tp) mesh, dp = devices / tp (``parallel/mesh.py``: rank r
    on ``cuda:r``, or gloo on the CPU); rank 0 writes the snapshots. 0 or 1
    is one device, with no process group. Returns (field, info)."""
    from pixtrack_tpu_torch.nerf.snapshot import load_snapshot

    dev = resolve(device)
    paths = layout(object_path)
    if devices and devices > 1:
        from pixtrack_tpu_torch.parallel.mesh import check_devices, cpu_threads, launch

        check_devices(devices, tp, dev)
    if not paths["transforms"].exists():
        # colmap2ingp: convert the SfM model before training when it hasn't been
        build_nerf_assets(SceneModel.load(paths["ref_sfm"]), object_path)
    paths["snapshot"].parent.mkdir(parents=True, exist_ok=True)
    kw = dict(n_steps=n_steps, downscale=downscale, batch_rays=batch_rays, save_every=save_every, resume=resume,
              verbose=verbose)
    if not (devices and devices > 1):
        return _train_nerf(object_path, dev, None, n_coarse=n_coarse, n_fine=n_fine, **kw)
    info = launch(_train_nerf_rank, devices, object_path, devices, tp, dev.type,
                  dict(n_coarse=n_coarse, n_fine=n_fine, **kw),
                  threads=cpu_threads(devices) if dev.type == "cpu" else None)
    return load_snapshot(paths["snapshot"], device=dev)[0], info


def _train_nerf_rank(object_path, devices: int, tp: int, kind: str, kw: dict) -> dict:
    """One rank of ``train_nerf_asset`` over the mesh; returns the info."""
    from pixtrack_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices, tp, kind)
    return _train_nerf(object_path, mesh.device, mesh, **kw)[1]


def _train_nerf(object_path, dev, mesh, n_steps, downscale, batch_rays, save_every, resume, verbose, n_coarse,
                n_fine):
    from pixtrack_tpu_torch.nerf.dataset import NerfDataset
    from pixtrack_tpu_torch.nerf.snapshot import load_snapshot, save_snapshot
    from pixtrack_tpu_torch.nerf.train import TrainConfig, train

    paths = layout(object_path)
    ds = NerfDataset.from_transforms(paths["transforms"], downscale=downscale)
    aabb = estimate_aabb_from_scene(SceneModel.load(paths["ref_sfm"]), NerfTransform.load(paths["nerf2sfm"]))
    field = load_snapshot(paths["snapshot"], device=dev)[0] if resume and paths["snapshot"].exists() else None

    # the callback fires on log_every boundaries, so a save_every below it
    # would otherwise never checkpoint
    log_every = min(500, save_every) if save_every else 500

    def checkpoint(done, loss, fld):
        if verbose:
            print(f"  nerf train step {done}: loss {loss:.5f}", flush=True)
        if save_every and done % save_every < log_every:
            save_snapshot(paths["snapshot"], fld, extra={"aabb": aabb, "steps_done": done})

    cfg = TrainConfig(n_steps=n_steps, batch_rays=batch_rays, n_coarse=n_coarse, n_fine=n_fine,
                      log_every=log_every)
    field, info = train(ds, aabb, cfg, field=field, callback=checkpoint if (save_every or verbose) else None,
                        device=dev, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        save_snapshot(paths["snapshot"], field, extra={"aabb": aabb})
    return field, info


def create_nerf_sfm(object_path, spp: int = 2, max_keypoints: int = 1024, write_h5: bool = True, device=None):
    """Re-render every view of ``ref_sfm`` from the trained NeRF (the baked
    hash field), detect and match on the renders and triangulate them
    against the reference poses; writes the renders, the model and (with
    ``write_h5``, which needs h5py) features.h5 and matches.h5."""
    from pixtrack_tpu_torch.mapping.mesh_render import write_png
    from pixtrack_tpu_torch.nerf.testbed import initialize_testbed
    from pixtrack_tpu_torch.tracking.render_bridge import render_nerf_view

    if write_h5:
        try:
            import h5py  # noqa: F401
        except ImportError as e:
            raise RuntimeError("nerf-sfm writes features.h5 and matches.h5 through h5py, which is not installed; "
                               "turn the h5 files off (write_h5=False, --no_h5) to run without them") from e
    dev = resolve(device)
    paths = layout(object_path)
    scene = SceneModel.load(paths["ref_sfm"])
    tf = NerfTransform.load(paths["nerf2sfm"])
    testbed = initialize_testbed(paths["snapshot"], aabb=estimate_aabb_from_scene(scene, tf), device=dev)
    paths["nerf_sfm_mapping"].mkdir(parents=True, exist_ok=True)

    images, poses, names = {}, {}, {}
    cam_id = next(iter(scene.cameras))
    camera = scene.camera(cam_id)
    for iid in scene.image_ids:
        iid = int(iid)
        T = scene.pose_w2c(iid)
        img = render_nerf_view(testbed, tf, T, camera, spp=spp)
        name = scene.images[iid].name
        write_png(paths["nerf_sfm_mapping"] / name, img)
        images[iid], poses[iid], names[iid] = img, T, name
    return reconstruct_from_posed_views(
        images, poses, scene.cameras[cam_id], names=names, out_dir=paths["nerf_sfm"], max_keypoints=max_keypoints,
        features_h5=paths["features"] if write_h5 else None, matches_h5=paths["matches"] if write_h5 else None,
        device=dev)


def augment_assets(object_path, angles=tuple(range(30, 360, 30)), device=None):
    """Rotation augmentation -> aug_sfm + database.db + covis.pkl, of
    nerf_sfm where it exists, else of ref_sfm; the poses rolled on
    ``device`` (None is the CUDA card)."""
    paths = layout(object_path)
    src = paths["nerf_sfm"] if paths["nerf_sfm"].exists() else paths["ref_sfm"]
    aug = augment_scene(SceneModel.load(src), angles=angles, device=device)
    paths["aug_sfm"].mkdir(parents=True, exist_ok=True)
    aug.save(paths["aug_sfm"])
    create_db_from_scene(aug, paths["aug_db"]).close()
    aug.save_covisibility(paths["aug_sfm"] / "covis.pkl")
    # query-list stub for reference-layout parity (augment_sfm.py:87-88)
    (paths["aug_sfm"].parent / "query_with_intrinsics.txt").touch()
    return aug
