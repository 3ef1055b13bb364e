"""The JAX package's unposed reconstruction of chip_smoke's rigs, on the CPU.

The reference that ``chip_smoke.py`` phases 30-33 hold the port to:

- ``arc SEED``: ``incremental_sfm`` on the 10-view arc of the textured cube
  at 192 px (tests/test_incremental_sfm.py::test_arc_10view_ka_subdegree:
  768 keypoints, ``nms_radius=1``, ``min_score=0.5``, ``ratio=0.98``, KA,
  ``featuremetric_ba_rounds=2``) with ``seed=SEED``; seeds 0-2 give the
  spread that sets phase 30's margin;
- ``cli [SEED]``: the JAX package's ``reconstruct`` subcommand over the
  same 10 images written as PNGs to a mapping folder (camera inferred, f =
  1.2 * max(w, h)); with SEED > 0, what the subcommand runs at that seed
  (it has no seed option), for the spread of phase 31's margin;
- ``ring SEED``: ``incremental_sfm`` on phase 32's capture of the house
  (``chip_smoke.ring_rig_poses``: 36 views on a ring at 448 px, focal 450)
  with its PINHOLE camera and the CLI's settings for that size (1024
  keypoints, ``nms_radius=2``), KA and two featuremetric BA rounds; seeds
  0-2 give its spread;
- ``merge``: the parts into ``scripts_dev/reconstruct_jax.npz``.

Each run's outcome is ``chip_smoke.rig_outcome`` against the rig's poses
(registered views, points, pairwise and global rotation medians, the centre
error as a fraction of the rig's radius, the mean reprojection error) and
its wall time; ``ring 0`` also keeps its model's COLMAP files (phase 33
tracks it). JAX's ``point_adjustment`` is called on chunks of 32 points, as
``scripts_dev/refine_mesh_jax.py`` does (the same numbers; whole, it
materialises tens of GB on the CPU).

    JAX_PLATFORMS=cpu python scripts_dev/reconstruct_jax.py arc 0
    JAX_PLATFORMS=cpu python scripts_dev/reconstruct_jax.py cli [SEED]
    JAX_PLATFORMS=cpu python scripts_dev/reconstruct_jax.py ring SEED
    python scripts_dev/reconstruct_jax.py merge

Each part writes ``scripts_dev/reconstruct_jax.<part>.npz`` and prints one
JSON line; ``merge`` folds them into the one npz and removes them. No images
and no random draws are kept.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))
OUT = REPO / "scripts_dev" / "reconstruct_jax.npz"
HOUSE_SIZE, HOUSE_FOCAL = 448, 450.0
OUTCOME_KEYS = ("registered", "points", "pairwise_deg", "global_deg", "centre_frac", "reproj_px")


def part_path(part: str) -> Path:
    return REPO / "scripts_dev" / f"reconstruct_jax.{part}.npz"


def setup():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from refine_mesh_jax import chunked

    from pixtrack_tpu.mapping import featuremetric
    from pixtrack_tpu.sfm.scene import SceneModel

    featuremetric.point_adjustment = chunked(featuremetric.point_adjustment, SceneModel)


def arc_views():
    """({id: image}, {name: (R, t)}, camera record) of the arc rig, rendered by JAX."""
    from chip_smoke import ARC_RES, arc_rig_poses
    from test_mesh_render import make_cube_obj

    from pixtrack_tpu.geometry import Camera, Pose
    from pixtrack_tpu.mapping.mesh_render import load_obj, render_mesh
    from pixtrack_tpu.sfm import colmap_io

    res = ARC_RES
    tmp = Path(tempfile.mkdtemp(prefix="reconstruct_jax_cube_"))
    mesh = load_obj(make_cube_obj(tmp))
    camera = Camera.pinhole(res * 1.1, res * 1.1, (res - 1) / 2, (res - 1) / 2, res, res)
    views, truth = {}, {}
    for iid, (R, t) in arc_rig_poses().items():
        views[iid] = render_mesh(mesh, Pose.from_Rt(R, t), camera)
        truth[f"view_{iid:04d}.png"] = (R, t)
    cam_rec = colmap_io.CameraRecord(1, "PINHOLE", res, res, np.array([res * 1.1, res * 1.1, res / 2.0, res / 2.0]))
    return views, truth, cam_rec


def outcome_arrays(prefix: str, out: dict, seconds: float) -> dict:
    arrays = {f"{prefix}_{k}": np.float64(out[k]) for k in OUTCOME_KEYS}
    arrays[f"{prefix}_names"] = np.asarray(out["names"])
    arrays[f"{prefix}_seconds"] = np.float64(seconds)
    return arrays


def run_arc(seed: int):
    setup()
    from chip_smoke import rig_outcome

    from pixtrack_tpu.mapping.incremental import incremental_sfm

    views, truth, cam_rec = arc_views()
    t0 = time.perf_counter()
    rec = incremental_sfm(views, cam_rec, max_keypoints=768, nms_radius=1, seed=seed,
                          match_kw=dict(min_score=0.5, ratio=0.98), featuremetric_ka=True,
                          featuremetric_ba_rounds=2)
    seconds = time.perf_counter() - t0
    out = rig_outcome(rec, truth)
    np.savez_compressed(part_path(f"arc{seed}"), **outcome_arrays(f"arc{seed}", out, seconds))
    print(json.dumps({"part": f"arc{seed}", "seconds": seconds, **{k: out[k] for k in OUTCOME_KEYS}}))


def cli_camera(h: int, w: int):
    """The camera the ``reconstruct`` subcommand infers for an h x w folder."""
    from pixtrack_tpu.sfm import colmap_io
    from pixtrack_tpu.tracking.refiner import infer_camera_from_image

    cam = infer_camera_from_image((h, w))
    return colmap_io.CameraRecord(1, "SIMPLE_RADIAL", w, h, np.array([float(cam.f[0]), w / 2.0, h / 2.0, 0.0]))


def run_cli_seed(seed: int):
    """What ``reconstruct`` runs over the arc's images, at ``seed`` (the
    subcommand itself has no seed: it runs seed 0)."""
    setup()
    from chip_smoke import rig_outcome

    from pixtrack_tpu.mapping.incremental import incremental_sfm

    views, truth, _ = arc_views()
    h, w = next(iter(views.values())).shape[:2]
    t0 = time.perf_counter()
    rec = incremental_sfm(views, cli_camera(h, w), max_keypoints=1024, nms_radius=1, seed=seed,
                          match_kw=dict(min_score=0.5, ratio=0.98), featuremetric_ka=True,
                          featuremetric_ba_rounds=2)
    seconds = time.perf_counter() - t0
    out = rig_outcome(rec, truth)
    np.savez_compressed(part_path(f"cli{seed}"), **outcome_arrays(f"cli{seed}", out, seconds))
    print(json.dumps({"part": f"cli{seed}", "seconds": seconds, **{k: out[k] for k in OUTCOME_KEYS}}))


def run_cli():
    setup()
    import cv2

    from chip_smoke import rig_outcome

    from pixtrack_tpu.pipelines import cli
    from pixtrack_tpu.pipelines.assets import layout
    from pixtrack_tpu.sfm.scene import SceneModel

    views, truth, _ = arc_views()
    work = Path(tempfile.mkdtemp(prefix="reconstruct_jax_cli_"))
    mapping = layout(work)["mapping"]
    mapping.mkdir(parents=True, exist_ok=True)
    for iid, img in views.items():
        cv2.imwrite(str(mapping / f"view_{iid:04d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    t0 = time.perf_counter()
    cli.main(["reconstruct", "--object_path", str(work)])
    seconds = time.perf_counter() - t0
    out = rig_outcome(SceneModel.load(layout(work)["ref_sfm"]), truth)
    np.savez_compressed(part_path("cli"), **outcome_arrays("cli", out, seconds))
    print(json.dumps({"part": "cli", "seconds": seconds, **{k: out[k] for k in OUTCOME_KEYS}}))


def ring_views():
    """({id: image}, {name: (R, t)}, {id: name}, camera record) of phase 32's
    ring of the house, rendered by JAX."""
    from chip_smoke import RING_FOCAL, RING_RES, ring_rig_poses

    from pixtrack_tpu.geometry import Camera, Pose
    from pixtrack_tpu.mapping.mesh_render import load_obj, render_mesh
    from pixtrack_tpu.sfm import colmap_io

    mesh = load_obj(REPO / "assets" / "mesh_world" / "src" / "house.obj")
    res, f = RING_RES, RING_FOCAL
    camera = Camera.pinhole(f, f, (res - 1) / 2, (res - 1) / 2, res, res)
    views, truth, names = {}, {}, {}
    for iid, (R, t) in ring_rig_poses(mesh["vertices"]).items():
        views[iid] = render_mesh(mesh, Pose.from_Rt(R, t), camera, background=(1, 1, 1))
        names[iid] = f"ring_{iid - 1:04d}.png"
        truth[names[iid]] = (R, t)
    cam_rec = colmap_io.CameraRecord(1, "PINHOLE", res, res, np.array([f, f, res / 2.0, res / 2.0]))
    return views, truth, names, cam_rec


def run_ring(seed: int = 0):
    setup()
    from chip_smoke import rig_outcome

    from pixtrack_tpu.mapping.incremental import incremental_sfm

    views, truth, names, cam_rec = ring_views()
    t0 = time.perf_counter()
    rec = incremental_sfm(views, cam_rec, names=names, max_keypoints=1024, nms_radius=2, seed=seed,
                          match_kw=dict(min_score=0.5, ratio=0.98), featuremetric_ka=True,
                          featuremetric_ba_rounds=2, verbose=True)
    seconds = time.perf_counter() - t0
    out = rig_outcome(rec, truth)
    part = f"ring{seed}"
    arrays = outcome_arrays(part, out, seconds)
    if seed == 0:  # the model that phase 33 tracks
        with tempfile.TemporaryDirectory() as d:
            rec.save(d)
            for f in ("cameras.bin", "images.bin", "points3D.bin"):
                arrays[f"ring_model_{f.split('.')[0]}"] = np.frombuffer((Path(d) / f).read_bytes(), np.uint8)
    np.savez_compressed(part_path(part), **arrays)
    print(json.dumps({"part": part, "seconds": seconds, **{k: out[k] for k in OUTCOME_KEYS}}))


def merge():
    parts = sorted(REPO.glob("scripts_dev/reconstruct_jax.*.npz"))
    arrays = dict(np.load(OUT)) if OUT.exists() else {}
    for p in parts:
        arrays.update(dict(np.load(p)))
    np.savez_compressed(OUT, **arrays)
    for p in parts:
        p.unlink()
    print(json.dumps({"merged": [p.name for p in parts], "keys": len(arrays)}))


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "arc":
        run_arc(int(sys.argv[2]))
    elif mode == "cli":
        if len(sys.argv) > 2 and int(sys.argv[2]) > 0:
            run_cli_seed(int(sys.argv[2]))
        else:
            run_cli()
    elif mode == "ring":
        run_ring(int(sys.argv[2]))
    elif mode == "merge":
        merge()
    else:
        raise SystemExit(f"unknown mode {mode!r}: arc SEED | cli [SEED] | ring SEED | merge")
