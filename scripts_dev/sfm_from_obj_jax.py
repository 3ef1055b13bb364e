"""The JAX package's SfM model of the mesh world's rig, built on the CPU.

The reference that ``chip_smoke.py`` phase 22 holds the port's
``sfm-from-obj`` to: ``mapping/mesh_render.py::create_scene_from_mesh`` on
the shipped ``assets/mesh_world/src/house.obj`` at the shipped rig (448 px,
focal 450, ``subdiv=1``: 42 views, 861 exhaustive pairs), run by the JAX
package on the CPU (about three minutes on 8 cores). The card has no JAX, so
the model's points are written to a small committed file that chip_smoke
reads:

    JAX_PLATFORMS=cpu python scripts_dev/sfm_from_obj_jax.py [out_model_dir]

Writes ``scripts_dev/sfm_from_obj_jax.npz`` (xyz (M, 3) f64, the per-point
reprojection errors and track lengths) and, when ``out_model_dir`` is given,
the COLMAP model there too (``scripts_dev/fused_mesh_rebuilt_jax_chains.py``
augments it). Prints the point count, the mean reprojection error, the
track lengths and the shares of points within 1e-3 and 1e-4 (scene units)
of a point of the shipped ``aug_sfm``, both ways; then one JSON line.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "scripts_dev" / "sfm_from_obj_jax.npz"
IMAGE_SIZE, FOCAL, SUBDIV = 448, 450.0, 1


def shares(a: np.ndarray, b: np.ndarray) -> dict:
    """chip_smoke's shares of ``a`` within 1e-3 and 1e-4 of ``b``, and the
    median distance to the nearest point of ``b``."""
    from scipy.spatial import cKDTree

    from chip_smoke import nearest_shares

    return {f"{t:g}": v for t, v in nearest_shares(a, b).items()} | {"median": float(np.median(cKDTree(b).query(a)[0]))}


def main(out_model=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pixtrack_tpu.mapping.mesh_render import create_scene_from_mesh
    from pixtrack_tpu.sfm.scene import SceneModel

    t0 = time.perf_counter()
    scene, _ = create_scene_from_mesh(REPO / "assets" / "mesh_world" / "src" / "house.obj",
                                      image_size=IMAGE_SIZE, focal=FOCAL, subdiv=SUBDIV)
    seconds = time.perf_counter() - t0
    if out_model:
        Path(out_model).mkdir(parents=True, exist_ok=True)
        scene.save(out_model)
    np.savez_compressed(OUT, xyz=scene.xyz, errors=scene.point_errors, track_lengths=scene.track_lengths)
    shipped = SceneModel.load(REPO / "assets" / "mesh_world" / "aug_sfm")
    res = {
        "views": len(scene.image_ids), "points": len(scene.point_ids), "seconds": seconds,
        "mean_reproj_px": float(scene.point_errors.mean()),
        "track_length_mean": float(scene.track_lengths.mean()),
        "track_length_max": int(scene.track_lengths.max()),
        "shipped_points": len(shipped.point_ids),
        "to_shipped": shares(scene.xyz, shipped.xyz),
        "from_shipped": shares(shipped.xyz, scene.xyz),
    }
    print(f"JAX on the CPU: {res['views']} views, {res['points']} points in {seconds:.1f} s; mean reprojection "
          f"error {res['mean_reproj_px']:.3f} px; track length mean {res['track_length_mean']:.2f}, max "
          f"{res['track_length_max']}; against the shipped model ({res['shipped_points']} points): "
          f"{res['to_shipped']} of its points near a shipped one, {res['from_shipped']} the other way", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
