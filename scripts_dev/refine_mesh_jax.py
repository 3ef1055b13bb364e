"""The JAX package's SfM refinement of the mesh world's rig, on the CPU.

The reference that ``chip_smoke.py`` phases 26-28 hold the port to. It
rebuilds the JAX package's model of the shipped rig as
``scripts_dev/sfm_from_obj_jax.py`` does (``create_scene_from_mesh`` on
``assets/mesh_world/src/house.obj``, 448 px, focal 450, ``subdiv=1``: 42
views), then runs on it, in the JAX package:

- phase 26: ``bundle_adjust_scene(iters=20)`` (what ``bundle-adjust`` runs),
  and ``bundle_adjust_scene(iters=PERTURB_ITERS)`` of the copy that
  ``chip_smoke.perturb_scene`` perturbs (the same numpy draw);
- phase 27: ``refine_scene_keypoints``, ``bundle_adjust_scene``,
  ``featuremetric_ba(rounds=2)``, with ``FeatureExtractor(HandcraftedExtractor(),
  resize=1024)``;
- phase 28: ``refine_tracks_photometric``, then ``bundle_adjust_scene``.

Two things are wrapped, neither changing a number. JAX's
``point_adjustment`` samples its (points, views) grid under a double
``vmap`` of a gather of whole feature maps, which XLA on the CPU
materialises: 80 GB for the 1137 points of this rig. Each point's LM is
independent of the others', so it is called here on chunks of
``PA_CHUNK`` points (with the images those points are seen in) and the
results stacked. And the extractor is memoised per image, so the chunks do
not extract the same pyramids again; the pyramids are the same numbers.
The wall times are therefore the JAX package's on the CPU with those two
wrappers, and are labelled so.

    JAX_PLATFORMS=cpu python scripts_dev/refine_mesh_jax.py [model_dir]

Writes ``scripts_dev/refine_mesh_jax.npz``: per stage (``ba_cli``,
``ba_perturbed``, ``fm``, ``photometric``) each view's rotation error
against the truth (deg, in the truth's name order), the median reprojection
error, the points without BA's scale gauge, and the seconds; the model's
reprojection median as built, and the share of observations that the
photometric refinement moved. With ``model_dir`` it also writes JAX's model
as built there, and its renders as ``images.npz``, so that the port can be
run over the same model. Prints one JSON line.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "scripts_dev" / "refine_mesh_jax.npz"
IMAGE_SIZE, FOCAL, SUBDIV = 448, 450.0, 1
PA_CHUNK = 32


def chunked(point_adjustment, scene_cls):
    """``point_adjustment`` over chunks of points: per point the same LM."""
    def run(scene, images, extractor, cfg=None, max_views=8):
        out = np.zeros((len(scene.point_ids), 3))
        for s in range(0, len(scene.point_ids), PA_CHUNK):
            pids = [int(p) for p in scene.point_ids[s:s + PA_CHUNK]]
            sub = scene_cls(scene.cameras, scene.images, {p: scene.points3D[p] for p in pids})
            seen = {int(i) for p in pids for i in scene.points3D[p].image_ids}
            kw = {} if cfg is None else {"cfg": cfg}
            out[s:s + PA_CHUNK] = point_adjustment(sub, {i: im for i, im in images.items() if i in seen}, extractor,
                                                   max_views=max_views, **kw)
        return out
    return run


class Memo:
    """The extractor, once per image object."""

    def __init__(self, extractor):
        self.extractor, self.cache = extractor, {}

    def __call__(self, image):
        if id(image) not in self.cache:
            self.cache[id(image)] = (image, self.extractor(image))
        return self.cache[id(image)][1]


def main(model_dir=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import PERTURB_ITERS, perturb_scene, refine_outcome, reprojection_errors
    from pixtrack_tpu.features import FeatureExtractor, HandcraftedExtractor
    from pixtrack_tpu.mapping import featuremetric
    from pixtrack_tpu.mapping.bundle import bundle_adjust_scene
    from pixtrack_tpu.mapping.mesh_render import create_scene_from_mesh
    from pixtrack_tpu.mapping.track_refine import refine_tracks_photometric
    from pixtrack_tpu.sfm.scene import SceneModel

    featuremetric.point_adjustment = chunked(featuremetric.point_adjustment, SceneModel)
    diameter = float(json.loads((REPO / "assets" / "mesh_world" / "meta.json").read_text())["diameter"])
    scene, images = create_scene_from_mesh(REPO / "assets" / "mesh_world" / "src" / "house.obj",
                                           image_size=IMAGE_SIZE, focal=FOCAL, subdiv=SUBDIV)
    if model_dir:
        Path(model_dir).mkdir(parents=True, exist_ok=True)
        scene.save(model_dir)
        np.savez_compressed(Path(model_dir) / "images.npz", **{str(i): im for i, im in images.items()})
    res, seconds = {}, {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        res[name] = refine_outcome(out, scene)
        print(f"{name}: {seconds[name]:.1f} s, rotation error median/max {np.median(res[name]['rot']):.4f}/"
              f"{res[name]['rot'].max():.4f} deg, reprojection median {res[name]['reproj_med']:.4f} px", flush=True)
        return out

    stage("ba_cli", lambda: bundle_adjust_scene(scene, iters=20))
    stage("ba_perturbed", lambda: bundle_adjust_scene(perturb_scene(scene, diameter), iters=PERTURB_ITERS))
    ex = Memo(FeatureExtractor(HandcraftedExtractor(), resize=1024))
    stage("fm", lambda: featuremetric.featuremetric_ba(
        bundle_adjust_scene(featuremetric.refine_scene_keypoints(scene, images, ex)), images, ex, rounds=2))
    moved = {}

    def photometric():
        s = refine_tracks_photometric(scene, images)
        moved["share"] = s._track_refine_applied / int(scene.track_lengths.sum())
        return bundle_adjust_scene(s)

    stage("photometric", photometric)
    arrays = {"built_reproj_med": np.float64(np.median(reprojection_errors(scene))),
              "photometric_moved": np.float64(moved["share"])}
    for name, r in res.items():
        arrays.update({f"{name}_rot": r["rot"], f"{name}_reproj_med": np.float64(r["reproj_med"]),
                       f"{name}_xyz": r["xyz"], f"{name}_seconds": np.float64(seconds[name])})
    np.savez_compressed(OUT, **arrays)
    print(json.dumps({"points": len(scene.point_ids), "built_reproj_med": float(arrays["built_reproj_med"]),
                      "photometric_moved": moved["share"], "jax_cpu_seconds": seconds,
                      **{f"{k}_rot_med": float(np.median(r["rot"])) for k, r in res.items()},
                      **{f"{k}_rot_max": float(r["rot"].max()) for k, r in res.items()},
                      **{f"{k}_reproj_med": r["reproj_med"] for k, r in res.items()}}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
