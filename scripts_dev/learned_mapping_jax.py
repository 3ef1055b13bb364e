"""The JAX package's learned SfM components on chip_smoke's rigs, on the CPU.

The reference that ``chip_smoke.py`` phases 39-40 hold the port to:

- ``ab``: the deployment A/B behind ``assets/dense_descriptor_eval.json``'s
  ``deployment_ab_seed31`` (``scripts_dev/train_dense_descriptor_run.py``'s
  protocol): ``build_mesh_pair_bank`` at seed 31, 2 scenes x 12 views, 192
  px, 256 keypoints, pairs 20-52 degrees apart, once with the patch
  descriptor and once with the shipped dense descriptor sampled at the same
  Harris keypoints; mutual-NN + ratio matching, the patch at (min_score 0.5,
  ratio 0.98), the dense descriptor at its shipped operating point (0.1,
  0.98); correct / proposed / possible matches of each;
- ``dense SEED``: what ``reconstruct --detector dense`` runs over chip_smoke's
  arc rig (phase 30's 10 views of the textured cube at 192 px, written as
  PNGs and read back losslessly): ``incremental_sfm`` with the inferred
  camera (SIMPLE_RADIAL, f = 1.2 * 192), 1024 keypoints, ``nms_radius=1``,
  the dense descriptor's ``match_kw``, KA and two featuremetric BA rounds, at
  ``seed=SEED`` (the subcommand itself runs seed 0); phase 40 holds the
  port's seeds 0-7 to JAX's seeds 0-7 (~13 min a seed on an 8-core CPU,
  several side by side);
- ``merge``: the parts into ``scripts_dev/learned_mapping_jax.json``.

    JAX_PLATFORMS=cpu python scripts_dev/learned_mapping_jax.py ab
    JAX_PLATFORMS=cpu python scripts_dev/learned_mapping_jax.py dense SEED
    python scripts_dev/learned_mapping_jax.py merge

Each part writes ``scripts_dev/learned_mapping_jax.<part>.json`` and prints
it; ``merge`` folds them into the one file and removes them.
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
sys.path.insert(0, str(REPO / "scripts_dev"))
OUT = REPO / "scripts_dev" / "learned_mapping_jax.json"
AB = dict(n_scenes=2, n_views=12, res=192, max_kp=256, min_deg=20.0, max_deg=52.0, seed=31)
AB_MATCH = {"patch": (0.5, 0.98), "learned": (0.1, 0.98)}


def part_path(part: str) -> Path:
    return REPO / "scripts_dev" / f"learned_mapping_jax.{part}.json"


def write_part(part: str, out: dict) -> None:
    part_path(part).write_text(json.dumps(out, indent=1))
    print(json.dumps({"part": part, **out}))


def bank_counts(bank: dict, min_score: float, ratio: float, match_descriptors) -> dict:
    """Correct / proposed / possible matches of mutual-NN + ratio over a pair bank."""
    c = prop = poss = 0
    for p in range(bank["gt"].shape[0]):
        n0, n1 = int(bank["valid0"][p].sum()), int(bank["valid1"][p].sum())
        gt = bank["gt"][p][:n0]
        m0 = np.asarray(match_descriptors(bank["desc0"][p][:n0], bank["desc1"][p][:n1], min_score=min_score,
                                          ratio=ratio)[0])
        prop += int((m0 >= 0).sum())
        c += int(((m0 == gt) & (gt >= 0) & (m0 >= 0)).sum())
        poss += int((gt >= 0).sum())
    return {"correct": c, "proposed": prop, "gt_possible": poss, "pairs": int(bank["gt"].shape[0]),
            "precision": c / max(prop, 1)}


def run_ab():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pixtrack_tpu.mapping.dense_descriptor import describe_at_dense, load_descriptor_weights
    from pixtrack_tpu.mapping.detector import detect_and_describe
    from pixtrack_tpu.mapping.matcher import match_descriptors
    from pixtrack_tpu.mapping.train_matcher import build_mesh_pair_bank

    _, params = load_descriptor_weights(REPO / "assets" / "dense_descriptor.npz")

    def learned_detector(image, max_keypoints=256, **kw):
        kp, sc, _ = detect_and_describe(image, max_keypoints=max_keypoints, **kw)
        return kp, sc, describe_at_dense(params, image, kp)

    out = {"protocol": dict(AB, match=AB_MATCH)}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        for name, det in (("patch", None), ("learned", learned_detector)):
            bank = build_mesh_pair_bank(Path(td) / name, detector=det, **AB)
            out[name] = bank_counts(bank, *AB_MATCH[name], match_descriptors)
    out["seconds"] = time.perf_counter() - t0
    write_part("ab", out)


def run_dense(seed: int):
    from reconstruct_jax import OUTCOME_KEYS, arc_views, cli_camera, setup

    setup()
    from chip_smoke import rig_outcome

    from pixtrack_tpu.mapping import default_descriptor
    from pixtrack_tpu.mapping.incremental import incremental_sfm

    views, truth, _ = arc_views()
    h, w = next(iter(views.values())).shape[:2]
    detector = default_descriptor()
    t0 = time.perf_counter()
    rec = incremental_sfm(views, cli_camera(h, w), max_keypoints=1024, nms_radius=1, seed=seed,
                          match_kw=dict(detector.match_kw), featuremetric_ka=True, featuremetric_ba_rounds=2,
                          detector=detector)
    seconds = time.perf_counter() - t0
    out = rig_outcome(rec, truth)
    write_part(f"dense{seed}", {**{k: out[k] for k in OUTCOME_KEYS}, "seconds": seconds})


def merge():
    parts = sorted(REPO.glob("scripts_dev/learned_mapping_jax.*.json"))
    merged = json.loads(OUT.read_text()) if OUT.exists() else {}
    for p in parts:
        merged[p.name.split(".")[1]] = json.loads(p.read_text())
    OUT.write_text(json.dumps(merged, indent=1, sort_keys=True) + "\n")
    for p in parts:
        p.unlink()
    print(json.dumps({"merged": [p.name for p in parts], "keys": sorted(merged)}))


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "ab":
        run_ab()
    elif mode == "dense":
        run_dense(int(sys.argv[2]))
    elif mode == "merge":
        merge()
    else:
        raise SystemExit(f"unknown mode {mode!r}: ab | dense SEED | merge")
