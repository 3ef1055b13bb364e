"""The port's repeated-sample rule (``incremental._repeats``) measured on both
packages, on the CPU.

A RANSAC sample that draws one correspondence twice leaves the minimal
solver a null space of two or more dimensions; the JAX package scores the
model its SVD library happens to return from it, the port never chooses
such a sample. Two measurements:

- ``neutral FIRST LAST``: tests/test_incremental_sfm.py's 6-view partial
  arc (160 px, 22-degree steps, 512 keypoints, ``nms_radius=1``, min_score
  0.5, ratio 0.98; rendered by the port) through each package's mapper at
  seeds FIRST..LAST-1, each with and without the rule (JAX's three RANSACs
  under the rule: ``tests/test_torch_incremental.py::_jax_ransac_port_rule``,
  its own solvers, scoring and refits on its own draws). One JSON line per
  run: the package, the rule, the seed and ``chip_smoke.rig_outcome``.
- ``replay SEED``: what ``reconstruct`` runs over chip_smoke's arc images
  (the camera it infers, 1024 keypoints, KA, two featuremetric BA rounds):
  JAX's mapper under the rule at SEED with its draws recorded, then the
  port's on those draws (``tests/test_torch_incremental.py::run_both``).
  One JSON line with both outcomes, both models as they enter featuremetric
  BA, and how far apart the stages before leave them (KA's keypoints, the
  chain's and the global averaging's rotations): a gap between the
  packages that the seed's draws do not explain shows here, stage by stage.
  ``--f32-svd`` takes the port's SVDs in f32, as the JAX package does.

    JAX_PLATFORMS=cpu python scripts_dev/repeat_rule.py neutral 0 12
    JAX_PLATFORMS=cpu python scripts_dev/repeat_rule.py replay 0 [--f32-svd]
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


def setup():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(2)


def outcome(rec, truth) -> dict:
    from chip_smoke import rig_outcome

    out = rig_outcome(rec, {f"view_{i:04d}.png": v for i, v in truth.items()})
    out.pop("names")
    return out


def neutral(first: int, last: int):
    setup()
    import pytest
    import torch

    import test_torch_incremental as tti
    from pixtrack_tpu.mapping import incremental as jinc
    from pixtrack_tpu_torch.mapping import incremental as tinc

    views, truth, jrec, trec = tti.arc_views(Path(tempfile.mkdtemp(prefix="repeat_rule_")), 6, 160, 22.0)
    kw = dict(max_keypoints=512, nms_radius=1, match_kw=dict(min_score=0.5, ratio=0.98))
    for seed in range(first, last):
        for rule in (False, True):
            with pytest.MonkeyPatch.context() as mp:
                if rule:
                    tti.record_jax_draws(mp, port_rule=True)
                t0 = time.perf_counter()
                rec = jinc.incremental_sfm(views, jrec, seed=seed, **kw)
                print(json.dumps({"package": "jax", "rule": rule, "seed": seed, "seconds": time.perf_counter() - t0,
                                  **outcome(rec, truth)}), flush=True)
            with pytest.MonkeyPatch.context() as mp:
                if not rule:
                    mp.setattr(tinc, "_repeats", lambda *rows: torch.zeros(rows[0].shape[0], dtype=torch.bool))
                t0 = time.perf_counter()
                rec = tinc.incremental_sfm(views, trec, seed=seed, device="cpu", **kw)
                print(json.dumps({"package": "port", "rule": rule, "seed": seed, "seconds": time.perf_counter() - t0,
                                  **outcome(rec, truth)}), flush=True)


def replay(seed: int, f32_svd: bool = False):
    setup()
    import pytest
    import torch

    import chip_smoke as cs
    import test_torch_incremental as tti
    from pixtrack_tpu.mapping import featuremetric as jfm
    from pixtrack_tpu.mapping import global_init as jgi
    from pixtrack_tpu.mapping import incremental as jinc
    from pixtrack_tpu.sfm import colmap_io as jcolmap
    from pixtrack_tpu_torch.mapping import featuremetric as tfm
    from pixtrack_tpu_torch.mapping import global_init as tgi
    from pixtrack_tpu_torch.mapping import incremental as tinc
    from reconstruct_jax import cli_camera as jax_cli_camera

    views, truth_named, _ = cs.arc_rig(Path(tempfile.mkdtemp(prefix="repeat_rule_")))
    truth = {int(n[5:9]): v for n, v in truth_named.items()}
    h, w = next(iter(views.values())).shape[:2]
    trec = cs.cli_camera(h, w)
    jrec = jax_cli_camera(h, w)
    assert isinstance(jrec, jcolmap.CameraRecord) and np.array_equal(jrec.params, trec.params)
    # what each package's stages return: KA's keypoints, the chain's and the
    # global averaging's poses, and the model as it enters featuremetric BA
    got = {"jax": {}, "port": {}}
    with pytest.MonkeyPatch.context() as mp:
        if f32_svd:  # the port's SVDs in f32, as the JAX package takes them
            mp.setattr(tinc, "_svd", lambda A, full_matrices=True: torch.linalg.svd(A, full_matrices=full_matrices))
        for name, fm, inc, gi in (("jax", jfm, jinc, jgi), ("port", tfm, tinc, tgi)):
            def fba(rec, *args, _orig=fm.featuremetric_ba, _name=name, **kw):
                got[_name]["before_featuremetric_ba"] = outcome(rec, truth)
                return _orig(rec, *args, **kw)

            def ka(*args, _orig=fm.keypoint_adjustment, _name=name, **kw):
                out = _orig(*args, **kw)
                got[_name]["ka"] = {int(i): np.asarray(k, np.float64) for i, k in out.items()}
                return out

            def chain(*args, _orig=inc._chain_initialize, _name=name, **kw):
                out = _orig(*args, **kw)
                got[_name]["chain"] = _rotations(out)
                return out

            def glob(*args, _orig=gi.global_initialize, _name=name, **kw):
                out = _orig(*args, **kw)
                got[_name]["global"] = None if out is None else _rotations(out)
                return out

            mp.setattr(fm, "featuremetric_ba", fba)
            mp.setattr(fm, "keypoint_adjustment", ka)
            mp.setattr(inc, "_chain_initialize", chain)
            mp.setattr(gi, "global_initialize", glob)
        t0 = time.perf_counter()
        rec_j, rec_t, stats = tti.run_both(views, jrec, trec, seed=seed, max_keypoints=1024, nms_radius=1,
                                           match_kw=dict(min_score=0.5, ratio=0.98), featuremetric_ka=True,
                                           featuremetric_ba_rounds=2)
    j, t = got["jax"], got["port"]
    stages = {"ka_max_px": max(float(np.abs(j["ka"][i] - t["ka"][i]).max()) for i in j["ka"])}
    for st in ("chain", "global"):
        if j.get(st) is None or t.get(st) is None:
            stages[st] = [j.get(st) is None, t.get(st) is None]
            continue
        ids = sorted(set(j[st]) & set(t[st]))
        stages[st + "_ids_equal"] = sorted(j[st]) == sorted(t[st])
        # the gauge: each pose relative to the first common view, as the tests compare
        rel = {p: {i: g[st][i] @ g[st][ids[0]].T for i in ids} for p, g in (("jax", j), ("port", t))}
        stages[st + "_max_deg"] = max(_deg(rel["jax"][i], rel["port"][i]) for i in ids)
        stages[st + "_truth_median_deg"] = {p: float(np.median([_deg(rel[p][i], truth[i][0] @ truth[ids[0]][0].T)
                                                                for i in ids])) for p in rel}
    print(json.dumps({"seed": seed, "f32_svd": f32_svd, "seconds": time.perf_counter() - t0, "draws": stats,
                      "jax": outcome(rec_j, truth), "port": outcome(rec_t, truth), "stages": stages,
                      "before_featuremetric_ba": {p: got[p].get("before_featuremetric_ba") for p in got}}),
          flush=True)


def _rotations(poses) -> dict:
    return {int(i): np.asarray(T.R.cpu().numpy() if hasattr(T.R, "cpu") else T.R, np.float64)
            for i, T in poses.items()}


def _deg(A, B) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(A @ B.T) - 1) / 2, -1.0, 1.0))))


if __name__ == "__main__":
    if sys.argv[1] == "neutral":
        neutral(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1] == "replay":
        replay(int(sys.argv[2]), f32_svd="--f32-svd" in sys.argv[3:])
    else:
        raise SystemExit("usage: repeat_rule.py neutral FIRST LAST | replay SEED [--f32-svd]")
