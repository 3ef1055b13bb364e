#!/usr/bin/env python3
"""The port's unposed mapper on the card and on the CPU, stage by stage, on
chip_smoke's arc rig (phase 30's images and settings) at one seed.

Both runs draw their hypotheses from the same seeded CPU generator, so the
two devices start from the same draws; the script records each stage's
output in both runs and prints where they part: the detected keypoints,
the verified matches per pair, KA's keypoints, the chain and the global
initialisation's poses, the registered model, and the outcome
(``chip_smoke.rig_outcome``) of each.

    python3 scripts_dev/mapper_card_vs_cpu.py [SEED]

Needs one CUDA card; prints JSON lines.
"""

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def run(device, views, cam_rec, seed):
    import torch

    from pixtrack_tpu_torch.mapping import detector, featuremetric, global_init, incremental

    rec = {}
    saved = {}

    def capture(mod, name, key, out_fn):
        fn = getattr(mod, name)
        saved[(mod, name)] = fn

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            rec.setdefault(key, []).append(out_fn(out))
            return out
        setattr(mod, name, wrapped)

    capture(detector, "detect_and_describe", "det", lambda o: o[0].cpu().numpy())
    capture(incremental, "_verify_pairs", "matches", lambda m: {k: v.copy() for k, v in m.items()})
    capture(featuremetric, "keypoint_adjustment", "ka", lambda k: {i: v.copy() for i, v in k.items()})
    capture(incremental, "_chain_initialize", "chain",
            lambda p: {i: (T.R.cpu().numpy(), T.t.cpu().numpy()) for i, T in p.items()})
    capture(global_init, "global_initialize", "global",
            lambda p: None if p is None else {i: (T.R.cpu().numpy(), T.t.cpu().numpy()) for i, T in p.items()})
    try:
        model = incremental.incremental_sfm(views, cam_rec, max_keypoints=768, nms_radius=1, seed=seed,
                                            match_kw=dict(min_score=0.5, ratio=0.98), featuremetric_ka=True,
                                            featuremetric_ba_rounds=2, device=device)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    return model, rec


def pose_gap(a, b):
    if a is None or b is None:
        return {"one_is_none": [a is None, b is None]}
    common = sorted(set(a) & set(b))
    rot = max(float(np.degrees(np.arccos(np.clip((np.trace(a[i][0] @ b[i][0].T) - 1) / 2, -1, 1)))) for i in common)
    return {"views": [len(a), len(b)], "rot_deg_max": rot, "t_max": max(float(np.abs(a[i][1] - b[i][1]).max())
                                                                         for i in common)}


def main(seed: int):
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        views, truth, cam_rec = cs.arc_rig(Path(tmp))
    out = {}
    for dev in ("cuda", "cpu"):
        model, rec = run(dev, views, cam_rec, seed)
        out[dev] = rec
        o = cs.rig_outcome(model, truth)
        print(json.dumps({"device": dev, **{k: v for k, v in o.items() if k != "names"}}), flush=True)
    a, b = out["cuda"], out["cpu"]
    print(json.dumps({"keypoints": [[len(x), len(y), float(np.abs(x - y).max()) if len(x) == len(y) else None]
                                    for x, y in zip(a["det"], b["det"])]}), flush=True)
    ma, mb = a["matches"][0], b["matches"][0]
    diff = {f"{p}": int(((ma[p] >= 0) != (mb[p] >= 0)).sum() + ((ma[p] >= 0) & (mb[p] >= 0) & (ma[p] != mb[p])).sum())
            for p in ma}
    print(json.dumps({"matches_differing_per_pair": {k: v for k, v in diff.items() if v},
                      "matches_total": [int(sum((m >= 0).sum() for m in ma.values())),
                                        int(sum((m >= 0).sum() for m in mb.values()))]}), flush=True)
    if "ka" in a and "ka" in b:
        ka = max(float(np.abs(a["ka"][0][i] - b["ka"][0][i]).max()) for i in a["ka"][0])
        print(json.dumps({"ka_keypoints_max_gap_px": ka}), flush=True)
    print(json.dumps({"chain": pose_gap(a["chain"][0], b["chain"][0]),
                      "global": pose_gap(a["global"][0], b["global"][0])}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
