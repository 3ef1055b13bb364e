"""Samples that repeat a correspondence in the mapper's verification RANSAC,
JAX against the port, on the CPU.

The 6-view partial arc of tests/test_incremental_sfm.py (160 px, 512
keypoints, ``nms_radius=1``, min_score 0.5, ratio 0.98; rendered by the
port): for every pair that verification runs, JAX's detection and matching,
the correspondences padded cyclically to a power of two as ``incremental_sfm``
pads them, and 2048 essential hypotheses from one JAX key per pair. Per
pair it prints the share of samples that draw one correspondence twice, how
many hypotheses JAX's and the port's 8-point solvers score differently (in
all, and among the other samples), whether the two pick the same hypothesis
with and without such samples, and whether each one's best is such a
sample.

    JAX_PLATFORMS=cpu python scripts_dev/ransac_repeats.py
"""

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from pixtrack_tpu.geometry import Camera as JCamera
    from pixtrack_tpu.mapping import incremental as jinc
    from pixtrack_tpu.mapping.detector import detect_and_describe
    from pixtrack_tpu.mapping.matcher import match_descriptors
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.mapping import incremental as tinc
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
    from smoke_worlds import look_at_w2c, make_cube_obj

    res = 160
    with tempfile.TemporaryDirectory() as tmp:
        mesh = load_obj(make_cube_obj(Path(tmp)))
    camera = Camera.pinhole(res * 1.1, res * 1.1, (res - 1) / 2, (res - 1) / 2, res, res)
    views = {}
    for i in range(6):
        ang = np.deg2rad(22.0) * i
        views[i + 1] = render_mesh(mesh, look_at_w2c(0.9 * np.array([np.sin(ang), 0.4 + 0.1 * np.sin(2 * ang),
                                                                      np.cos(ang)])), camera)
    jcam = JCamera.pinhole(res * 1.1, res * 1.1, res / 2 - 0.5, res / 2 - 0.5, res, res)
    thresh = (3.0 / (res * 1.1)) ** 2
    kps, descs = {}, {}
    for i, im in views.items():
        kp, _, d = detect_and_describe(im, max_keypoints=512, nms_radius=1)
        kps[i], descs[i] = np.asarray(kp), np.asarray(d)
    kp_n = {i: jinc._normalize(jcam, kps[i] - 0.5) for i in kps}
    ids = sorted(views)
    for a in range(len(ids)):
        for b in range(a + 1, len(ids)):
            i0, i1 = ids[a], ids[b]
            m0 = np.asarray(match_descriptors(descs[i0], descs[i1], min_score=0.5, ratio=0.98)[0])
            k0 = np.nonzero(m0 >= 0)[0]
            if len(k0) < 10:
                continue
            n_pad = 1 << int(np.ceil(np.log2(max(len(k0), 32))))
            sel = np.resize(np.arange(len(k0)), n_pad)
            pa = kp_n[i0][k0][sel].astype(np.float32)
            pb = kp_n[i1][m0[k0]][sel].astype(np.float32)
            idx = np.asarray(jax.random.randint(jax.random.PRNGKey(10 * a + b), (2048, 8), 0, n_pad))
            repeat = np.array([len(set(r)) < 8 for r in sel[idx]])
            s_j = (np.asarray(jinc._sampson(jinc._eight_point(pa[idx], pb[idx]), pa, pb)) < thresh).sum(1)
            ta, tb = torch.as_tensor(pa), torch.as_tensor(pb)
            s_t = (tinc._sampson(tinc._eight_point(ta[idx], tb[idx]), ta, tb) < thresh).sum(1).numpy()
            print(json.dumps({
                "pair": [i0, i1], "matches": int(len(k0)), "padded": n_pad,
                "repeat_share": float(repeat.mean()), "scores_differ": int((s_j != s_t).sum()),
                "scores_differ_other": int(((s_j != s_t) & ~repeat).sum()),
                "same_best": bool(np.argmax(s_j) == np.argmax(s_t)),
                "same_best_without_repeats": bool(np.argmax(np.where(repeat, -1, s_j)) ==
                                                  np.argmax(np.where(repeat, -1, s_t))),
                "jax_best_repeats": bool(repeat[np.argmax(s_j)]), "port_best_repeats": bool(repeat[np.argmax(s_t)])}),
                flush=True)


if __name__ == "__main__":
    main()
