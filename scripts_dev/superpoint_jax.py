"""The JAX package's SuperPoint gates and losses on the CPU: chip_smoke phase 44's reference.

Writes ``scripts_dev/superpoint_jax.npz`` (numpy only), which
``chip_smoke.py`` phase 44 reads on the card:

- ``rep/scene/*``, ``rep/homography``: the draws of ``repeatability``'s six
  held-out scenes and homographies (``PRNGKey(77 + s)``, 120 px, grid 5,
  max warp 0.12), rebuilt from JAX's key tree as the CPU tests rebuild them
  (``tests/test_torch_superpoint_train.py::jax_pair_draws``);
- ``{rep,mesh}_{superpoint,harris}`` and ``..._counts``: JAX's
  ``repeatability`` and ``mesh_repeatability`` (the mean and the per-pair
  counts) for ``assets/superpoint_candidate.npz`` and for Harris;
- ``magic/*``: a fixed held-out batch of the MagicPoint recipe
  (``SPTrainConfig()``: 8 synthetic pairs from ``PRNGKey(1000)`` and 8
  pairs of a seed-900 texture label bank from ``PRNGKey(1001)``; one scene
  at the recipe's 6 views, 12 warps and 160 px), its images rounded to f16;
- ``dense/*``: a fixed held-out batch of the dense recipe
  (``SPDenseConfig()``, 8 pairs from ``PRNGKey(1002)`` of a seed-900 dense
  pair bank: one mesh scene at 8 views and one shape scene, 10 warps, 160
  px), images and votes rounded to f16;
- ``{magic,dense}/{candidate,init}``: JAX's (detector term, descriptor term)
  on that batch (computed on the f16-rounded values, as stored) at the
  candidate's weights and at ``init_superpoint(PRNGKey(0))``.

    JAX_PLATFORMS=cpu python scripts_dev/superpoint_jax.py

(about 3 minutes on 8 cores.)
"""

import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

OUT = REPO / "scripts_dev" / "superpoint_jax.npz"
CANDIDATE = REPO / "assets" / "superpoint_candidate.npz"
HELD_OUT_SEED = 900


def f16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(np.float16)


def terms(model, params, batch, size, dense):
    """(detector term, descriptor term) as the JAX trainers' losses sum them."""
    import jax

    from pixtrack_tpu.mapping import train_superpoint as jts
    from pixtrack_tpu.mapping import train_superpoint_dense as jtd

    img0, img1 = batch[0], batch[1]
    det0, desc0 = model.apply(params, img0[..., None])
    det1, desc1 = model.apply(params, img1[..., None])
    if dense:
        cfg = jtd.SPDenseConfig()
        _, _, v0, v1, corr, cvalid = batch
        l_det = (jtd.dense_detector_loss(det0, v0, cfg.dustbin_mass)
                 + jtd.dense_detector_loss(det1, v1, cfg.dustbin_mass))
        l_desc = jax.vmap(lambda a, b, c, v: jtd.corr_descriptor_loss(a, b, c, v, size, cfg))(
            desc0, desc1, corr, cvalid).mean()
    else:
        cfg = jts.SPTrainConfig()
        _, _, lab0, lab1, H = batch
        l_det = jts.detector_loss(det0, lab0) + jts.detector_loss(det1, lab1)
        l_desc = jax.vmap(lambda a, b, h: jts.descriptor_loss(a, b, h, size, cfg))(desc0, desc1, H).mean()
    return np.asarray([float(l_det), float(l_desc)])


def main():
    import jax
    import jax.numpy as jnp

    from pixtrack_tpu.mapping import superpoint as jsp
    from pixtrack_tpu.mapping import train_superpoint as jts
    from pixtrack_tpu.mapping import train_superpoint_dense as jtd
    from test_torch_superpoint_train import jax_pair_draws

    t0 = time.time()
    out = {}
    cand = jts.load_superpoint_weights(CANDIDATE)

    # repeatability's scenes, and both gates for the candidate and Harris
    rcfg = jts.SPTrainConfig(size=120, max_warp=0.12, grid=5)
    draws = [jax_pair_draws(jax.random.PRNGKey(77 + s), rcfg) for s in range(6)]
    for k in draws[0]["scene"]:
        out[f"rep/scene/{k}"] = np.stack([d["scene"][k].numpy() for d in draws])
    out["rep/homography"] = np.stack([d["homography"].numpy() for d in draws])
    for name, params in (("superpoint", cand), ("harris", None)):
        rep, counts = jts.repeatability(params, detector=name)
        out[f"rep_{name}"], out[f"rep_{name}_counts"] = np.float64(rep), np.asarray(counts)
        mrep, mcounts = jts.mesh_repeatability(params, detector=name)
        out[f"mesh_{name}"], out[f"mesh_{name}_counts"] = np.float64(mrep), np.asarray(mcounts)
        print(f"{name}: repeatability {rep:.4f} {counts}; mesh {mrep:.4f} {mcounts} ({time.time() - t0:.0f} s)",
              flush=True)

    # the MagicPoint recipe's held-out batch
    cfg = jts.SPTrainConfig()
    bank = jts.build_texture_label_bank(n_scenes=1, seed=HELD_OUT_SEED)
    syn = jts.make_batch(jax.random.PRNGKey(1000), cfg)
    bb = jts.make_bank_batch(jax.random.PRNGKey(1001), cfg, bank["images"], bank["keypoints"], bank["valid"])
    img0, img1, lab0, lab1, H = (np.concatenate([np.asarray(a), np.asarray(b)]) for a, b in zip(syn, bb))
    magic = {"img0": f16(img0), "img1": f16(img1), "lab0": lab0.astype(np.uint8), "lab1": lab1.astype(np.uint8),
             "H": H.astype(np.float32)}
    print(f"magic batch: {int((lab0 < 64).sum())} + {int((lab1 < 64).sum())} labelled cells "
          f"({time.time() - t0:.0f} s)", flush=True)

    # the dense recipe's held-out batch
    dcfg = jtd.SPDenseConfig()
    with tempfile.TemporaryDirectory() as td:
        dbank = jtd.build_dense_pair_bank(td, n_scenes=1, n_shape_scenes=1, seed=HELD_OUT_SEED)
    dbank["images"], dbank["votes"] = (f16(dbank[k]).astype(np.float32) for k in ("images", "votes"))
    dev = tuple(jnp.asarray(dbank[k]) for k in ("images", "votes", "pairs", "corr", "corr_valid"))
    dimg0, dimg1, v0, v1, corr, cvalid = (np.asarray(a) for a in jtd.make_dense_batch(jax.random.PRNGKey(1002), dcfg,
                                                                                       dev))
    dense = {"img0": f16(dimg0), "img1": f16(dimg1), "v0": f16(v0), "v1": f16(v1), "corr": corr.astype(np.float32),
             "cvalid": cvalid}
    print(f"dense batch: {dbank['pairs'].shape[0]} pairs in the bank, {int(cvalid.sum())} valid correspondences "
          f"({time.time() - t0:.0f} s)", flush=True)

    model, init = jsp.init_superpoint(jax.random.PRNGKey(0), cfg.size, cfg.size)
    as32 = lambda b: tuple(jnp.asarray(np.asarray(a).astype(np.float32) if a.dtype == np.float16 else a)  # noqa: E731
                           for a in b)
    mb = as32((magic["img0"], magic["img1"], magic["lab0"].astype(np.int32), magic["lab1"].astype(np.int32),
               magic["H"]))
    db = as32((dense["img0"], dense["img1"], dense["v0"], dense["v1"], dense["corr"], dense["cvalid"]))
    for label, params in (("candidate", cand), ("init", init)):
        magic[label] = terms(model, params, mb, cfg.size, False)
        dense[label] = terms(model, params, db, dcfg.size, True)
        print(f"{label}: magic (det, desc) {magic[label]}, dense {dense[label]}", flush=True)
    out.update({f"magic/{k}": v for k, v in magic.items()})
    out.update({f"dense/{k}": v for k, v in dense.items()})
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e6:.2f} MB) in {time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
