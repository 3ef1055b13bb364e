"""The port's multi-process NeRF trainer (``parallel/mesh.py``,
``nerf/train.py::train(mesh=...)``) against the JAX package's sharded step
and against its own one-process step, on the CPU: gloo ranks spawned from
the test (``launch``, one thread each, a 60 s collective timeout, a join
timeout; the rank functions in tests/scaleout_ranks.py), at
tests/test_torch_ngp.py's ``TINY`` field width. The JAX side runs on the 8
virtual CPU devices of tests/conftest.py. The video batch, ``track-batch
--devices`` and ``train_nerf_asset(devices, tp)`` over several processes
are tested in tests/test_torch_video.py, beside the runs they share.

Tolerances, and what was measured:
- the (dp, tp) = (2, 2) step against JAX's ``sharded_nerf_train_step`` on
  ``make_mesh(4, tp=2)``, the same parameters, batch and noise: the loss
  within 1e-5 relative (measured: equal), the gradients (Adam's first
  moment / (1 - b1)) within 5e-5 of each leaf's largest entry (1.4e-6), the
  parameters after the step within 2 lr (1.5e-6 lr;
  tests/test_torch_nerf_train.py's single-device bounds);
- every layout against the one-process step on one batch and one seed:
  equal to the bit at dp = 1 ((1, 1), (1, 2): the tp sum adds zeros only);
  at dp > 1 the order of the dp mean is the only difference: the loss, the
  gradients and the parameters within 1e-6 of each leaf's largest entry
  (measured at (4, 1), (2, 2), (2, 1): loss 1.1e-7 relative or equal,
  gradients 2.7e-7, parameters 2.8e-7);
- 3 steps of ``train(mesh=...)`` against the one-process ``train``: equal
  to the bit at (1, 2); at (2, 2) the same bounds (losses 1.2e-7,
  parameters 1.5e-7).

A table gradient scaled by tp (an all-reduce as the tp sum's backward)
fails the JAX test and every layout at tp = 2 (checked on a copy with that
backward).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixtrack_tpu.nerf.field import NGPField as JNGPField
from pixtrack_tpu.parallel.mesh import make_mesh as jmake_mesh
from pixtrack_tpu.parallel.mesh import shard_field_params as jshard_field_params
from pixtrack_tpu.parallel.mesh import sharded_nerf_train_step as jsharded_nerf_train_step
from pixtrack_tpu_torch.nerf.dataset import make_synthetic_dataset, sphere_scene
from pixtrack_tpu_torch.nerf.field import init_field, ngp_to_flax_params

import scaleout_ranks
from test_torch_nerf_train import feed_uniform
from test_torch_ngp import TINY

LR, B1 = 1e-2, 0.9
N_COARSE, N_FINE, N_RAYS = scaleout_ranks.N_COARSE, scaleout_ranks.N_FINE, 96
# flax leaf -> the port's parameter name
NAMES = {f"{n}/{k}": f"{n}.{k}" for n in ("color_l1", "color_l2", "color_l3", "density_l1", "density_l2")
         for k in ("kernel", "bias")}


def _params():
    """A flax params tree at TINY width (the port's init_field through
    ngp_to_flax_params), the tables redrawn in +-0.05 (test_torch_ngp.pair)."""
    params = ngp_to_flax_params(init_field(1, device="cpu", **TINY))
    rng = np.random.default_rng(1)
    enc = params["params"]["encoding"]
    for k in enc:
        enc[k] = rng.uniform(-0.05, 0.05, enc[k].shape).astype(np.float32)
    return params


def _batch(seed=0):
    o, d, rgb = make_synthetic_dataset(sphere_scene, n_views=4, res=16, device="cpu").all_rays("cpu")
    idx = np.random.default_rng(seed).choice(len(o), N_RAYS, replace=False)
    return tuple(a[idx].numpy() for a in (o, d, rgb))


def _flat_jax(tree) -> dict:
    """A flax tree (or a sharded one) as the port's parameter names: the
    per-level tables stacked into ``encoding.tables``."""
    p = tree["params"]
    enc = p["encoding"]
    out = {"encoding.tables": np.stack([np.asarray(enc[f"table{lvl}"]) for lvl in range(len(enc))])}
    for key, name in NAMES.items():
        layer, leaf = key.split("/")
        out[name] = np.asarray(p[layer][leaf])
    return out


def _gap(a: dict, b: dict) -> dict:
    """Each leaf's largest difference over its largest entry in ``b``."""
    return {k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)) for k in b}


@pytest.fixture(scope="module")
def ranks():
    """Two spawns side by side, in the background of the tests' own work: 4
    ranks (the (2, 2) step on fixed noise, then (4, 1) and (2, 2) on the
    generator's draws, then 3 training steps at (2, 2)) and 2 ranks ((2, 1)
    and (1, 2), 3 training steps at (1, 2)); each with the one-process
    counterparts from rank 0."""
    params, batch = _params(), _batch()
    rng = np.random.default_rng(1)
    noise = (rng.uniform(size=(N_RAYS, N_COARSE)).astype(np.float32),
             rng.uniform(size=(N_RAYS, N_FINE)).astype(np.float32))
    world4 = scaleout_ranks.in_background(scaleout_ranks.world4, 4, params, batch, noise)
    world2 = scaleout_ranks.in_background(scaleout_ranks.world2, 2, params, batch)
    failing = scaleout_ranks.in_background(scaleout_ranks.one_rank_fails, 2, 2)
    return types.SimpleNamespace(params=params, batch=batch, noise=noise, world4=world4, world2=world2,
                                 failing=failing)


def test_sharded_step_matches_jax(ranks, monkeypatch):
    """(dp, tp) = (2, 2) against JAX's sharded step on make_mesh(4, tp=2)."""
    jf = JNGPField(**TINY)
    mesh = jmake_mesh(4, tp=2)
    sharded = jshard_field_params(jax.tree.map(jnp.asarray, ranks.params), mesh, jf)
    step_fn, opt = jsharded_nerf_train_step(jf, mesh, scaleout_ranks.AABB, n_coarse=N_COARSE, n_fine=N_FINE)
    feed_uniform(monkeypatch, list(ranks.noise))
    new, state, loss = step_fn(sharded, opt.init(sharded), *(jnp.asarray(a) for a in ranks.batch),
                               jax.random.PRNGKey(0))
    port = ranks.world4()["fixed"][0][(2, 2)]
    assert port["loss"] == pytest.approx(float(loss), rel=1e-5)
    j_grad = {k: v / (1 - B1) for k, v in _flat_jax(state[0].mu).items()}
    t_grad = {k: v / (1 - B1) for k, v in port["mu"].items()}
    assert set(j_grad) == set(t_grad)
    gaps = _gap(t_grad, j_grad)
    j_new = _flat_jax(new)
    moved = {k: float(np.abs(port["params"][k] - v).max() / LR) for k, v in j_new.items()}
    print("(2, 2) against JAX: loss", abs(port["loss"] - float(loss)) / abs(float(loss)), "gradients", gaps,
          "parameters (lr)", moved)
    assert max(gaps.values()) <= 5e-5, gaps
    for k, v in j_new.items():
        np.testing.assert_allclose(port["params"][k], v, rtol=0, atol=2 * LR, err_msg=k)


def _assert_equal_or_within(rec, ref, bitwise: bool, what: str):
    if bitwise:
        assert rec["loss"] == ref["loss"], what
        for part in ("mu", "params"):
            for k in ref[part]:
                np.testing.assert_array_equal(rec[part][k], ref[part][k], err_msg=f"{what} {part} {k}")
        return
    print(what, "loss", abs(rec["loss"] - ref["loss"]) / abs(ref["loss"]),
          {part: max(_gap(rec[part], ref[part]).values()) for part in ("mu", "params")})
    assert rec["loss"] == pytest.approx(ref["loss"], rel=1e-6), what
    for part in ("mu", "params"):
        gaps = _gap(rec[part], ref[part])
        assert max(gaps.values()) <= 1e-6, (what, part, gaps)


@pytest.mark.parametrize("layout", [(4, 1), (2, 2)])
def test_world4_step_equals_the_one_process_step(ranks, layout):
    """One global batch and one seed: (4, 1) within 1e-6, (2, 2) too (its
    dp = 2 mean); the fixed-noise (2, 2) step against the fixed-noise
    one-process step as well."""
    out = ranks.world4()
    rec, ref = out["drawn"][0][layout], out["drawn"][1]
    _assert_equal_or_within(rec, ref, layout[0] == 1, str(layout))
    if layout == (2, 2):
        _assert_equal_or_within(out["fixed"][0][layout], out["fixed"][1], False, "fixed noise")


def test_world4_train_equals_one_process_train(ranks):
    """3 steps of train(mesh=(2, 2)) against the one-process train: the
    history (rank 0 only) and the gathered field; the callback on rank 0
    with a gathered (unsharded) copy."""
    t = ranks.world4()["train"]
    (h1, p1), (hm, pm) = t["one"], t["mesh"]
    assert [s for s, _ in hm] == [s for s, _ in h1] == [1, 2, 3]
    gaps = _gap(pm, p1)
    print("train (2, 2): losses", [abs(a - b) / b for (_, a), (_, b) in zip(hm, h1)], "parameters",
          max(gaps.values()))
    np.testing.assert_allclose([v for _, v in hm], [v for _, v in h1], rtol=1e-6, atol=0)
    assert max(gaps.values()) <= 1e-6, gaps
    assert t["encoding"] == "HashEncoding" and [c[2] for c in t["callbacks"]] == ["HashEncoding"] * 3


def test_world2_and_world1_equal_the_one_process_step(ranks):
    """(2, 1) within 1e-6, (1, 2) and (1, 1) equal to the bit; 3 steps of
    train(mesh=(1, 2)) equal to the one-process train to the bit. (1, 1)
    runs here, a world of one (no rendezvous)."""
    import torch.distributed as dist

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one, ref1 = scaleout_ranks.sharded_steps(1, [(1, 1)], ranks.params, TINY, ranks.batch, N_COARSE, N_FINE,
                                                 scaleout_ranks.SEED)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.set_num_threads(threads)
    _assert_equal_or_within(one[(1, 1)], ref1, True, "(1, 1)")

    out = ranks.world2()
    recs, ref = out["drawn"]
    _assert_equal_or_within(recs[(2, 1)], ref, False, "(2, 1)")
    _assert_equal_or_within(recs[(1, 2)], ref, True, "(1, 2)")
    (h1, p1), (hm, pm) = out["train"]["one"], out["train"]["mesh"]
    assert hm == h1 and len(hm) == 3
    for k in p1:
        np.testing.assert_array_equal(pm[k], p1[k], err_msg=k)


def test_a_failing_rank_stops_the_launch(ranks):
    """A rank that raises takes the others down (rank 0 waits in an all-reduce
    for it): ``launch`` raises well before the join timeout or the
    collective's, with rank 1's error or the one it causes in rank 0 (the
    peer gone), whichever the launcher sees first."""
    import time

    from torch.multiprocessing.spawn import ProcessException

    t0 = time.perf_counter()
    with pytest.raises(ProcessException, match="rank 1 stops here|Connection reset by peer|Connection closed"):
        ranks.failing()
    assert time.perf_counter() - t0 < 50.0

