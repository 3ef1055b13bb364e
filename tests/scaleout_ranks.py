"""The rank functions of tests/test_torch_scaleout.py and
tests/test_torch_video.py's multi-process tests: each runs in every
rank that ``parallel.mesh.launch`` spawns (gloo on the CPU, one thread) and
imports the port only, never JAX (a spawned rank imports this module, not
the test file). Rank 0's return value goes back to the test, as numpy."""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# a hung collective fails the test well inside tier-1's limit
TIMEOUT = datetime.timedelta(seconds=60)
AABB = [[0.2, 0.2, 0.2], [0.8, 0.8, 0.8]]


def in_background(fn, world: int, *args, join_timeout: float = 240.0):
    """``launch(fn, world, *args)`` (one thread a rank) in a thread of the
    test, so that the test's own work runs beside the ranks; call the
    returned function for rank 0's result (or the ranks' error)."""
    import threading

    from pixtrack_tpu_torch.parallel.mesh import launch

    box = {}

    def run():
        try:
            box["out"] = launch(fn, world, *args, join_timeout=join_timeout, threads=1)
        except BaseException as e:  # raised in the test by result()
            box["err"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return result


def _mesh(world: int, tp: int):
    from pixtrack_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    return make_mesh(world, tp, "cpu", timeout=TIMEOUT)


def flat_params(field) -> dict:
    """An unsharded field's parameters as numpy, by parameter name."""
    return {k: v.detach().cpu().numpy().copy() for k, v in field.named_parameters()}


def step_record(field, opt, loss, mesh=None) -> dict:
    """After one step: the loss, the parameters and Adam's first moments by
    parameter name (the table's gathered over tp)."""
    from pixtrack_tpu_torch.parallel.mesh import gather_field, gather_over_tp

    names = [k for k, _ in field.named_parameters()]
    mu = {}
    for name, m in zip(names, opt.mu):
        full = gather_over_tp(m, field, mesh) if mesh is not None and name == "encoding.tables" else m
        mu[name] = full.numpy().copy()
    full = field if mesh is None else gather_field(field, mesh)
    return {"loss": float(loss.detach()), "params": flat_params(full), "mu": mu}


def one_process_step(params, cfg_kw, batch, n_coarse, n_fine, seed):
    """The port's one-process step (nerf/train.py's loss, Adam at the JAX
    sharded step's rate) on ``batch`` with its noise drawn from a generator
    seeded ``seed``."""
    from pixtrack_tpu_torch.nerf.field import ngp_from_flax_params
    from pixtrack_tpu_torch.nerf.optim import Adam
    from pixtrack_tpu_torch.nerf.train import TrainConfig, make_loss_fn

    o, d, rgb = (torch.as_tensor(a) for a in batch)
    field = ngp_from_flax_params(params, device="cpu", **cfg_kw)
    opt = Adam(field.parameters(), lambda k: 1e-2, b1=0.9, b2=0.99, eps=1e-15)
    loss = make_loss_fn(field, TrainConfig(n_coarse=n_coarse, n_fine=n_fine, batch_rays=o.shape[0]), AABB)(
        o, d, rgb, torch.Generator().manual_seed(seed))
    loss.backward()
    opt.step()
    return step_record(field, opt, loss)


def sharded_steps(world: int, layouts, params, cfg_kw, batch, n_coarse, n_fine, seed, fixed_noise=None):
    """One ``sharded_nerf_train_step`` at each (dp, tp) of ``layouts`` over
    this world, each from the same parameters, batch and generator seed;
    ``fixed_noise`` (coarse, fine), where given, replaces the generator's
    draws (``render._draw_noise``). Also the one-process step in this rank.
    Returns ({(dp, tp): step_record}, the one-process step_record)."""
    from pixtrack_tpu_torch.nerf import render
    from pixtrack_tpu_torch.nerf.field import ngp_from_flax_params
    from pixtrack_tpu_torch.parallel.mesh import sharded_nerf_train_step

    torch.set_num_threads(1)
    shipped = render._draw_noise
    if fixed_noise is not None:
        draws = tuple(None if a is None else torch.as_tensor(a) for a in fixed_noise)
        render._draw_noise = lambda *a: draws
    try:
        ref = one_process_step(params, cfg_kw, batch, n_coarse, n_fine, seed)
        o, d, rgb = (torch.as_tensor(a) for a in batch)
        out = {}
        for dp, tp in layouts:
            assert dp * tp == world
            mesh = _mesh(world, tp)
            field = ngp_from_flax_params(params, device="cpu", **cfg_kw)
            step, opt = sharded_nerf_train_step(field, mesh, AABB, n_coarse=n_coarse, n_fine=n_fine)
            loss = step(o, d, rgb, torch.Generator().manual_seed(seed))
            out[(dp, tp)] = step_record(field, opt, loss, mesh)
    finally:
        render._draw_noise = shipped
    return out, ref


# the field, the step's shapes and the training run of tests/test_torch_scaleout.py
TINY = dict(n_levels=4, log2_table_size=12, base_res=4, max_res=32, hidden=16)  # tests/test_torch_ngp.py's
N_COARSE, N_FINE, SEED = 24, 16, 5
TRAIN_KW = dict(n_steps=3, batch_rays=32, n_coarse=8, n_fine=4, log_every=1)


def world4(params, batch, noise):
    """4 ranks: the (2, 2) step on fixed noise, then (4, 1) and (2, 2) on
    the generator's draws, then 3 steps of ``train`` at (2, 2)."""
    return {"fixed": sharded_steps(4, [(2, 2)], params, TINY, batch, N_COARSE, N_FINE, SEED, fixed_noise=noise),
            "drawn": sharded_steps(4, [(4, 1), (2, 2)], params, TINY, batch, N_COARSE, N_FINE, SEED),
            "train": train_runs(4, 2, TINY, TRAIN_KW, 0)}


def world2(params, batch):
    """2 ranks: (2, 1) and (1, 2) on the generator's draws, then 3 steps of
    ``train`` at (1, 2)."""
    return {"drawn": sharded_steps(2, [(2, 1), (1, 2)], params, TINY, batch, N_COARSE, N_FINE, SEED),
            "train": train_runs(2, 2, TINY, TRAIN_KW, 0)}


def train_runs(world: int, tp: int, cfg_kw, train_kw, seed: int):
    """``train`` over the mesh and in one process, each from
    ``init_field(seed + 1)`` on the synthetic sphere (2 views at 8 px):
    (history, parameters) of each."""
    from pixtrack_tpu_torch.nerf.dataset import make_synthetic_dataset, sphere_scene
    from pixtrack_tpu_torch.nerf.field import init_field
    from pixtrack_tpu_torch.nerf.train import TrainConfig, train

    torch.set_num_threads(1)
    ds = make_synthetic_dataset(sphere_scene, n_views=2, res=8, device="cpu")
    cfg = TrainConfig(**train_kw)
    f1, info1 = train(ds, AABB, cfg, field=init_field(seed + 1, device="cpu", **cfg_kw), seed=seed, device="cpu")
    mesh = _mesh(world, tp)
    seen = []
    fm, infom = train(ds, AABB, cfg, field=init_field(seed + 1, device="cpu", **cfg_kw), seed=seed,
                      callback=lambda done, loss, fld: seen.append((done, loss, type(fld.encoding).__name__)),
                      mesh=mesh)
    return {"one": (info1["history"], flat_params(f1)), "mesh": (infom["history"], flat_params(fm)),
            "callbacks": seen, "encoding": type(fm.encoding).__name__}


def video_batches(world: int, world_dir: str, cam_args, videos, R0, t0, n_coarse: int):
    """``track_video_batch`` over the mesh, on the world of
    tests/test_torch_world.py (the scene in ``world_dir``, the shipped blob
    field, ``world_tracker``): for each of ``videos`` (a list of (B, T, H,
    W, 3) batches) the (T, B, ...) arrays (every rank returns them; rank
    0's come back)."""
    from pixtrack_tpu_torch.parallel.video import track_video_batch

    mesh = _mesh(world, 1)
    run = world_tracker(world_dir, cam_args, n_coarse)
    return [track_video_batch(run, R0[:v.shape[0]], t0[:v.shape[0]], v, mesh=mesh) for v in videos]


def world_tracker(world_dir, cam_args, n_coarse):
    """The production video tracker over the test world: the scene written
    in ``world_dir / "sfm"``, the shipped blob field in [0.3, 0.7]^3 at
    ``n_coarse`` samples a ray, the identity NeRF transform, the camera of
    ``cam_args``, the handcrafted pyramid at strides (1, 4), 30 LM
    iterations (tests/test_torch_video.py's production tracker)."""
    from pathlib import Path

    from pixtrack_tpu_torch.align.lm import AlignConfig
    from pixtrack_tpu_torch.features import FeatureExtractor, HandcraftedExtractor
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.geometry.nerf_transform import NerfTransform
    from pixtrack_tpu_torch.nerf.distill import load_distilled
    from pixtrack_tpu_torch.nerf.render import RenderConfig
    from pixtrack_tpu_torch.nerf.testbed import Testbed
    from pixtrack_tpu_torch.parallel.video import make_production_video_tracker
    from pixtrack_tpu_torch.sfm.scene import SceneModel

    tb = Testbed(device="cpu")
    tb.set_baked_field(load_distilled(Path(__file__).resolve().parents[1] / "assets" / "bench_field.npz",
                                      device="cpu"))
    tb.render_aabb.min, tb.render_aabb.max = [0.3] * 3, [0.7] * 3
    tb.n_coarse, tb.n_fine = n_coarse, 0
    return make_production_video_tracker(
        tb, NerfTransform.identity(), FeatureExtractor(HandcraftedExtractor(strides=(1, 4), device="cpu")),
        SceneModel.load(Path(world_dir) / "sfm"), Camera.pinhole(*cam_args), reference_scale=0.5, n_points=400,
        align_cfg=AlignConfig(num_iters=30), rcfg=RenderConfig(n_coarse=n_coarse, n_fine=0, perturb=False))


def one_rank_fails(world: int):
    """Rank 1 raises while the others wait for it in an all-reduce."""
    mesh = _mesh(world, 1)
    if mesh.rank == 1:
        raise ValueError("rank 1 stops here")
    dist.all_reduce(torch.zeros(1))
    return "unreachable"

