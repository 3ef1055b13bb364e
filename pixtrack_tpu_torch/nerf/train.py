"""Training the hash-grid field on a capture.

Port of ``pixtrack_tpu/nerf/train.py``: every ray of the capture is built on
the device once (capped to a foreground-weighted pool); each step draws a
random batch, renders it with jittered stratified and importance samples
through the staged render, and takes one Adam step on the L2 photometric
loss. The loop is the JAX package's single-step one: exactly ``n_steps``
steps, history and ``callback(done, loss, field)`` at multiples of
``log_every``. Batch indices and render noise come from one device
``torch.Generator`` seeded from ``seed``. Over a (dp, tp) mesh
(``parallel/mesh.py``) the same loop runs in every rank: each draws the
global batch and its noise from the same generator, and renders its ``dp``
slice with its ``tp`` shard of the hash table.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.nerf.field import NGPField, init_field
from pixtrack_tpu_torch.nerf.optim import Adam, exponential_decay
from pixtrack_tpu_torch.nerf.render import RenderConfig, render_rays


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_steps: int = 10000
    batch_rays: int = 1 << 13
    lr: float = 1e-2
    lr_final: float = 1e-4
    # declared by the JAX package and never applied there (optax.adam): not applied here either
    weight_decay: float = 1e-6
    n_coarse: int = 64
    n_fine: int = 32
    background: str = "white"  # the training target is composited onto this
    log_every: int = 500
    ray_pool_cap: int = 2_000_000  # 0: every ray of the capture


def ray_pool(dataset, cap: int, background: str, seed: int, device):
    """The capture's rays on ``device``, capped to ``cap`` rays weighted to
    the foreground as the JAX package caps them: every ray whose colour is
    more than 0.02 from the background first (up to 80 % of the cap), the
    rest from the background, drawn by ``np.random.default_rng(seed + 2)``."""
    origins, dirs, rgbs = dataset.all_rays(device)
    if cap and origins.shape[0] > cap:
        rng = np.random.default_rng(seed + 2)
        bg = 1.0 if background == "white" else 0.0
        is_fg = ((rgbs - bg).abs().amax(dim=1) > 0.02).cpu().numpy()
        fg_idx, bg_idx = np.nonzero(is_fg)[0], np.nonzero(~is_fg)[0]
        n_fg = min(len(fg_idx), int(cap * 0.8))
        sel = np.concatenate([
            rng.choice(fg_idx, n_fg, replace=False) if len(fg_idx) > n_fg else fg_idx,
            rng.choice(bg_idx, min(cap - n_fg, len(bg_idx)), replace=False),
        ])
        sel = torch.as_tensor(sel, device=origins.device)
        origins, dirs, rgbs = origins[sel], dirs[sel], rgbs[sel]
    return origins, dirs, rgbs


def batch_indices(generator: torch.Generator, n_rays: int, batch: int) -> torch.Tensor:
    """One batch of ray indices, uniform over the pool, on the generator's device."""
    return torch.randint(0, n_rays, (batch,), generator=generator, device=generator.device)


def make_loss_fn(field: NGPField, cfg: TrainConfig, aabb):
    """The photometric loss of a ray batch: ``loss_fn(origins, dirs, target,
    generator)``, the render jittered from ``generator``."""
    rcfg = RenderConfig(n_coarse=cfg.n_coarse, n_fine=cfg.n_fine, perturb=True, min_transmittance=1e-4,
                        chunk=cfg.batch_rays)
    aabb = torch.as_tensor(np.asarray(aabb, np.float32), device=field.device)
    bg = 1.0 if cfg.background == "white" else 0.0

    def loss_fn(origins, dirs, target, generator):
        out = render_rays(field, origins, dirs, aabb, rcfg, generator=generator)
        pred = out["rgb"] + (1.0 - out["alpha"][:, None]) * bg
        return torch.mean((pred - target) ** 2)

    return loss_fn


def train(dataset, aabb, cfg: TrainConfig = TrainConfig(), field: Optional[NGPField] = None, seed: int = 0,
          callback: Optional[Callable] = None, device=None, mesh=None):
    """Train ``field`` (trained in place; by default ``init_field(seed + 1)``
    on ``device``, None the CUDA card) on a NerfDataset. Returns (field,
    dict(history=[(step, loss)], seconds)).

    ``mesh``: a ``parallel.mesh.Mesh``; every rank calls this with the same
    arguments and its field on ``mesh.device``. The field's table is
    sharded over ``tp`` (rank 0's parameters), the batch over ``dp``
    (``cfg.batch_rays`` must divide by dp). ``callback`` and the history
    run on rank 0, the callback with a gathered copy of the field; the
    field returned has its table gathered on every rank."""
    if mesh is not None:
        from pixtrack_tpu_torch.parallel.mesh import gather_field, sharded_nerf_train_step, unshard_field_params

        assert cfg.batch_rays % mesh.dp == 0, f"batch_rays {cfg.batch_rays} must divide dp={mesh.dp}"
        device = mesh.device
    if field is None:
        field = init_field(seed + 1, device=resolve(device))
    origins, dirs, rgbs = ray_pool(dataset, cfg.ray_pool_cap, cfg.background, seed, field.device)
    n_rays = origins.shape[0]

    def adam(params):
        return Adam(params, lambda k: exponential_decay(cfg.lr, cfg.n_steps, cfg.lr_final, k),
                    b1=0.9, b2=0.99, eps=1e-15)

    if mesh is None:
        optimizer = adam(field.parameters())
        loss_fn = make_loss_fn(field, cfg, aabb)
    else:
        step_fn, _ = sharded_nerf_train_step(field, mesh, aabb, adam, cfg.n_coarse, cfg.n_fine,
                                             1.0 if cfg.background == "white" else 0.0)
    lead = mesh is None or mesh.rank == 0
    generator = torch.Generator(device=field.device).manual_seed(seed)

    history = []
    t0 = time.perf_counter()
    for done in range(1, cfg.n_steps + 1):
        idx = batch_indices(generator, n_rays, cfg.batch_rays)
        if mesh is None:
            loss = loss_fn(origins[idx], dirs[idx], rgbs[idx], generator)
            loss.backward()
            optimizer.step()
        else:
            loss = step_fn(origins[idx], dirs[idx], rgbs[idx], generator)
        if done % cfg.log_every == 0:
            lv = loss.item()
            if lead:
                history.append((done, lv))
            if callback:
                view = field if mesh is None else gather_field(field, mesh)
                if lead:
                    callback(done, lv, view)
    if mesh is not None:
        unshard_field_params(field, mesh)
    if field.device.type == "cuda":
        torch.cuda.synchronize(field.device)
    return field, {"history": history, "seconds": time.perf_counter() - t0}


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))
