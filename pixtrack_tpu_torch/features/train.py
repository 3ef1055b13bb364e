"""Self-supervised UNet feature training: warp-consistency InfoNCE.

Port of ``pixtrack_tpu/features/train.py``: a random Fourier texture and
its copy under a random homography and a photometric gain go through the
UNet; at corresponding pixels of each pyramid level an InfoNCE loss pulls a
descriptor to its counterpart and away from the other sampled locations,
and the confidence head learns the (detached) positive similarity.

The JAX package splits keys; here every draw comes from a ``torch.Generator``
on the training device, as a dict of canonical draws (uniforms in [0, 1),
standard normals) that the functions below map as ``jax.random`` maps its
own: ``draws=`` replays given draws (JAX's, in the CPU parity tests). The
weights are written in the JAX package's npz format, so each package reads
the other's checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve, true_f32
from pixtrack_tpu_torch._draws import _rand, _randn, _uniform
from pixtrack_tpu_torch.align.interpolate import interpolate_features
from pixtrack_tpu_torch.features.unet import (
    UNetExtractor,
    flax_tree_from_unet,
    init_unet,
    load_unet_weights,
    normalize_features,
)
from pixtrack_tpu_torch.nerf.optim import Adam



@dataclasses.dataclass(frozen=True)
class FeatureTrainConfig:
    n_steps: int = 2000
    batch: int = 4
    size: int = 128           # training crop size (multiple of 16)
    n_pairs: int = 256        # correspondence pairs per level per image
    lr: float = 1e-3
    temperature: float = 0.07
    max_rot_deg: float = 25.0
    max_scale: float = 0.25
    max_shift: float = 0.15
    log_every: int = 200


# ------------------------------------------------------------------ draws ---
def texture_batch_draws(batch: int, generator=None, device=None) -> dict:
    n_modes = 24
    return {"freqs": _rand(generator, device, batch, 3, n_modes, 2),
            "amps": _randn(generator, device, batch, 3, n_modes),
            "phases": _rand(generator, device, batch, 3, n_modes)}


def homography_draws(batch: int, generator=None, device=None) -> dict:
    return {"rot": _rand(generator, device, batch), "scale": _rand(generator, device, batch),
            "shift": _rand(generator, device, batch, 2)}


def loss_draws(cfg: FeatureTrainConfig, generator=None, device=None, n_levels: int = 3) -> dict:
    """One step's draws: textures, homographies, the warped copy's gain and
    each level's sample locations."""
    return {"texture": texture_batch_draws(cfg.batch, generator, device),
            "homography": homography_draws(cfg.batch, generator, device),
            "gain": _randn(generator, device, cfg.batch, 1, 1, 3),
            "pairs": _rand(generator, device, cfg.batch, n_levels, cfg.n_pairs, 2)}


def _grid(size: int, device) -> torch.Tensor:
    """(size^2, 2) xy over [0, 1]^2, rows first."""
    lin = torch.linspace(0.0, 1.0, size, device=device)
    ys, xs = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([xs, ys], -1).reshape(-1, 2)


# --------------------------------------------------------- synthetic data ---
def random_texture_batch(batch: int, size: int, generator=None, device=None,
                         draws: Optional[dict] = None) -> torch.Tensor:
    """Random smooth RGB textures (batch, size, size, 3) by low-frequency
    Fourier synthesis."""
    device = resolve(device)
    d = draws or texture_batch_draws(batch, generator, device)
    n_modes = d["amps"].shape[-1]
    freqs = _uniform(d["freqs"], 0.5, 14.0)
    amps = d["amps"] / np.sqrt(n_modes)
    phases = _uniform(d["phases"], 0.0, 2 * np.pi)
    phase = torch.einsum("bcmk,pk->bcmp", freqs, _grid(size, device)) * 2 * np.pi + phases[..., None]
    img = torch.einsum("bcm,bcmp->bcp", amps, torch.sin(phase))
    return torch.sigmoid(2.0 * img.reshape(batch, 3, size, size).permute(0, 2, 3, 1))


def random_homographies(batch: int, cfg: FeatureTrainConfig, generator=None, device=None,
                        draws: Optional[dict] = None) -> torch.Tensor:
    """Random rotations about the centre with scale and shift, (batch, 3, 3),
    mapping [0, S)^2."""
    device = resolve(device)
    d = draws or homography_draws(batch, generator, device)
    ang = _uniform(d["rot"], -cfg.max_rot_deg, cfg.max_rot_deg) * (np.pi / 180)
    sc = 1.0 + _uniform(d["scale"], -cfg.max_scale, cfg.max_scale)
    tx = _uniform(d["shift"], -cfg.max_shift, cfg.max_shift)
    c, s = torch.cos(ang), torch.sin(ang)
    S = cfg.size
    center = (S - 1) / 2.0
    z, o = torch.zeros_like(c), torch.ones_like(c)
    A = torch.stack([torch.stack([sc * c, -sc * s], -1), torch.stack([sc * s, sc * c], -1)], -2)
    t = -(A @ torch.full((2, 1), center, device=device))[..., 0] + center + tx * S
    return torch.stack([torch.stack([A[:, 0, 0], A[:, 0, 1], t[:, 0]], -1),
                        torch.stack([A[:, 1, 0], A[:, 1, 1], t[:, 1]], -1),
                        torch.stack([z, z, o], -1)], -2)


def warp_image(img: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Inverse warp of (S, S, C) images, or a batch (B, S, S, C) with H (B,
    3, 3); H maps source to target pixels, target pixels outside the
    source are 0."""
    S = img.shape[-3]
    ar = torch.arange(S, dtype=img.dtype, device=img.device)
    ys, xs = torch.meshgrid(ar, ar, indexing="ij")
    tgt = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = tgt @ torch.linalg.inv_ex(H)[0].transpose(-1, -2)
    src = src[..., :2] / src[..., 2:3].clamp_min(1e-8)
    vals, _, valid = interpolate_features(img, src, compute_grad=False)
    return torch.where(valid[..., None], vals, 0.0).reshape(img.shape)


# ------------------------------------------------------------------- loss ---
def _level_infonce(feat0, feat1, conf0, H, u_pairs, scale: float, temperature: float):
    """InfoNCE at one level between a batch of images (B, h, w, C) and their
    warped copies, at the (B, P, 2) [0, 1) draws ``u_pairs``; (B,) losses."""
    S0 = feat0.shape[-3]
    n_pairs = u_pairs.shape[-2]
    p0 = _uniform(u_pairs, 0.1, 0.9) * (S0 - 1)
    p0_h = torch.cat([p0 / scale, torch.ones_like(p0[..., :1])], -1)
    p1 = p0_h @ H.transpose(-1, -2)
    p1 = p1[..., :2] / p1[..., 2:3].clamp_min(1e-8) * scale

    f0, _, v0 = interpolate_features(feat0, p0, compute_grad=False)
    f1, _, v1 = interpolate_features(feat1, p1, compute_grad=False)
    valid = (v0 & v1).float()
    n_valid = valid.sum(-1).clamp_min(1.0)
    f0 = f0 / torch.linalg.norm(f0, dim=-1, keepdim=True).clamp_min(1e-6)
    f1 = f1 / torch.linalg.norm(f1, dim=-1, keepdim=True).clamp_min(1e-6)
    sim = f0 @ f1.transpose(-1, -2) / temperature
    labels = torch.arange(n_pairs, device=sim.device).repeat(sim.shape[0])
    ce = F.cross_entropy(sim.reshape(-1, n_pairs), labels, reduction="none").reshape(valid.shape)
    loss = (ce * valid).sum(-1) / n_valid
    # confidence: predict the (detached) positive similarity
    pos_sim = ((f0 * f1).sum(-1) * 0.5 + 0.5).detach()
    c0, _, _ = interpolate_features(conf0[..., None], p0, compute_grad=False)
    conf_loss = (((c0[..., 0] - pos_sim) ** 2) * valid).sum(-1) / n_valid
    return loss + 0.1 * conf_loss


def make_loss_fn(model: UNetExtractor, cfg: FeatureTrainConfig):
    """``loss_fn(generator=None, draws=None)``: one step's loss on the
    model's device; ``loss_fn.draws(generator)`` makes a step's draws and
    ``loss_fn.timer``, when set to a callable(label), is called at each
    part's end (``chip_smoke``'s step split)."""
    device = next(model.parameters()).device

    def mark(label):
        if loss_fn.timer is not None:
            loss_fn.timer(label)

    def loss_fn(generator=None, draws=None):
        d = draws or loss_draws(cfg, generator, device, len(model.scales))
        with torch.no_grad():
            imgs = random_texture_batch(cfg.batch, cfg.size, device=device, draws=d["texture"])
            Hs = random_homographies(cfg.batch, cfg, device=device, draws=d["homography"])
            warped = (warp_image(imgs, Hs) * (1.0 + 0.2 * d["gain"])).clamp(0.0, 1.0)
        mark("textures and warps")
        # one forward over both copies: GroupNorm is per image, so this is
        # the JAX package's two applies
        out = model(torch.cat([imgs, warped]))
        mark("unet")
        B = cfg.batch
        total = 0.0
        for lvl, stride in enumerate(model.scales):
            fmap = normalize_features(out["feature_maps"][lvl])
            lvl_loss = _level_infonce(fmap[:B], fmap[B:], out["confidences"][lvl][:B], Hs,
                                      d["pairs"][:, lvl], 1.0 / stride, cfg.temperature)
            total = total + lvl_loss.mean()
        mark("InfoNCE")
        return total / len(model.scales)

    loss_fn.timer = None
    loss_fn.draws = lambda generator: loss_draws(cfg, generator, device, len(model.scales))
    return loss_fn


def train_features(
    cfg: FeatureTrainConfig = FeatureTrainConfig(),
    seed: int = 0,
    model: Optional[UNetExtractor] = None,
    callback=None,
    device=None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Iterable[dict]] = None,
):
    """Train the UNet (``model``, else ``init_unet`` from ``seed``) with
    optax.adam(lr); returns (model, info) with the logged (step, loss)
    history. The steps draw from ``generator`` (a generator on the device
    seeded ``seed + 1`` by default) or replay ``draws``, one dict a step."""
    device = resolve(device)
    model = model if model is not None else init_unet(torch.Generator().manual_seed(seed), device=device)
    loss_fn = make_loss_fn(model, cfg)
    opt = Adam(list(model.parameters()), lambda k: cfg.lr)
    gen = generator or torch.Generator(device=device).manual_seed(seed + 1)
    draws = iter(draws) if draws is not None else None
    history = []
    t0 = time.time()
    with true_f32():
        for i in range(cfg.n_steps):
            loss = loss_fn(gen, next(draws) if draws is not None else None)
            loss.backward()
            opt.step()
            if (i + 1) % cfg.log_every == 0 or i == 0:
                lv = float(loss.detach())
                history.append((i + 1, lv))
                if callback:
                    callback(i + 1, lv)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return model, {"history": history, "seconds": time.time() - t0}


# ------------------------------------------------------------ persistence ---
def _keystr(path) -> str:
    return "".join(f"['{k}']" for k in path)


def save_unet_weights(path, model: UNetExtractor) -> None:
    """The model's parameters in the JAX package's format: ``__meta__`` (the
    flax key paths in flatten order) and ``arr_i``, conv kernels HWIO."""
    flat = []

    def walk(d, prefix):
        for k in sorted(d):
            if isinstance(d[k], dict):
                walk(d[k], prefix + [k])
            else:
                flat.append((prefix + [k], d[k]))

    walk(flax_tree_from_unet(model), [])
    meta = {"keys": [_keystr(p) for p, _ in flat]}
    np.savez(path, __meta__=json.dumps(meta), **{f"arr_{i}": v for i, (_, v) in enumerate(flat)})


__all__ = [
    "FeatureTrainConfig",
    "random_texture_batch",
    "random_homographies",
    "warp_image",
    "make_loss_fn",
    "train_features",
    "save_unet_weights",
    "load_unet_weights",
]
