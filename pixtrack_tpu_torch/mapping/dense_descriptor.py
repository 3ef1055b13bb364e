"""Half-resolution dense descriptor: the net, its training bank and its trainer.

Port of ``pixtrack_tpu/mapping/dense_descriptor.py``: the net, its
initialisation, its checkpoint in the JAX package's npz format,
``describe_at_dense`` (decoupled description: the production Harris
keypoints, the learned descriptors sampled bilinearly at them), the
training bank (``build_descriptor_bank``: procedural scenes rendered by
``mapping/mesh_render.py``, Harris keypoints from ``mapping/detector.py``,
depth-verified correspondences; every scene and view draw from
``np.random.default_rng(cfg.seed)``, so both packages build the same bank)
and ``train_descriptor``, InfoNCE through the NN-matching surrogate under
Adam at a constant rate. The JAX trainer draws each step's pair indices and
photometric jitter from ``jax.random`` keys; here they are a dict of
canonical draws (``descriptor_draws``) from a ``torch.Generator``, or given
from outside (``draws=``), so that a test can feed the JAX package's.

The net: per-image standardisation (population std), a three-stage
encoder, c3 upsampled to c2's size (bilinear, half-pixel centres, the edge
sample repeated: what ``jax.image.resize(..., "linear")`` gives when it
upsamples, also at odd sizes where c2 is not twice c3), a skip from c2, and
an L2-normalised 128-d head at half resolution. Layers keep flax's names
(``Conv_0`` ... ``Conv_7``) so that the checkpoint maps one to one.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve, true_f32
from pixtrack_tpu_torch._draws import _rand, _randn, _uniform

_CHANNELS = ((3, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (192, 128), (128, None))


class DenseDescriptorNet(nn.Module):
    """Encoder with a stride-2 descriptor head fed by a full-res skip."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.dim = dim
        for i, (cin, cout) in enumerate(_CHANNELS):
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, cout or dim, 3, padding=1))

    def convs(self):
        return [getattr(self, f"Conv_{i}") for i in range(len(_CHANNELS))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) float; returns (B, H/2, W/2, dim) L2-normalised
        (the JAX module's layout, channels last)."""
        c = self.convs()
        mu = x.mean(dim=(1, 2, 3), keepdim=True)
        sd = x.std(dim=(1, 2, 3), keepdim=True, correction=0)
        x = ((x - mu) / sd.clamp_min(1e-5)).permute(0, 3, 1, 2)
        c1 = F.relu(c[1](F.relu(c[0](x))))
        c2 = F.relu(c[3](F.relu(c[2](F.max_pool2d(c1, 2)))))
        c3 = F.relu(c[5](F.relu(c[4](F.max_pool2d(c2, 2)))))
        u = F.interpolate(c3, size=c2.shape[-2:], mode="bilinear", align_corners=False)
        h = F.relu(c[6](torch.cat([u, c2], dim=1)))
        d = c[7](h).permute(0, 2, 3, 1)
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)


def _flax_key(i: int, leaf: str) -> str:
    return f"['params']['Conv_{i}']['{leaf}']"


def init_descriptor(generator: Optional[torch.Generator] = None, device=None) -> DenseDescriptorNet:
    """A ``DenseDescriptorNet`` on ``device`` (None is the CUDA card) with
    flax's default initialisation (lecun-normal kernels, zero biases), drawn
    from ``generator``: the JAX package's distribution, not its bits."""
    from pixtrack_tpu_torch.features.unet import init_flax_conv_

    device = resolve(device)
    net = DenseDescriptorNet()
    for conv in net.convs():
        init_flax_conv_(conv, generator)
    return net.to(device).eval()


def save_descriptor_weights(path, net: DenseDescriptorNet) -> None:
    """The JAX package's checkpoint: one array per flax key path
    (``"['params']['Conv_0']['kernel']"``, kernels (kh, kw, in, out))."""
    flat = {}
    for i, conv in enumerate(net.convs()):
        flat[_flax_key(i, "bias")] = conv.bias.detach().cpu().numpy()
        flat[_flax_key(i, "kernel")] = conv.weight.detach().permute(2, 3, 1, 0).cpu().numpy()
    np.savez(path, **flat)


def load_descriptor_weights(path, device=None) -> DenseDescriptorNet:
    """A checkpoint of either package, on ``device`` (None is the CUDA card)."""
    device = resolve(device)
    z = np.load(path)
    net = DenseDescriptorNet()
    with torch.no_grad():
        for i, conv in enumerate(net.convs()):
            kernel, bias = z[_flax_key(i, "kernel")], z[_flax_key(i, "bias")]
            if kernel.shape != tuple(conv.weight.permute(2, 3, 1, 0).shape):
                raise ValueError(f"{path}: Conv_{i}'s kernel is {kernel.shape}")
            conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
            conv.bias.copy_(torch.from_numpy(bias))
    return net.to(device).eval()


def _as_rgb(image, device) -> torch.Tensor:
    img = torch.as_tensor(np.asarray(image))
    img = img.to(torch.float32) / 255.0 if img.dtype == torch.uint8 else img.to(torch.float32)
    if img.ndim == 2:
        img = img[..., None].expand(*img.shape, 3)
    return img.to(device)


def describe_at_dense(net: DenseDescriptorNet, image, kp) -> np.ndarray:
    """Sample the learned dense descriptor map at GIVEN keypoints (N, 2) xy,
    full-resolution pixel coordinates; (N, dim) unit rows. The net runs on
    its own device in true f32; the map's centres sit at 2x + 0.5."""
    from pixtrack_tpu_torch.align.interpolate import interpolate_features

    device = next(net.parameters()).device
    img = _as_rgb(image, device)
    H, W = img.shape[:2]
    with torch.no_grad(), true_f32():
        dmap = net(img[None, : H - H % 2, : W - W % 2])[0]
        pts = torch.as_tensor(np.asarray(kp), dtype=torch.float32, device=device) / 2.0 - 0.25
        d, _, _ = interpolate_features(dmap, pts, compute_grad=False)
    d = d.cpu().numpy()
    return d / np.linalg.norm(d, axis=1, keepdims=True).clip(1e-8)


# ------------------------------------------------------------------ bank ---
@dataclasses.dataclass(frozen=True)
class DescBankConfig:
    n_scenes: int = 160
    n_views: int = 10
    res: int = 192
    max_kp: int = 192
    min_deg: float = 10.0
    max_deg: float = 60.0
    radius: float = 0.9
    seed: int = 500


def build_descriptor_bank(workdir, cfg: DescBankConfig = DescBankConfig(), verbose: bool = False,
                          device=None) -> Dict[str, np.ndarray]:
    """Render procedural scenes (house / L-shape / box / textured cube in
    turn), detect Harris keypoints on ``device`` (None is the CUDA card) and
    keep the depth-verified correspondences of view pairs 10-60 deg apart.

    Returns static-shape arrays: images (V, S, S, 3) uint8; kp (V, K, 2)
    f32; kvalid (V, K) bool; pairs (P, 2) int32 view indices; pos (P, K, 2)
    f32, view a's keypoints mapped into view b's pixels; pvalid (P, K) bool;
    angle_deg (P,) f32."""
    from pixtrack_tpu_torch.geometry import Camera, Pose
    from pixtrack_tpu_torch.mapping.detector import detect_keypoints
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj, render_mesh
    from pixtrack_tpu_torch.mapping.procedural import make_box_obj, make_house_obj, make_lshape_obj
    from pixtrack_tpu_torch.mapping.textures import rich_cube_mesh

    device = resolve(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(cfg.seed)
    S, K = cfg.res, cfg.max_kp
    camera = Camera.pinhole(S * 1.1, S * 1.1, (S - 1) / 2, (S - 1) / 2, S, S, device="cpu")

    images, kps, kvalids, poses, depths, scene_of = [], [], [], [], [], []
    makers = [make_house_obj, make_lshape_obj, make_box_obj, None]
    for sc in range(cfg.n_scenes):
        mseed = int(rng.integers(1 << 30))
        mk = makers[sc % len(makers)]
        if mk is None:
            mesh = rich_cube_mesh(workdir, mseed)
        else:
            mesh = load_obj(mk(workdir / f"scene_{sc}", seed=mseed, size=0.3, tile=64))
        V = mesh["vertices"]
        center = V.mean(axis=0)
        dist = cfg.radius * np.linalg.norm(V - center, axis=1).max() / 0.346  # cube-rig-equivalent distance
        for i in range(cfg.n_views):
            ang = 2 * np.pi * i / cfg.n_views + rng.uniform(-0.06, 0.06)
            el = rng.uniform(0.1, 0.6)
            eye = center + dist * np.array([np.sin(ang) * np.cos(el), np.sin(el), np.cos(ang) * np.cos(el)])
            z = center - eye
            z = z / np.linalg.norm(z)
            x = np.cross(z, np.array([0.0, 1.0, 0.0]))
            x /= np.linalg.norm(x)
            R = np.stack([x, np.cross(z, x), z]).astype(np.float32)
            T = Pose.from_Rt(R, (-R @ eye).astype(np.float32))
            img, depth = render_mesh(mesh, T, camera, return_depth=True)
            kp, _ = detect_keypoints(img, max_keypoints=K, nms_radius=1, device=device)
            kp = kp.cpu().numpy()
            kp_pad = np.zeros((K, 2), np.float32)
            kv = np.zeros(K, bool)
            n = min(len(kp), K)
            kp_pad[:n] = kp[:n]
            kv[:n] = True
            images.append(img)
            kps.append(kp_pad)
            kvalids.append(kv)
            poses.append((R, (-R @ eye).astype(np.float32)))
            depths.append(np.asarray(depth))
            scene_of.append(sc)
        if verbose and (sc + 1) % 10 == 0:
            print(f"bank: scene {sc + 1}/{cfg.n_scenes}", flush=True)

    fx = fy = S * 1.1
    cx = cy = (S - 1) / 2
    pairs, poss, pvalids, angs = [], [], [], []
    for a in range(len(images)):
        for b in range(len(images)):
            if a == b or scene_of[a] != scene_of[b]:
                continue
            (Ra, ta), (Rb, tb) = poses[a], poses[b]
            ang = np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))
            if not (cfg.min_deg <= ang <= cfg.max_deg):
                continue
            # view a's keypoints back-projected through its z-buffer, into view b
            kp = kps[a]
            xi = np.clip(np.round(kp[:, 0]).astype(int), 0, S - 1)
            yi = np.clip(np.round(kp[:, 1]).astype(int), 0, S - 1)
            za = depths[a][yi, xi]
            ok = kvalids[a] & (za > 0)
            pc = np.stack([(kp[:, 0] - cx) / fx * za, (kp[:, 1] - cy) / fy * za, za], 1)
            pcb = ((pc - ta) @ Ra) @ Rb.T + tb
            zb = pcb[:, 2]
            ok = ok & (zb > 1e-4)
            ub = pcb[:, 0] / np.maximum(zb, 1e-4) * fx + cx
            vb = pcb[:, 1] / np.maximum(zb, 1e-4) * fy + cy
            ok = ok & (ub >= 1) & (ub < S - 1) & (vb >= 1) & (vb < S - 1)
            # occlusion against view b's z-buffer
            ubi = np.clip(np.round(ub).astype(int), 0, S - 1)
            vbi = np.clip(np.round(vb).astype(int), 0, S - 1)
            zbuf = depths[b][vbi, ubi]
            ok = ok & (zbuf > 0) & (np.abs(zb - zbuf) < 0.03 * np.median(za[za > 0]) + 1e-3)
            if ok.sum() < 16:
                continue
            pos = np.zeros((K, 2), np.float32)
            pos[:, 0], pos[:, 1] = ub, vb
            pairs.append((a, b))
            poss.append(pos)
            pvalids.append(ok)
            angs.append(ang)
    return {
        "images": np.stack(images).astype(np.uint8), "kp": np.stack(kps), "kvalid": np.stack(kvalids),
        "pairs": np.asarray(pairs, np.int32), "pos": np.stack(poss), "pvalid": np.stack(pvalids),
        "angle_deg": np.asarray(angs, np.float32),
    }


# --------------------------------------------------------------- trainer ---
@dataclasses.dataclass(frozen=True)
class DescTrainConfig:
    n_steps: int = 3000
    batch_pairs: int = 8
    lr: float = 3e-4
    temperature: float = 0.07
    exclude_px: float = 4.0   # target-view keypoints this close to the positive are not negatives
    noise: float = 0.03
    log_every: int = 50
    seed: int = 0


def _sample_map(dmap: torch.Tensor, pts: torch.Tensor):
    """Bilinear samples of half-resolution maps (B, H2, W2, C) at
    full-resolution points (B, N, 2)."""
    from pixtrack_tpu_torch.align.interpolate import interpolate_features

    v, _, ok = interpolate_features(dmap, pts / 2.0 - 0.25, compute_grad=False)
    return v, ok


def descriptor_draws(cfg: DescTrainConfig, n_pairs: int, size: int, generator=None, device=None) -> dict:
    """One step's draws: the batch's pair indices, and per image (view a's
    B images, then view b's) the gain's and the offset's [0, 1) uniforms and
    the noise field's normals."""
    n_img = 2 * cfg.batch_pairs
    return {"idx": torch.randint(0, n_pairs, (cfg.batch_pairs,), generator=generator, device=device),
            "gain": _rand(generator, device, n_img), "bias": _rand(generator, device, n_img),
            "noise": _randn(generator, device, n_img, size, size, 3)}


def bank_tensors(bank: Dict[str, np.ndarray], device) -> dict:
    """The bank's arrays on ``device`` (images stay uint8)."""
    return {k: torch.as_tensor(np.asarray(bank[k]), device=device)
            for k in ("images", "kp", "kvalid", "pairs", "pos", "pvalid")}


def infonce_loss(net: DenseDescriptorNet, bank: dict, idx: torch.Tensor, cfg: DescTrainConfig,
                 draws: Optional[dict] = None) -> torch.Tensor:
    """Mean InfoNCE over the valid keypoints of pairs ``idx`` (B,) of a bank
    of ``bank_tensors``: each view-a keypoint must pick its true match
    against all of view b's detected keypoints (negatives within
    ``exclude_px`` of the true match left out). With ``draws`` the images
    get the training jitter (gain, offset, noise, clamp); without, none."""
    pa = bank["pairs"][idx].long()
    imgs = torch.cat([bank["images"][pa[:, 0]], bank["images"][pa[:, 1]]]).float() / 255.0
    if draws is not None:
        shape = (-1, 1, 1, 1)
        imgs = imgs * _uniform(draws["gain"], 0.7, 1.3).reshape(shape)
        imgs = imgs + _uniform(draws["bias"], -0.12, 0.12).reshape(shape)
        imgs = (imgs + cfg.noise * draws["noise"]).clamp(0.0, 1.0)
    B = idx.shape[0]
    d = net(imgs)
    da, db = d[:B], d[B:]
    kpa, kva = bank["kp"][pa[:, 0]], bank["kvalid"][pa[:, 0]]
    kpb, kvb = bank["kp"][pa[:, 1]], bank["kvalid"][pa[:, 1]]
    posb, pvb = bank["pos"][idx], bank["pvalid"][idx]
    d0, ok0 = _sample_map(da, kpa)
    dpos, okp = _sample_map(db, posb)
    dneg, okn = _sample_map(db, kpb)
    sim_pos = (d0 * dpos).sum(-1)
    sim_neg = d0 @ dneg.transpose(-1, -2)
    dist = torch.linalg.vector_norm(kpb[:, None, :, :] - posb[:, :, None, :], dim=-1)
    neg_ok = (dist > cfg.exclude_px) & kvb[:, None, :] & okn[:, None, :]
    logits = torch.cat([sim_pos[..., None], torch.where(neg_ok, sim_neg, -1e9)], dim=-1) / cfg.temperature
    valid = pvb & kva & ok0 & okp
    ce = -torch.log_softmax(logits, dim=-1)[..., 0]
    tot = torch.where(valid, ce, 0.0).sum(-1).sum()
    return tot / valid.sum().float().clamp_min(1.0)


def train_descriptor(
    bank: Dict[str, np.ndarray], cfg: DescTrainConfig = DescTrainConfig(), net: Optional[DenseDescriptorNet] = None,
    callback=None, device=None, generator: Optional[torch.Generator] = None, draws: Optional[Iterable[dict]] = None,
):
    """InfoNCE through the NN-matching surrogate, Adam at ``cfg.lr``. Trains
    ``net`` (else ``init_descriptor`` from ``cfg.seed``) in place on
    ``device`` (None is the CUDA card); each step's draws come from
    ``generator`` (on the device, seeded ``cfg.seed + 1`` by default) or
    ``draws``, one dict a step. The loss at step s (from 0) is logged when s
    is a multiple of ``log_every`` and at the last step, as the JAX trainer
    logs it; ``callback(step, loss, net)``. Returns (net, info): the
    history and the seconds."""
    from pixtrack_tpu_torch.nerf.optim import Adam

    device = resolve(device)
    if net is None:
        net = init_descriptor(torch.Generator().manual_seed(cfg.seed), device=device)
    net.train()
    bt = bank_tensors(bank, device)
    n_pairs, S = int(bt["pairs"].shape[0]), int(bt["images"].shape[1])
    params = list(net.parameters())
    opt = Adam(params, lambda k: cfg.lr)
    gen = generator or torch.Generator(device=device).manual_seed(cfg.seed + 1)
    draws = iter(draws) if draws is not None else None
    history = []
    t0 = time.time()
    with true_f32():
        for s in range(cfg.n_steps):
            d = next(draws) if draws is not None else descriptor_draws(cfg, n_pairs, S, gen, device)
            loss = infonce_loss(net, bt, d["idx"], cfg, d)
            loss.backward()
            opt.step()
            if s % cfg.log_every == 0 or s == cfg.n_steps - 1:
                lv = float(loss.detach())
                history.append((s, lv))
                if callback:
                    callback(s, lv, net)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    net.eval()
    return net, {"history": history, "seconds": time.time() - t0}
