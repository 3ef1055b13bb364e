"""Dense-distillation SuperPoint training.

Port of ``pixtrack_tpu/mapping/train_superpoint_dense.py``. Sparse
per-cell labels throw away most of the teacher's signal; this recipe keeps
it dense:

- **Detector**: each 8 x 8 cell's target is a 65-way distribution: the
  cell's 64 pixels of the warp-aggregated Harris stability map
  (``stability_votes``: the production detector voted over random
  homographies, kept dense) and a constant dustbin pseudo-count,
  normalised; soft-target cross-entropy (``dense_detector_loss``).
- **Descriptor**: SuperPoint's dense hinge over true correspondences
  between two viewpoints of a textured cube (cell centres back-projected
  through the depth buffer into the other view, occlusion-checked), and
  over homography pairs of synthetic shape scenes
  (``corr_descriptor_loss``).
- ``build_dense_pair_bank`` builds the bank on the host (renders, votes,
  correspondences); the trainer keeps it on the device as tensors and
  samples it there (``make_dense_batch``: independent gain, bias and noise
  per view).

Draws as in ``train_superpoint``: canonical uniforms and normals from a
``torch.Generator`` (``dense_draws``), and the integer-seeded homographies
and shape scenes of the bank through hooks the tests use to feed the JAX
package's draws.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch._draws import _rand, _randn, _uniform
from pixtrack_tpu_torch.mapping.train_superpoint import (
    SPTrainConfig,
    _cell_centres,
    _grey_render,
    _homography_at,
    _voted,
    apply_homography,
    hinge_loss,
    pair_draws,
    random_homography,
    random_scene,
    run_training,
    seeded,
    warp_image,
)


@dataclasses.dataclass(frozen=True)
class SPDenseConfig:
    n_steps: int = 4000
    batch: int = 8
    size: int = 160              # bank image size (multiple of 8)
    lr: float = 1e-3
    # pseudo-count mass of the dustbin class: a cell whose stability mass
    # sums to `dustbin_mass` splits 50/50 corner/no-corner
    dustbin_mass: float = 0.5
    lambda_desc: float = 1.0
    margin_pos: float = 1.0
    margin_neg: float = 0.2
    corr_tol_px: float = 8.0
    noise: float = 0.04
    log_every: int = 50
    seed: int = 0


# ------------------------------------------------------------------- bank ---
def stability_votes(gray: np.ndarray, n_warps: int = 10, max_warp: float = 0.12, max_keypoints: int = 320,
                    seed: int = 0, device=None,
                    homography_at: Optional[Callable[[int], torch.Tensor]] = None) -> np.ndarray:
    """The warp-aggregated Harris stability map, kept dense: per pixel the
    fraction of the image and its ``n_warps`` warps in which a detection
    landed within 2 px (a 5 x 5 box sum), clipped to [0, 1]. Warp w draws
    its homography from the integer seed*7919 + w (``homography_at`` or a
    generator seeded with it); detection on ``device`` (None the card)."""
    import scipy.ndimage as ndi

    device = resolve(device)
    S = gray.shape[0]
    H_of = _homography_at(S, max_warp, device, homography_at)
    n_votes = n_warps + 1
    votes = _voted(np.asarray(gray, np.float32), [None] + [H_of(seed * 7919 + w) for w in range(1, n_votes)],
                   max_keypoints, device)
    acc = ndi.uniform_filter(votes, size=5) * 25.0 / n_votes
    return np.clip(acc, 0.0, 1.0)


def build_dense_pair_bank(workdir, n_scenes: int = 24, n_views: int = 8, n_shape_scenes: int = 24, res: int = 160,
                          n_warps: int = 10, min_deg: float = 8.0, max_deg: float = 50.0, seed: int = 0,
                          verbose: bool = False, device=None,
                          homography_at: Optional[Callable[[int], torch.Tensor]] = None,
                          pair_at: Optional[Callable[[int], dict]] = None):
    """The training bank for dense distillation, detection on ``device``
    (None is the CUDA card). Returns dict of static-shape arrays:
      images  (V, S, S) float32 greyscale in [0, 1]
      votes   (V, S, S) float32 stability targets in [0, 1]
      pairs   (P, 2)    int32 view indices (directed)
      corr    (P, M, 2) float32 view-0 cell centres in view-1 pixels
      corr_valid (P, M) bool

    Mesh scenes (``textures.rich_cube_mesh``; the rig's draws from
    ``np.random.default_rng(seed)``) give real-viewpoint pairs between
    ``min_deg`` and ``max_deg``; synthetic shape scenes (grid 5) give
    homography pairs both ways. Shape scene sc's scene and homography are
    the draws of the integer seed*31 + sc (``pair_at``: key ->
    ``pair_draws``, or a generator seeded with it); the votes' homographies
    come through ``homography_at`` (``stability_votes``)."""
    from pixtrack_tpu_torch.features.train_basin import _look_at_w2c
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.mapping.mesh_render import render_mesh
    from pixtrack_tpu_torch.mapping.textures import rich_cube_mesh

    device = resolve(device)
    workdir = pathlib.Path(workdir)
    rng = np.random.default_rng(seed)
    S = res
    cen = np.stack(np.meshgrid(np.arange(S // 8), np.arange(S // 8), indexing="ij")[::-1], -1
                   ).reshape(-1, 2).astype(np.float32) * 8.0 + 3.5  # (M, 2) xy
    fx = fy = res * 1.1
    cx = cy = (res - 1) / 2
    camera = Camera.pinhole(fx, fy, cx, cy, res, res, device="cpu")

    def votes_of(gray, vseed):
        return stability_votes(gray, n_warps=n_warps, seed=vseed, device=device, homography_at=homography_at)

    images, votes_l = [], []
    pairs, corrs, cvalids = [], [], []

    # mesh scenes: real viewpoint pairs
    for sc in range(n_scenes):
        mesh = rich_cube_mesh(workdir, seed * 1000 + sc)
        views = []
        radius = rng.uniform(0.75, 1.1)
        for i in range(n_views):
            ang = 2 * np.pi * i / n_views + rng.uniform(-0.05, 0.05)
            el = rng.uniform(0.15, 0.55)
            center = radius * np.array([np.sin(ang) * np.cos(el), np.sin(el), np.cos(ang) * np.cos(el)])
            T = _look_at_w2c(torch.as_tensor(center, dtype=torch.float32),
                             torch.tensor(rng.uniform(-0.3, 0.3), dtype=torch.float32))
            img, depth = render_mesh(mesh, T, camera, return_depth=True)
            gray = _grey_render(img)
            views.append((T, np.asarray(depth)))
            images.append(gray)
            votes_l.append(votes_of(gray, seed * 100 + sc * 10 + i))
        base = len(images) - n_views
        centers3 = [-(T.R.numpy().T @ T.t.numpy()) for (T, _) in views]
        for i in range(n_views):
            for j in range(n_views):
                if i == j:
                    continue
                ci, cj = centers3[i], centers3[j]
                cosang = (ci @ cj) / (np.linalg.norm(ci) * np.linalg.norm(cj))
                ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
                if not (min_deg <= ang <= max_deg):
                    continue
                (Ti, zi), (Tj, zj) = views[i], views[j]
                # back-project the cell centres through view i's depth
                xi = np.clip(np.round(cen[:, 0]).astype(int), 0, res - 1)
                yi = np.clip(np.round(cen[:, 1]).astype(int), 0, res - 1)
                z = zi[yi, xi]
                has_d = z > 0
                Xc = np.stack([(cen[:, 0] - cx) / fx * z, (cen[:, 1] - cy) / fy * z, z], axis=-1)
                Xw = (Xc - Ti.t.numpy()) @ Ti.R.numpy()
                uv, vis = camera.world2image(Tj, torch.as_tensor(Xw, dtype=torch.float32))
                uv, vis = uv.numpy(), vis.numpy() & has_d
                # occlusion check in view j
                zc_j = (Xw @ Tj.R.numpy().T + Tj.t.numpy())[:, 2]
                xj = np.clip(np.round(uv[:, 0]).astype(int), 0, res - 1)
                yj = np.clip(np.round(uv[:, 1]).astype(int), 0, res - 1)
                zb = zj[yj, xj]
                vis &= (zb > 0) & (np.abs(zb - zc_j) < 0.03 * np.abs(zc_j))
                pairs.append((base + i, base + j))
                corrs.append(np.where(vis[:, None], uv, 0.0).astype(np.float32))
                cvalids.append(vis)
        if verbose:
            print(f"mesh scene {sc + 1}/{n_scenes}: {len(pairs)} pairs so far", flush=True)

    # synthetic shape scenes: homography pairs
    shape_cfg = SPTrainConfig(size=S, grid=5, p_drop_max=0.7, noise=0.03)
    cen_t = torch.as_tensor(cen, device=device)
    for sc in range(n_shape_scenes):
        key = seed * 31 + sc
        d = pair_at(key) if pair_at is not None else seeded(key, lambda g: pair_draws(shape_cfg, (), g))
        img0, _, _ = random_scene({k: torch.as_tensor(v).to(device) for k, v in d["scene"].items()}, shape_cfg)
        H = random_homography(torch.as_tensor(d["homography"]).to(device), S, 0.12)
        img1 = warp_image(img0, H)
        g0, g1 = img0.cpu().numpy(), img1.cpu().numpy()
        base = len(images)
        images += [g0, g1]
        votes_l += [votes_of(g0, seed * 77 + sc * 2), votes_of(g1, seed * 77 + sc * 2 + 1)]
        for Hd, (a, b) in ((H, (base, base + 1)), (torch.linalg.inv(H), (base + 1, base))):
            w = apply_homography(Hd, cen_t).cpu().numpy()
            inb = (w[:, 0] >= 0) & (w[:, 0] <= S - 1) & (w[:, 1] >= 0) & (w[:, 1] <= S - 1)
            pairs.append((a, b))
            corrs.append(np.where(inb[:, None], w, 0.0))
            cvalids.append(inb)
        if verbose and (sc + 1) % 8 == 0:
            print(f"shape scene {sc + 1}/{n_shape_scenes}", flush=True)

    return {"images": np.stack(images).astype(np.float32), "votes": np.stack(votes_l).astype(np.float32),
            "pairs": np.asarray(pairs, np.int32), "corr": np.stack(corrs).astype(np.float32),
            "corr_valid": np.stack(cvalids)}


# ----------------------------------------------------------------- losses ---
def dense_detector_loss(det_logits: torch.Tensor, votes: torch.Tensor, dustbin_mass: float) -> torch.Tensor:
    """Soft-target 65-way cross-entropy, the mean over all cells.

    ``det_logits`` (B, Hc, Wc, 65); ``votes`` (B, S, S) stability in [0, 1].
    A cell's target: its 64 pixel masses, row-major within the cell (the
    class index ``(y % 8) * 8 + x % 8`` of ``cell_labels``), and the
    dustbin's pseudo-count, normalised."""
    B, S, _ = votes.shape
    Hc = S // 8
    v = votes.reshape(B, Hc, 8, Hc, 8).permute(0, 1, 3, 2, 4).reshape(B, Hc, Hc, 64)
    t = torch.cat([v, torch.full_like(v[..., :1], dustbin_mass)], dim=-1)
    t = t / t.sum(dim=-1, keepdim=True)
    return -(t * torch.log_softmax(det_logits, dim=-1)).sum(-1).mean()


def corr_descriptor_loss(desc0: torch.Tensor, desc1: torch.Tensor, corr: torch.Tensor, cvalid: torch.Tensor,
                         size: int, cfg: SPDenseConfig) -> torch.Tensor:
    """SuperPoint's dense hinge over true correspondences, per pair over the
    leading axes: desc (..., Hc, Wc, D) of the two views, ``corr`` (..., M,
    2) view-0 cell centres in view-1 pixels; positives are the view-1 cells
    whose centre lies within ``corr_tol_px``."""
    cen = _cell_centres(size, corr.dtype, corr.device)
    d2 = ((corr[..., :, None, :] - cen) ** 2).sum(-1)
    s = (d2 <= cfg.corr_tol_px ** 2) & cvalid[..., None]
    return hinge_loss(desc0, desc1, s, cfg.margin_pos, cfg.margin_neg)


# --------------------------------------------------------------- training ---
def bank_tensors(bank: dict, device) -> dict:
    """A dense pair bank's arrays on ``device``."""
    return {"images": torch.as_tensor(np.asarray(bank["images"]), dtype=torch.float32, device=device),
            "votes": torch.as_tensor(np.asarray(bank["votes"]), dtype=torch.float32, device=device),
            "pairs": torch.as_tensor(np.asarray(bank["pairs"]), dtype=torch.long, device=device),
            "corr": torch.as_tensor(np.asarray(bank["corr"]), dtype=torch.float32, device=device),
            "corr_valid": torch.as_tensor(np.asarray(bank["corr_valid"]), device=device)}


def dense_draws(cfg: SPDenseConfig, n_pairs: int, lead: tuple = (), generator=None, device=None) -> dict:
    """``make_dense_batch``'s draws: the pair, then per view (axis -1 of
    gain and bias, -3 of the noise) the gain, bias and noise normals."""
    return {"pair": torch.randint(0, n_pairs, lead, generator=generator, device=device),
            "gain": _rand(generator, device, *lead, 2), "bias": _rand(generator, device, *lead, 2),
            "noise": _randn(generator, device, *lead, 2, cfg.size, cfg.size)}


def make_dense_batch(cfg: SPDenseConfig, bank: dict, d: dict):
    """Pairs of the bank (``bank_tensors``) from their draws
    (``dense_draws``) with INDEPENDENT per-view photometric jitter:
    (img0, img1, v0, v1, corr, cvalid)."""
    p = d["pair"]
    i0, i1 = bank["pairs"][p, 0], bank["pairs"][p, 1]
    gain = _uniform(d["gain"], 0.6, 1.4)[..., None, None]
    bias = _uniform(d["bias"], -0.2, 0.2)[..., None, None]
    imgs = torch.stack([bank["images"][i0], bank["images"][i1]], dim=-3) * gain + bias
    imgs = torch.clamp(imgs + cfg.noise * d["noise"], 0.0, 1.0)
    return (imgs[..., 0, :, :], imgs[..., 1, :, :], bank["votes"][i0], bank["votes"][i1], bank["corr"][p],
            bank["corr_valid"][p])


def dense_loss_terms(cfg: SPDenseConfig, batch, det0, desc0, det1, desc1) -> tuple:
    """(detector term, descriptor term) of a batch from its two views'
    outputs (``train_superpoint.forward_views``): the views' soft
    cross-entropies summed, and the mean hinge over the pairs."""
    _, _, v0, v1, corr, cvalid = batch
    l_det = dense_detector_loss(det0, v0, cfg.dustbin_mass) + dense_detector_loss(det1, v1, cfg.dustbin_mass)
    return l_det, corr_descriptor_loss(desc0, desc1, corr, cvalid, cfg.size, cfg).mean()


def train_superpoint_dense(cfg: SPDenseConfig, bank: dict, net=None, callback=None, device=None,
                           draws: Optional[Iterable[dict]] = None, mark: Optional[Callable] = None):
    """Train ``net`` (else ``init_superpoint`` from ``cfg.seed``) in place on
    a dense pair bank on ``device`` (None is the CUDA card); the bank is
    uploaded once and sampled there. Each step's draws: ``dense_draws``
    over the batch from a generator on ``device`` seeded ``cfg.seed + 1``,
    or the next of ``draws``. Logging and the callback as
    ``train_superpoint``'s, ``mark`` as in ``run_training``. Returns (net,
    info)."""
    from pixtrack_tpu_torch.mapping.superpoint import init_superpoint

    device = resolve(device)
    net = net if net is not None else init_superpoint(torch.Generator().manual_seed(cfg.seed), device)
    bank_dev = bank_tensors(bank, device)
    n_pairs = bank_dev["pairs"].shape[0]
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    draws = iter(draws) if draws is not None else None

    def sample():
        d = next(draws) if draws is not None else dense_draws(cfg, n_pairs, (cfg.batch,), gen, device)
        return make_dense_batch(cfg, bank_dev, d)

    return run_training(net, cfg, sample, dense_loss_terms, callback, device, mark)
