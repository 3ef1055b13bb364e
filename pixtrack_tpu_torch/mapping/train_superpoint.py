"""Train SuperPoint on synthetic geometry: the MagicPoint recipe with its
texture label bank, and the two repeatability gates.

Port of ``pixtrack_tpu/mapping/train_superpoint.py``:

- **Scenes** (``random_scene``): convex quadrilaterals (a rotated, sheared
  unit square in each slot of a ``grid x grid`` layout, so every corner is
  exact ground truth) and ellipses (no corners), rasterised by exact
  half-plane and implicit-equation tests at the pixel centres, blurred,
  with noise. A second view under a random 4-point homography
  (``random_homography``: the 8 x 8 DLT solve; ``warp_image``: bilinear,
  0.5 outside) gives the descriptor's positives.
- **Targets and losses**: ``cell_labels`` (one 65-way class per 8 x 8
  cell, 64 the dustbin), ``detector_loss`` (cross-entropy over the cells),
  ``descriptor_loss`` (SuperPoint's dense hinge over cell centres that
  correspond within 8 px).
- **The texture label bank** (``build_texture_label_bank``): textured cube
  renders labelled by the production Harris detector voted over random
  homographies (homographic adaptation); ``make_bank_batch`` crops,
  jitters and warps it.
- ``train_superpoint``: the global-norm clip (1.0) then Adam at a constant
  rate, as ``optax.chain(clip_by_global_norm(1.0), adam(lr))``
  (``nerf/optim.py``).
- The gates: ``repeatability`` (held-out synthetic scenes under
  homographies) and ``mesh_repeatability`` (textured cube renders under
  17 degrees of viewpoint change, correspondences through the depth
  buffer), for a ``SuperPointNet`` or the Harris detector.

Draws are canonical and kept apart from the arithmetic: uniforms in [0, 1)
and standard normals from a ``torch.Generator`` (``scene_draws``,
``homography_draws``, ``pair_draws``, ``bank_draws``), mapped to their
ranges as ``jax.random.uniform`` maps its own (``_draws.py``), so
the tests can feed the port the JAX package's draws. The JAX scene draws
the ellipses' axes (n, 2) and their angles (n,) from one key; under the
partitionable threefry the angles' uniforms are the first n of the axes'
flattened uniforms, and ``random_scene`` keeps that. Every function is
batched over leading axes: the scenes of a batch are one set of tensor
operations.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve, true_f32
from pixtrack_tpu_torch._draws import _rand, _randn, _uniform


@dataclasses.dataclass(frozen=True)
class SPTrainConfig:
    n_steps: int = 3000
    batch: int = 8
    size: int = 120             # multiple of 8; 15x15 cells
    grid: int = 3               # grid x grid shape slots per scene
    p_drop_max: float = 0.0     # per-scene keep fraction ~ U(1-p_drop_max, 1)
    p_ellipse: float = 0.3      # fraction of slots drawn as ellipses
    max_warp: float = 0.15      # homography corner displacement (x size)
    noise: float = 0.06
    lr: float = 1e-3
    lambda_desc: float = 1.0    # hinge loss is already mean-normalized
    margin_pos: float = 1.0
    margin_neg: float = 0.2
    # how many texture-bank crops join each batch beside the `batch`
    # synthetic scenes (0: synthetic scenes only)
    bank_batch: int = 8
    log_every: int = 50
    seed: int = 0


# ------------------------------------------------------------------ draws ---
def scene_draws(cfg: SPTrainConfig, lead: tuple = (), generator=None, device=None) -> dict:
    """The draws of one ``random_scene`` per index of ``lead``: the quads'
    sizes, shears and rotations, the slot types, the ellipses' axes (their
    angles are the first n of these uniforms), the keep fraction and the
    keep draws, the background, the shapes' contrast signs and magnitudes,
    the noise amplitude, and the noise field's normals."""
    n = cfg.grid * cfg.grid
    u = lambda *s: _rand(generator, device, *lead, *s)  # noqa: E731
    return {"wh": u(n, 2), "shear": u(n), "rot": u(n), "type": u(n), "ell": u(n, 2), "keep_frac": u(),
            "keep": u(n), "bg": u(), "sign": u(n), "mag": u(n), "amp": u(),
            "noise": _randn(generator, device, *lead, cfg.size, cfg.size)}


def homography_draws(lead: tuple = (), generator=None, device=None) -> torch.Tensor:
    """The uniforms of ``random_homography``: its 4 corners' displacements."""
    return _rand(generator, device, *lead, 4, 2)


def pair_draws(cfg: SPTrainConfig, lead: tuple = (), generator=None, device=None) -> dict:
    """A synthetic pair's draws: its scene's and its homography's (the JAX
    package splits a pair's key into these two)."""
    return {"scene": scene_draws(cfg, lead, generator, device),
            "homography": homography_draws(lead, generator, device)}


def bank_draws(cfg: SPTrainConfig, n_images: int, res: int, lead: tuple = (), generator=None,
               device=None) -> dict:
    """``make_bank_batch``'s draws: the bank image, the crop's (x0, y0), the
    gain and bias, the noise field's normals and the homography."""
    ri = lambda hi, *s: torch.randint(0, hi, (*lead, *s), generator=generator, device=device)  # noqa: E731
    return {"index": ri(n_images), "offset": ri(res - cfg.size + 1, 2),
            "gain": _rand(generator, device, *lead), "bias": _rand(generator, device, *lead),
            "noise": _randn(generator, device, *lead, cfg.size, cfg.size),
            "homography": homography_draws(lead, generator, device)}


def seeded(seed: int, fn: Callable):
    """``fn(generator)`` with a fresh CPU generator seeded ``seed``: the
    port's stand-in for the JAX package's ``PRNGKey(seed)`` at a site that
    seeds each draw from an integer."""
    return fn(torch.Generator().manual_seed(int(seed)))


# --------------------------------------------------------------- geometry ---
def _grid_xy(S: int, dtype, device) -> torch.Tensor:
    """(S, S, 2) pixel centres (x, y)."""
    yy, xx = torch.meshgrid(torch.arange(S, dtype=dtype, device=device),
                            torch.arange(S, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def random_scene(d: dict, cfg: SPTrainConfig):
    """Scenes from their draws (``scene_draws``): img (..., S, S), corners
    (..., 4 n, 2) xy, corner_valid (..., 4 n).

    Shapes live in disjoint grid cells, each a convex quad (4 corners, CCW)
    or an ellipse (0 corners); intensities, contrast and noise are drawn; a
    light blur band-limits the edges."""
    from pixtrack_tpu_torch.features.handcrafted import gaussian_blur

    S, C = cfg.size, cfg.grid
    cell = S / C
    n = C * C
    wh = _uniform(d["wh"], 0.40 * cell, 0.62 * cell)
    lead = wh.shape[:-2]
    dt, dev = wh.dtype, wh.device
    sh = _uniform(d["shear"], -0.15 * cell, 0.15 * cell)
    phi = _uniform(d["rot"], 0.0, np.pi)
    square = torch.tensor([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]], dtype=dt, device=dev)
    zero = torch.zeros_like(sh)
    shear = torch.stack([torch.stack([wh[..., 0], sh], -1), torch.stack([zero, wh[..., 1]], -1)], -2)
    c_, s_ = torch.cos(phi), torch.sin(phi)
    rot = torch.stack([torch.stack([c_, -s_], -1), torch.stack([s_, c_], -1)], -2)
    M = rot @ shear  # (..., n, 2, 2), det > 0 keeps CCW
    k = torch.arange(n, device=dev)
    centers = torch.stack([((k % C).to(dt) + 0.5) * cell, ((k // C).to(dt) + 0.5) * cell], dim=-1)  # (n, 2)
    verts = centers[:, None, :] + (M @ square.T).transpose(-1, -2)  # (..., n, 4, 2)

    is_ellipse = d["type"] < cfg.p_ellipse
    ell_ab = _uniform(d["ell"], 0.18 * cell, 0.42 * cell)
    ell_th = _uniform(d["ell"].flatten(-2)[..., :n], 0.0, np.pi)  # the reused key's uniforms

    P = _grid_xy(S, dt, dev)
    px, py = P[..., 0], P[..., 1]
    # a quad holds the pixels left of every directed edge
    e = torch.roll(verts, -1, dims=-2) - verts  # (..., n, 4, 2)
    ex, ey = e[..., 0, None, None], e[..., 1, None, None]
    vx, vy = verts[..., 0, None, None], verts[..., 1, None, None]
    cross = ex * (py - vy) - ey * (px - vx)  # (..., n, 4, S, S)
    quad_in = (cross >= 0.0).all(dim=-3)
    # an ellipse: the rotated implicit equation around its slot's centre
    dx = px - centers[:, 0, None, None]
    dy = py - centers[:, 1, None, None]
    ct, st = torch.cos(ell_th)[..., None, None], torch.sin(ell_th)[..., None, None]
    u = ct * dx + st * dy
    w = -st * dx + ct * dy
    ell_in = (u / ell_ab[..., 0, None, None]) ** 2 + (w / ell_ab[..., 1, None, None]) ** 2 <= 1.0
    masks = torch.where(is_ellipse[..., None, None], ell_in, quad_in)  # (..., n, S, S)

    keep_frac = _uniform(d["keep_frac"], 1.0 - cfg.p_drop_max, 1.0)
    keep = d["keep"] < keep_frac[..., None]
    masks = masks & keep[..., None, None]
    is_ellipse = is_ellipse | ~keep  # dropped slots contribute no corners
    bg = _uniform(d["bg"], 0.3, 0.7)
    sign = torch.where(d["sign"] < 0.5, -1.0, 1.0).to(dt)
    mag = _uniform(d["mag"], 0.3, 0.65)
    gray = torch.clamp(bg[..., None] + sign * mag, 0.0, 1.0)
    img = bg[..., None, None] + (masks * (gray - bg[..., None])[..., None, None]).sum(dim=-3)
    img = gaussian_blur(img.reshape(-1, S, S, 1), 0.9).reshape(*lead, S, S)
    noise = cfg.noise * _uniform(d["amp"], 0.5, 1.5)
    img = torch.clamp(img + noise[..., None, None] * d["noise"], 0.0, 1.0)

    corners = verts.reshape(*lead, n * 4, 2)
    corner_valid = (~is_ellipse).repeat_interleave(4, dim=-1)
    return img, corners, corner_valid


def random_homography(u: torch.Tensor, size: int, max_disp: float) -> torch.Tensor:
    """Homographies (..., 3, 3) mapping view-0 pixels to view-1 pixels from
    their corners' draws ``u`` (..., 4, 2) (``homography_draws``): the DLT
    of the image corners and their displaced copies, h33 = 1."""
    dt, dev = u.dtype, u.device
    lead = u.shape[:-2]
    src = torch.tensor([[0.0, 0.0], [size - 1.0, 0.0], [size - 1.0, size - 1.0], [0.0, size - 1.0]],
                       dtype=dt, device=dev).expand(*lead, 4, 2)
    dst = src + _uniform(u, -max_disp * size, max_disp * size)
    x, y = src[..., 0], src[..., 1]
    uu, vv = dst[..., 0], dst[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    r0 = torch.stack([x, y, one, zero, zero, zero, -uu * x, -uu * y], -1)
    r1 = torch.stack([zero, zero, zero, x, y, one, -vv * x, -vv * y], -1)
    A = torch.stack([r0, r1], dim=-2).reshape(*lead, 8, 8)
    b = torch.stack([uu, vv], dim=-1).reshape(*lead, 8)
    h = torch.linalg.solve(A, b)
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(*lead, 3, 3)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pts (..., N, 2) xy -> warped xy under H (..., 3, 3)."""
    q = pts @ H[..., :2, :2].transpose(-1, -2) + H[..., None, :2, 2]
    z = (pts @ H[..., 2, :2, None])[..., 0] + H[..., 2, 2, None]
    return q / z[..., None]


def warp_image(img: torch.Tensor, H: torch.Tensor, fill: float = 0.5) -> torch.Tensor:
    """Warp view-0 images (..., S, S) into view 1 under H (..., 3, 3): each
    target pixel samples the source bilinearly at H^-1 of itself; ``fill``
    where a sample's four neighbours are not all inside."""
    from pixtrack_tpu_torch.align.interpolate import interpolate_features

    S = img.shape[-1]
    lead = img.shape[:-2]
    tgt = _grid_xy(S, H.dtype, H.device).reshape(-1, 2)
    src = apply_homography(torch.linalg.inv(H), tgt.expand(*lead, S * S, 2))
    flat = img.reshape(-1, S, S, 1)
    vals, _, valid = interpolate_features(flat if lead else flat[0], src.reshape(-1, S * S, 2) if lead else src,
                                          compute_grad=False)
    out = torch.where(valid, vals[..., 0], torch.full_like(vals[..., 0], fill))
    return out.reshape(*lead, S, S)


# -------------------------------------------------------- targets + losses ---
def cell_labels(corners: torch.Tensor, valid: torch.Tensor, size: int) -> torch.Tensor:
    """(..., N, 2) xy corners -> (..., S/8, S/8) int64 labels in [0, 64], 64
    the dustbin. Of corners sharing a cell the last one wins (the JAX
    package's scatter on the CPU applies its updates in row order; here the
    winner is chosen by a max over the row index, the same on every
    device). Corners that are not valid or fall off the image are dropped;
    coordinates round half to even."""
    Sc = size // 8
    lead, N = valid.shape[:-1], valid.shape[-1]
    xi = torch.round(corners[..., 0]).long()
    yi = torch.round(corners[..., 1]).long()
    inb = valid & (xi >= 0) & (xi < size) & (yi >= 0) & (yi < size)
    cls = (yi % 8) * 8 + xi % 8
    cell = torch.where(inb, (yi // 8) * Sc + xi // 8, Sc * Sc)  # dropped rows go to a spare slot
    rows = torch.arange(N, device=cell.device).expand(cell.shape)
    last = torch.full((*lead, Sc * Sc + 1), -1, dtype=torch.long, device=cell.device)
    last = last.scatter_reduce(-1, cell, rows, reduce="amax")
    lab = torch.where(last >= 0, torch.gather(cls, -1, last.clamp_min(0)), 64)
    return lab[..., : Sc * Sc].reshape(*lead, Sc, Sc)


def detector_loss(det_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain 65-way cross-entropy, the mean over all cells (..., Hc, Wc)."""
    return F.cross_entropy(det_logits.reshape(-1, det_logits.shape[-1]), labels.reshape(-1))


def _cell_centres(size: int, dtype, device) -> torch.Tensor:
    """(M, 2) xy centres of the 8 x 8 cells, row-major."""
    return _grid_xy(size // 8, dtype, device).reshape(-1, 2) * 8.0 + 3.5


def hinge_loss(desc0: torch.Tensor, desc1: torch.Tensor, s: torch.Tensor, margin_pos: float,
               margin_neg: float) -> torch.Tensor:
    """SuperPoint's balanced dense hinge per pair over the leading axes:
    desc (..., Hc, Wc, D) unit rows, ``s`` (..., M, M) the positives."""
    D = desc0.shape[-1]
    d0 = desc0.reshape(*desc0.shape[:-3], -1, D)
    d1 = desc1.reshape(*desc1.shape[:-3], -1, D)
    with true_f32():
        sim = d0 @ d1.transpose(-1, -2)  # (..., M, M) cosine
    pos = torch.clamp_min(margin_pos - sim, 0.0)
    neg = torch.clamp_min(sim - margin_neg, 0.0)
    # balance: positives are ~1/M of all pairs
    n_pos = s.sum(dim=(-2, -1)).clamp_min(1)
    n_neg = (~s).sum(dim=(-2, -1)).clamp_min(1)
    return (torch.where(s, pos, 0.0).sum(dim=(-2, -1)) / n_pos
            + torch.where(~s, neg, 0.0).sum(dim=(-2, -1)) / n_neg)


def descriptor_loss(desc0: torch.Tensor, desc1: torch.Tensor, H: torch.Tensor, size: int,
                    cfg: SPTrainConfig) -> torch.Tensor:
    """The dense hinge between the two views' 1/8-resolution descriptor
    grids, per pair over the leading axes; positives: cell centres within
    8 px of each other under H."""
    cen = _cell_centres(size, H.dtype, H.device)
    cen_w = apply_homography(H, cen.expand(*H.shape[:-2], *cen.shape))  # (..., M, 2) in view 1
    inb = ((cen_w[..., 0] >= 0) & (cen_w[..., 0] <= size - 1)
           & (cen_w[..., 1] >= 0) & (cen_w[..., 1] <= size - 1))
    d2 = ((cen_w[..., :, None, :] - cen[:, :]) ** 2).sum(-1)
    s = (d2 <= 64.0) & inb[..., None]
    return hinge_loss(desc0, desc1, s, cfg.margin_pos, cfg.margin_neg)


# ----------------------------------------------------------------- batches ---
def make_batch(cfg: SPTrainConfig, d: dict):
    """(img0, img1, labels0, labels1, H) of synthetic pairs from their draws
    (``pair_draws`` over the batch)."""
    img0, corners, cv = random_scene(d["scene"], cfg)
    H = random_homography(d["homography"], cfg.size, cfg.max_warp)
    img1 = warp_image(img0, H)
    lab0 = cell_labels(corners, cv, cfg.size)
    lab1 = cell_labels(apply_homography(H, corners), cv, cfg.size)
    return img0, img1, lab0, lab1, H


def bank_tensors(bank: dict, device) -> dict:
    """A texture label bank's arrays on ``device``: images and keypoints
    f32, valid bool."""
    return {"images": torch.as_tensor(np.asarray(bank["images"]), dtype=torch.float32, device=device),
            "keypoints": torch.as_tensor(np.asarray(bank["keypoints"]), dtype=torch.float32, device=device),
            "valid": torch.as_tensor(np.asarray(bank["valid"]), device=device)}


def bank_corners(cfg: SPTrainConfig, bank: dict, d: dict):
    """The labels' keypoints (..., K, 2) of ``make_bank_batch``'s crops, in
    crop pixels, and their validity: a bank label inside the crop."""
    S = cfg.size
    kp = bank["keypoints"][d["index"]] - d["offset"][..., None, :].to(torch.float32)
    kv = (bank["valid"][d["index"]] & (kp[..., 0] >= 0) & (kp[..., 0] <= S - 1)
          & (kp[..., 1] >= 0) & (kp[..., 1] <= S - 1))
    return kp, kv


def make_bank_batch(cfg: SPTrainConfig, bank: dict, d: dict):
    """Pairs from a texture label bank (``bank_tensors``) and their draws
    (``bank_draws``): a crop to ``cfg.size``, gain, bias and noise, and a
    homography second view; ``make_batch``'s tuple."""
    S = cfg.size
    idx, off = d["index"], d["offset"]  # off (..., 2) = (x0, y0)
    ar = torch.arange(S, device=idx.device)
    rows = (off[..., 1, None] + ar)[..., :, None]
    cols = (off[..., 0, None] + ar)[..., None, :]
    img0 = bank["images"][idx[..., None, None], rows, cols]
    kp, kv = bank_corners(cfg, bank, d)
    gain = _uniform(d["gain"], 0.7, 1.3)[..., None, None]
    bias = _uniform(d["bias"], -0.15, 0.15)[..., None, None]
    img0 = torch.clamp(img0 * gain + bias, 0.0, 1.0)
    img0 = torch.clamp(img0 + cfg.noise * d["noise"], 0.0, 1.0)
    H = random_homography(d["homography"], S, cfg.max_warp)
    img1 = warp_image(img0, H)
    lab0 = cell_labels(kp, kv, S)
    lab1 = cell_labels(apply_homography(H, kp), kv, S)
    return img0, img1, lab0, lab1, H


def _grey_render(img) -> np.ndarray:
    """A uint8 RGB render as f32 greyscale in [0, 1], as the JAX package
    converts it (an f32 product with the luma weights, then / 255)."""
    return (np.asarray(img, np.float32) @ np.asarray([0.299, 0.587, 0.114], np.float32)) / 255.0


def _voted(gray: np.ndarray, H_list, max_keypoints: int, device) -> np.ndarray:
    """Per-pixel detection votes (S, S) of the production Harris detector
    over ``gray`` and its warps under each H of ``H_list`` (None: the image
    itself), every detection mapped back into ``gray``'s frame and rounded
    to its pixel. A warp is cast to uint8 by truncation, as the JAX package
    casts it; numpy's ``+=`` counts a pixel once per warp."""
    from pixtrack_tpu_torch.mapping.detector import detect_keypoints

    S = gray.shape[0]
    gray_t = torch.as_tensor(gray, dtype=torch.float32, device=device)
    votes = np.zeros((S, S), np.float32)
    for H in H_list:
        view = gray if H is None else warp_image(gray_t, H).cpu().numpy()
        kp, _ = detect_keypoints((view * 255).astype(np.uint8), max_keypoints=max_keypoints, device=device)
        if len(kp) == 0:
            continue
        if H is not None:
            kp = apply_homography(torch.linalg.inv(H), kp)
        kp = kp.cpu().numpy()
        xi = np.round(kp[:, 0]).astype(int)
        yi = np.round(kp[:, 1]).astype(int)
        inb = (xi >= 0) & (xi < S) & (yi >= 0) & (yi < S)
        votes[yi[inb], xi[inb]] += 1.0
    return votes


def _homography_at(size: int, max_warp: float, device, homography_at: Optional[Callable]):
    """key -> H (3, 3) on ``device``: the draws of ``homography_at(key)``
    (the JAX package's ``PRNGKey(key)`` uniforms, from the tests) or, by
    default, of a generator seeded ``key``."""
    def H_of(key: int) -> torch.Tensor:
        u = homography_at(key) if homography_at is not None else seeded(key, lambda g: homography_draws((), g))
        return random_homography(torch.as_tensor(u, dtype=torch.float32).to(device), size, max_warp)
    return H_of


def build_texture_label_bank(n_scenes: int = 32, res: int = 160, n_views: int = 6, n_warps: int = 12,
                             max_keypoints: int = 160, vote_frac: float = 0.5, max_warp: float = 0.12,
                             nms_radius: int = 4, seed: int = 0, verbose: bool = False, device=None,
                             homography_at: Optional[Callable[[int], torch.Tensor]] = None):
    """Homographic-adaptation labels on textured cube renders.

    Each view of ``train_matcher._random_cube_mesh`` (the views' draws from
    ``np.random.default_rng(seed)``, the JAX package's) is labelled by the
    production Harris detector on ``device`` (None is the CUDA card) voted
    over the view and ``n_warps`` random homographies; a pixel becomes a
    label where ≥ ``vote_frac`` of the votes land within 2 px of it (a 5 x 5
    box sum, then an NMS of radius ``nms_radius``). Warp w of view v of
    scene sc draws its homography from the integer seed*7919 + sc*101 + v*13
    + w, through ``homography_at`` (key -> (4, 2) uniforms) or a generator
    seeded with it. Returns dict: images (N, res, res) f32 in [0, 1],
    keypoints (N, K, 2) f32 xy, valid (N, K) bool."""
    import scipy.ndimage as ndi

    from pixtrack_tpu_torch.features.train_basin import _look_at_w2c
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.mapping.mesh_render import render_mesh
    from pixtrack_tpu_torch.mapping.train_matcher import _random_cube_mesh

    device = resolve(device)
    H_of = _homography_at(res, max_warp, device, homography_at)
    camera = Camera.pinhole(res * 1.1, res * 1.1, (res - 1) / 2, (res - 1) / 2, res, res, device="cpu")
    rng = np.random.default_rng(seed)
    images, kps, valids = [], [], []
    n_votes = n_warps + 1  # the unwarped image votes too
    with tempfile.TemporaryDirectory() as td:
        for sc in range(n_scenes):
            mesh = _random_cube_mesh(Path(td), seed * 1000 + sc)
            for v in range(n_views):
                ang = 2 * np.pi * v / n_views + rng.uniform(-0.05, 0.05)
                el = rng.uniform(0.15, 0.55)
                center = 0.9 * np.array([np.sin(ang) * np.cos(el), np.sin(el), np.cos(ang) * np.cos(el)])
                T = _look_at_w2c(torch.as_tensor(center, dtype=torch.float32),
                                 torch.tensor(rng.uniform(-0.3, 0.3), dtype=torch.float32))
                gray = _grey_render(render_mesh(mesh, T, camera))
                Hs = [None] + [H_of(seed * 7919 + sc * 101 + v * 13 + w) for w in range(1, n_votes)]
                votes = _voted(gray, Hs, max_keypoints * 2, device)
                acc = ndi.uniform_filter(votes, size=5) * 25.0
                local_max = acc == ndi.maximum_filter(acc, size=2 * nms_radius + 1)
                stable = local_max & (acc >= vote_frac * n_votes)
                ys, xs = np.nonzero(stable)
                order = np.argsort(-acc[ys, xs])[:max_keypoints]
                k = np.stack([xs[order], ys[order]], axis=-1).astype(np.float32)
                pad = np.zeros((max_keypoints, 2), np.float32)
                val = np.zeros(max_keypoints, bool)
                pad[: len(k)] = k
                val[: len(k)] = True
                images.append(gray)
                kps.append(pad)
                valids.append(val)
            if verbose:
                print(f"bank scene {sc + 1}/{n_scenes}: {int(valids[-1].sum())} stable labels in last view",
                      flush=True)
    return {"images": np.stack(images), "keypoints": np.stack(kps), "valid": np.stack(valids)}


# ---------------------------------------------------------------- training ---
def step_draws(cfg: SPTrainConfig, bank: Optional[dict], generator=None, device=None) -> dict:
    """One training step's draws: the synthetic batch's and, with a bank
    (``bank_tensors``), the bank batch's."""
    d = {"batch": pair_draws(cfg, (cfg.batch,), generator, device)}
    if bank is not None:
        N, R = bank["images"].shape[:2]
        d["bank"] = bank_draws(cfg, N, R, (cfg.bank_batch,), generator, device)
    return d


def training_batch(cfg: SPTrainConfig, bank: Optional[dict], d: dict):
    """A step's (img0, img1, labels0, labels1, H): the synthetic pairs,
    then the bank pairs."""
    batch = make_batch(cfg, d["batch"])
    if bank is not None:
        bb = make_bank_batch(cfg, bank, d["bank"])
        batch = tuple(torch.cat([a, b], dim=0) for a, b in zip(batch, bb))
    return batch


def forward_views(net, batch) -> tuple:
    """(det0, desc0, det1, desc1): a batch's two views through the net, in
    true f32."""
    with true_f32():
        return (*net(batch[0][..., None]), *net(batch[1][..., None]))


def loss_terms(cfg: SPTrainConfig, batch, det0, desc0, det1, desc1) -> tuple:
    """(detector term, descriptor term) of a batch from its two views'
    outputs (``forward_views``): the views' mean cross-entropies summed, and
    the mean hinge over the pairs."""
    _, _, lab0, lab1, H = batch
    l_det = detector_loss(det0, lab0) + detector_loss(det1, lab1)
    return l_det, descriptor_loss(desc0, desc1, H, cfg.size, cfg).mean()


def _no_mark(label: str):
    pass


def _step(net, opt, params, cfg, batch, terms, mark=_no_mark):
    """One step on ``batch``: the two views' forwards, the loss (``terms``:
    detector + ``cfg.lambda_desc`` x descriptor), its backward, the
    global-norm clip (1.0), Adam; ``mark(label)`` after each part."""
    from pixtrack_tpu_torch.nerf.optim import clip_by_global_norm

    with true_f32():
        out0 = net(batch[0][..., None])
        mark("forward, view 0")
        out1 = net(batch[1][..., None])
        mark("forward, view 1")
        l_det, l_desc = terms(cfg, batch, *out0, *out1)
        loss = l_det + cfg.lambda_desc * l_desc
        mark("losses")
        loss.backward()
        mark("backward")
    clip_by_global_norm(params, 1.0)
    opt.step()
    mark("clip + Adam")
    return loss.detach()


def run_training(net, cfg, sample, terms, callback, device, mark=None):
    """The trainers' loop: ``sample()`` a batch, one ``_step``; the loss at
    step i (from 1) logged at i = 1, every ``cfg.log_every`` and the last
    step; ``callback(step, loss, net)`` at each. ``mark(label)``, when
    given, is called as each step starts ("start"), after its batch
    ("batch") and after each part of ``_step``: the hook of a timing split.
    Returns (net, info)."""
    from pixtrack_tpu_torch.nerf.optim import Adam

    mark = mark or _no_mark
    net.train()
    params = list(net.parameters())
    opt = Adam(params, lambda k: cfg.lr)
    history = []
    t0 = time.time()
    for i in range(cfg.n_steps):
        mark("start")
        with torch.no_grad():
            batch = sample()
        mark("batch")
        loss = _step(net, opt, params, cfg, batch, terms, mark)
        if (i + 1) % cfg.log_every == 0 or i == 0 or i + 1 == cfg.n_steps:
            lv = float(loss)
            history.append((i + 1, lv))
            if callback:
                callback(i + 1, lv, net)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return net.eval(), {"history": history, "seconds": time.time() - t0}


def train_superpoint(cfg: SPTrainConfig = SPTrainConfig(), net=None, callback=None, bank: Optional[dict] = None,
                     device=None, draws: Optional[Iterable[dict]] = None, mark: Optional[Callable] = None):
    """Train ``net`` (else ``init_superpoint`` from ``cfg.seed``) in place on
    ``device`` (None is the CUDA card): each step ``cfg.batch`` synthetic
    pairs plus, with a texture label ``bank``, ``cfg.bank_batch`` bank
    pairs, against the detector loss plus ``cfg.lambda_desc`` times the
    descriptor loss. Each step's draws: ``step_draws`` from a generator on
    ``device`` seeded ``cfg.seed + 1``, or the next of ``draws``; ``mark``
    as in ``run_training``. Returns (net, info) with ``history`` [(step,
    loss)] and ``seconds``."""
    from pixtrack_tpu_torch.mapping.superpoint import init_superpoint

    device = resolve(device)
    net = net if net is not None else init_superpoint(torch.Generator().manual_seed(cfg.seed), device)
    bank_dev = bank_tensors(bank, device) if bank is not None and cfg.bank_batch > 0 else None
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    draws = iter(draws) if draws is not None else None

    def sample():
        d = next(draws) if draws is not None else step_draws(cfg, bank_dev, gen, device)
        return training_batch(cfg, bank_dev, d)

    return run_training(net, cfg, sample, loss_terms, callback, device, mark)


# ------------------------------------------------------------- evaluation ---
def _detect(net, detector: str, image: np.ndarray, max_keypoints: int, device) -> np.ndarray:
    """Keypoints (N, 2) numpy of SuperPoint (``net``) or the production
    Harris detector on ``device``."""
    from pixtrack_tpu_torch.mapping.detector import detect_keypoints
    from pixtrack_tpu_torch.mapping.superpoint import extract_superpoint

    if detector == "superpoint":
        return extract_superpoint(net, image, max_keypoints)[0]
    return detect_keypoints(image, max_keypoints=max_keypoints, device=device)[0].cpu().numpy()


def repeatability(net, n_pairs: int = 6, size: int = 120, max_warp: float = 0.12, max_keypoints: int = 256,
                  tol_px: float = 3.0, seed: int = 77, detector: str = "superpoint", grid: int = 5,
                  draws: Optional[dict] = None, device=None):
    """Detector repeatability under homography on held-out synthetic
    scenes: the fraction of view-0 keypoints whose warp lands within
    ``tol_px`` of a view-1 keypoint, per pair, and its mean. ``detector``:
    'superpoint' (``net``, on its device) or 'harris' (``net`` None, on
    ``device``, None the CUDA card). The scenes (``grid=5``: denser than
    the training scenes) come from ``draws`` (``pair_draws`` over
    (n_pairs,)) or, by default, pair s from a generator seeded ``seed + s``.
    Returns (mean, counts): counts are the view-0 keypoints whose warp lies
    inside view 1."""
    device = next(net.parameters()).device if net is not None else resolve(device)
    cfg = SPTrainConfig(size=size, max_warp=max_warp, grid=grid)
    if draws is None:
        per = [seeded(seed + s, lambda g: pair_draws(cfg, (), g)) for s in range(n_pairs)]
        draws = {"scene": {k: torch.stack([p["scene"][k] for p in per]) for k in per[0]["scene"]},
                 "homography": torch.stack([p["homography"] for p in per])}
    draws = {"scene": {k: torch.as_tensor(v).to(device) for k, v in draws["scene"].items()},
             "homography": torch.as_tensor(draws["homography"]).to(device)}
    img0, _, _ = random_scene(draws["scene"], cfg)
    H = random_homography(draws["homography"], size, max_warp)
    img1 = warp_image(img0, H)
    rep, counts = [], []
    for s in range(img0.shape[0]):
        a0 = (img0[s].cpu().numpy() * 255).astype(np.uint8)
        a1 = (img1[s].cpu().numpy() * 255).astype(np.uint8)
        kp0 = _detect(net, detector, a0, max_keypoints, device)
        kp1 = _detect(net, detector, a1, max_keypoints, device)
        if len(kp0) == 0 or len(kp1) == 0:
            rep.append(0.0)
            counts.append(0)
            continue
        w0 = apply_homography(H[s].cpu(), torch.as_tensor(kp0)).numpy()
        inb = (w0[:, 0] >= 0) & (w0[:, 0] <= size - 1) & (w0[:, 1] >= 0) & (w0[:, 1] <= size - 1)
        if inb.sum() == 0:
            rep.append(0.0)
            counts.append(0)
            continue
        d = np.linalg.norm(w0[inb][:, None, :] - kp1[None, :, :], axis=-1)
        rep.append(float((d.min(axis=1) <= tol_px).mean()))
        counts.append(int(inb.sum()))
    return float(np.mean(rep)), counts


def mesh_repeatability(net, n_scenes: int = 4, res: int = 192, max_keypoints: int = 512, tol_px: float = 3.0,
                       seed: int = 500, baseline_deg: float = 17.0, detector: str = "superpoint", device=None):
    """Detector repeatability and density on textured cube renders under
    real viewpoint change (``baseline_deg``), correspondences through the
    view-0 depth buffer and occlusion-checked in view 1; the views' draws
    from ``np.random.default_rng(seed)``. ``detector`` as in
    ``repeatability``. Returns (mean repeatability over the co-visible
    view-0 keypoints, the per-pair view-0 keypoint counts)."""
    from pixtrack_tpu_torch.features.train_basin import _look_at_w2c
    from pixtrack_tpu_torch.geometry import Camera
    from pixtrack_tpu_torch.mapping.mesh_render import render_mesh
    from pixtrack_tpu_torch.mapping.train_matcher import _random_cube_mesh

    device = next(net.parameters()).device if net is not None else resolve(device)
    camera = Camera.pinhole(res * 1.1, res * 1.1, (res - 1) / 2, (res - 1) / 2, res, res, device="cpu")
    fx = fy = res * 1.1
    cx = cy = (res - 1) / 2
    rng = np.random.default_rng(seed)
    rep, counts = [], []
    with tempfile.TemporaryDirectory() as td:
        for sc in range(n_scenes):
            mesh = _random_cube_mesh(Path(td), seed + sc)
            views = []
            for i in range(2):
                ang = np.deg2rad(baseline_deg) * i + rng.uniform(-0.03, 0.03)
                el = 0.35 + 0.1 * i
                center = 0.9 * np.array([np.sin(ang) * np.cos(el), np.sin(el), np.cos(ang) * np.cos(el)])
                T = _look_at_w2c(torch.as_tensor(center, dtype=torch.float32), torch.tensor(0.0))
                img, depth = render_mesh(mesh, T, camera, return_depth=True)
                views.append((T, _detect(net, detector, img, max_keypoints, device), np.asarray(depth)))
            (T0, kp0, dep0), (T1, kp1, dep1) = views
            counts.append(len(kp0))
            if len(kp0) == 0 or len(kp1) == 0:
                rep.append(0.0)
                continue
            # backproject view-0 keypoints through the depth buffer
            xi = np.clip(np.round(kp0[:, 0]).astype(int), 0, res - 1)
            yi = np.clip(np.round(kp0[:, 1]).astype(int), 0, res - 1)
            z = dep0[yi, xi]
            has_depth = z > 0
            Xc = np.stack([(kp0[:, 0] - cx) / fx * z, (kp0[:, 1] - cy) / fy * z, z], -1)
            R0, t0 = T0.R.numpy(), T0.t.numpy()
            Xw = (Xc - t0) @ R0
            uv, vis = camera.world2image(T1, torch.as_tensor(Xw, dtype=torch.float32))
            uv, vis = uv.numpy(), vis.numpy() & has_depth
            # occlusion check against view 1's depth buffer
            R1, t1 = T1.R.numpy(), T1.t.numpy()
            zc1 = (Xw @ R1.T + t1)[:, 2]
            xj = np.clip(np.round(uv[:, 0]).astype(int), 0, res - 1)
            yj = np.clip(np.round(uv[:, 1]).astype(int), 0, res - 1)
            zb1 = dep1[yj, xj]
            vis &= (zb1 > 0) & (np.abs(zb1 - zc1) < 0.03 * np.abs(zc1))
            if vis.sum() == 0:
                rep.append(0.0)
                continue
            d = np.linalg.norm(uv[vis][:, None, :] - kp1[None, :, :], axis=-1)
            rep.append(float((d.min(axis=1) <= tol_px).mean()))
    return float(np.mean(rep)), counts
