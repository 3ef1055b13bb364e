"""Volume rendering of any field with ``field_T``.

Port of ``pixtrack_tpu/nerf/render.py``. Spaces: the field lives in grid
space [0, 1]^3; rays are built from NeRF-space OpenGL cameras; ``t`` and
depth stay in NeRF units.

``render_rays`` takes one of two paths:
- a ``DistilledField`` with ``cfg.fused``, coarse only (``n_fine == 0``),
  not jittered: K1, ``fused_march_render``, the whole ray in one launch;
- otherwise the staged render (JAX render.py:272-338). Its field
  evaluations go through K2, ``fused_distilled_eval``, for a
  ``DistilledField`` with ``cfg.fused``, and through ``field.field_T`` for
  any other field (``NGPField``, ``BakedField``, analytic teachers) or with
  ``fused=False``. Each kernel runs on a CUDA tensor and its plain version on
  a CPU tensor; neither has a backward, so training renders with
  ``fused=False``: the staged render is differentiable end to end (the
  importance samples carry gradient through the coarse weights, and the
  co-sort's permutation carries it to the sorted values, as in JAX).
Jitter is drawn on the rays' device from a ``torch.Generator`` the caller
seeds (the counterpart of the JAX ``key``): with a generator the importance
pass draws its ``u`` at random, and with ``cfg.perturb`` as well the coarse
samples are jittered inside their strata. ``jax.random``'s bits cannot be
reproduced, so the samplers also take the noise itself (``noise``, ``u``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch.geometry import nerf_transform
from pixtrack_tpu_torch.nerf.distill import DistilledField
from pixtrack_tpu_torch.nerf.fused_mlp import fused_distilled_eval, fused_march_render

_NGP_PERM = [int(i) for i in nerf_transform._NGP_PERM]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_coarse: int = 64
    n_fine: int = 64
    min_transmittance: float = 1e-7
    perturb: bool = False
    chunk: int = 16384  # rays per pass of the staged render
    density_scale: float = 1.0
    fused: bool = True  # a DistilledField renders through K1 / K2


def rays_from_camera(
    c2w_nerf: torch.Tensor, fx: float, fy: float, cx: float, cy: float,
    width: int, height: int, x0=0.0, y0=0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel rays (H*W, 3) in NeRF space from an OpenGL c2w matrix.

    Intrinsics are index-centred; ``(x0, y0)`` (floats or scalar tensors)
    offset the pixel grid to the window ``[x0, x0+width) x [y0, y0+height)``.
    """
    dev = c2w_nerf.device
    ys = torch.arange(height, dtype=torch.float32, device=dev) + y0
    xs = torch.arange(width, dtype=torch.float32, device=dev) + x0
    ys, xs = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack([(xs - cx) / fx, -(ys - cy) / fy, -torch.ones_like(xs)], -1).reshape(-1, 3)
    dirs = d_cam @ c2w_nerf[:3, :3].T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return c2w_nerf[:3, 3].expand(dirs.shape), dirs


def _to_grid(origins_nerf, dirs_nerf):
    """NeRF-space rays -> grid-space rays; t stays in NeRF units."""
    return origins_nerf[..., _NGP_PERM] / 3.0 + 0.5, dirs_nerf[..., _NGP_PERM] / 3.0


def ray_aabb_intersect(o, d, aabb_min, aabb_max, eps: float = 1e-9):
    """Slab test. Returns (t_near, t_far, hit)."""
    d_safe = torch.where(d.abs() < eps, torch.where(d >= 0, eps, -eps), d)
    inv = 1.0 / d_safe
    t0 = (aabb_min - o) * inv
    t1 = (aabb_max - o) * inv
    t_near = torch.minimum(t0, t1).amax(-1).clamp_min(0.0)
    t_far = torch.maximum(t0, t1).amin(-1)
    return t_near, t_far, t_far > t_near


def ray_sphere_intersect(o, d, sphere, eps: float = 1e-9):
    """Ray against the ball sphere = (cx, cy, cz, r). Returns (t0, t1, hit)."""
    oc = o - sphere[:3]
    a = (d * d).sum(-1).clamp_min(eps)
    b = 2.0 * (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - sphere[3] * sphere[3]
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    t0 = ((-b - sq) / (2.0 * a)).clamp_min(0.0)
    t1 = (-b + sq) / (2.0 * a)
    return t0, t1, (disc > 0.0) & (t1 > t0)


def _sample_stratified(t_near, t_far, n: int):
    """(R,) bounds -> (R, n) midpoint samples (the deterministic strata), K1's form.

    Computed as ``t_near + (i + 0.5) * dt`` with ``dt = (t_far - t_near) / n``,
    the TPU kernel's and K1's own rounding (the JAX staged path's linspace
    form differs in the last bit), so that the plain version of K1 samples
    exactly where the kernel does. ``n`` divides as a tensor: on CUDA,
    PyTorch divides by a Python number by multiplying with its reciprocal,
    which rounds ``dt`` differently from the kernel's division."""
    dt = (t_far - t_near).clamp_min(0.0) / torch.full_like(t_near, float(n))
    i = torch.arange(n, dtype=torch.float32, device=t_near.device) + 0.5
    return t_near[:, None] + i[None, :] * dt[:, None]


def _sample_grid(t_near, t_far, n: int, noise: Optional[torch.Tensor] = None):
    """(R,) bounds -> (R, n) strata in the staged render's form (the JAX
    ``_sample_stratified``): ``t_near + (t_far - t_near) * u`` with ``u`` the
    bin lefts of ``linspace(0, 1, n + 1)`` plus ``0.5 / n``, or plus
    ``noise / n`` for uniform ``noise`` (R, n) in [0, 1). (torch's and JAX's
    linspace differ in the last bit of some values.)"""
    u = torch.linspace(0.0, 1.0, n + 1, device=t_near.device)[:-1]
    u = u + 0.5 / n if noise is None else u + noise / n
    return t_near[:, None] + (t_far - t_near)[:, None] * u


def _sample_importance(t_mid, weights, t_near, t_far, n: int, u: Optional[torch.Tensor] = None):
    """Inverse-CDF resampling from coarse weights. t_mid, weights (R, S) ->
    (R, n) sample ts, at ``u = linspace(0.01, 0.99, n)`` or at the uniform
    ``u`` (R, n) given."""
    w = weights + 1e-5
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / cdf[:, -1:]
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (R, S+1)
    R, S = weights.shape
    if u is None:
        u = torch.linspace(0.01, 0.99, n, device=weights.device).expand(R, n)
    u = u.contiguous()
    # right=True counts the cdf entries <= u, as JAX's dense comparison does
    idx = torch.searchsorted(cdf, u, right=True).clamp(1, S)
    below = idx - 1
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, idx)
    edges = torch.cat([t_near[:, None], t_mid, t_far[:, None]], dim=1)  # (R, S+2)
    t_b = torch.gather(edges, 1, below)
    t_a = torch.gather(edges, 1, idx)
    frac = (u - cdf_b) / (cdf_a - cdf_b).clamp_min(1e-8)
    return t_b + frac * (t_a - t_b)


def _composite(sigma, rgbT, ts, t_far, hit, min_transmittance, density_scale):
    """Front-to-back compositing. sigma (R, S), rgbT (3, R, S), ts (R, S).
    Returns (rgb (R, 3), alpha (R,), depth (R,)), background not applied."""
    deltas = torch.diff(ts, dim=-1)
    last = (t_far[:, None] - ts[:, -1:]).clamp_min(0.0)
    deltas = torch.cat([deltas, last], dim=-1)
    alpha_i = 1.0 - torch.exp(-sigma * density_scale * deltas)
    trans = torch.cumprod(1.0 - alpha_i + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    w = alpha_i * trans
    w = torch.where(trans > min_transmittance, w, 0.0)
    w = torch.where(hit[:, None], w, 0.0)
    acc = w.sum(-1)
    rgb = torch.einsum("rs,crs->rc", w, rgbT)
    depth = (w * ts).sum(-1) / acc.clamp_min(1e-8)
    return rgb, acc, torch.where(acc > 1e-4, depth, 0.0)


def occupied_bounds(
    field, aabb, res: int = 96, sigma_threshold: float = 0.01,
    margin_cells: float = 1.5, chunk: int = 1 << 18,
):
    """Grid-space bounds of the occupied region inside ``aabb`` of any field
    with ``density_T`` and ``device``: (aabb_tight (2, 3), sphere (4,)) as
    numpy (a one-time res^3 sweep)."""
    aabb = np.asarray(aabb, np.float32)
    centers = (np.arange(res, dtype=np.float32) + 0.5) / res
    zz, yy, xx = np.meshgrid(centers, centers, centers, indexing="ij")
    pts01 = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=0)
    pts = aabb[0][:, None] + pts01 * (aabb[1] - aabb[0])[:, None]
    sig = np.empty(pts.shape[1], np.float32)
    with torch.no_grad():
        for s in range(0, pts.shape[1], chunk):
            blk = torch.as_tensor(pts[:, s : s + chunk], device=field.device)
            sig[s : s + chunk] = field.density_T(blk)[0].cpu().numpy()
    occ = sig > sigma_threshold
    if not occ.any():
        ctr = 0.5 * (aabb[0] + aabb[1])
        rad = 0.5 * float(np.linalg.norm(aabb[1] - aabb[0]))
        return aabb, np.asarray([*ctr, rad], np.float32)
    pocc = pts[:, occ]
    cell = (aabb[1] - aabb[0]) / res
    margin = margin_cells * cell
    lo = np.maximum(pocc.min(axis=1) - margin, aabb[0])
    hi = np.minimum(pocc.max(axis=1) + margin, aabb[1])
    ctr = 0.5 * (lo + hi)
    rad = float(np.sqrt(((pocc - ctr[:, None]) ** 2).sum(axis=0).max()))
    rad += margin_cells * float(np.linalg.norm(cell))
    return np.stack([lo, hi]).astype(np.float32), np.asarray([*ctr, rad], np.float32)


def march_rays(origins_nerf, dirs_nerf, aabb, sphere: Optional[torch.Tensor] = None):
    """NeRF-space rays -> K1's inputs: grid-space (o, d) and (t_near, t_far)
    clipped to the crop box and the occupied ball, a miss encoded as
    t_far == t_near."""
    o_g, d_g = _to_grid(origins_nerf, dirs_nerf)
    t_near, t_far, hit = ray_aabb_intersect(o_g, d_g, aabb[0], aabb[1])
    if sphere is not None:
        s0, s1, s_hit = ray_sphere_intersect(o_g, d_g, sphere)
        t_near = torch.maximum(t_near, s0)
        t_far = torch.minimum(t_far, s1)
        hit = hit & s_hit & (t_far > t_near)
    t_far = torch.maximum(t_far, t_near + 1e-4)
    return o_g, d_g, t_near, torch.where(hit, t_far, t_near)


def _draw_noise(n_rays: int, cfg: RenderConfig, generator: Optional[torch.Generator], device):
    """The staged render's noise for one chunk of rays, drawn on the device:
    (coarse jitter (R, n_coarse) or None, importance u (R, n_fine) or None)."""
    if generator is None:
        return None, None
    noise = torch.rand(n_rays, cfg.n_coarse, generator=generator, device=device) if cfg.perturb else None
    u = torch.rand(n_rays, cfg.n_fine, generator=generator, device=device) if cfg.n_fine > 0 else None
    return noise, u


def _uses_kernels(field, cfg: RenderConfig) -> bool:
    return cfg.fused and isinstance(field, DistilledField)


def _render_staged(field, o_g, d_g, t_near, t_far, cfg: RenderConfig, noise=(None, None)):
    """The staged render of grid-space rays (a miss has t_far == t_near):
    stratified coarse samples, their weights, importance samples, the field
    evaluations (through K2 where ``_uses_kernels``, else ``field.field_T``),
    the stable co-sort and compositing. ``noise`` is ``_draw_noise``'s pair;
    (None, None) is the deterministic render."""
    hit = t_far > t_near
    ts = _sample_grid(t_near, t_far, cfg.n_coarse, noise[0])
    oT, dT = o_g.T, d_g.T
    dnT = dT / torch.linalg.norm(dT, dim=0, keepdim=True).clamp_min(1e-9)
    kernels = _uses_kernels(field, cfg)

    def eval_field(ts_):
        R, S = ts_.shape
        x = (oT[:, :, None] + ts_[None] * dT[:, :, None]).clamp(0.0, 1.0).reshape(3, R * S)
        d_rep = dnT[:, :, None].expand(3, R, S).reshape(3, R * S)
        sigma, rgbT = fused_distilled_eval(field, x, d_rep) if kernels else field.field_T(x, d_rep)
        return sigma.reshape(R, S), rgbT.reshape(3, R, S)

    sigma_c, rgb_c = eval_field(ts)
    if cfg.n_fine == 0:
        return _composite(sigma_c, rgb_c, ts, t_far, hit, cfg.min_transmittance, cfg.density_scale)
    # coarse weights; the last delta repeats the one before it
    deltas = torch.diff(ts, dim=-1)
    deltas = torch.cat([deltas, deltas[:, -1:]], dim=-1)
    alpha_c = 1.0 - torch.exp(-sigma_c * cfg.density_scale * deltas)
    trans_c = torch.cumprod(1.0 - alpha_c + 1e-10, dim=-1)
    trans_c = torch.cat([torch.ones_like(trans_c[:, :1]), trans_c[:, :-1]], dim=-1)
    ts_f = _sample_importance(ts, alpha_c * trans_c, t_near, t_far, cfg.n_fine, noise[1])
    # the field is deterministic: the coarse samples' values are reused
    sigma_f, rgb_f = eval_field(ts_f)
    # a stable sort, as jax.lax.sort: a coarse sample stays before a fine tie
    ts_all, order = torch.sort(torch.cat([ts, ts_f], dim=-1), dim=-1, stable=True)
    sigma = torch.gather(torch.cat([sigma_c, sigma_f], dim=-1), 1, order)
    rgb = torch.gather(torch.cat([rgb_c, rgb_f], dim=-1), 2, order.expand(3, *order.shape))
    return _composite(sigma, rgb, ts_all, t_far, hit, cfg.min_transmittance, cfg.density_scale)


def render_rays(
    field, origins_nerf, dirs_nerf, aabb, cfg: RenderConfig,
    sphere: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
    noise: Optional[tuple] = None,
):
    """Render NeRF-space rays of any field with ``field_T``: a
    ``DistilledField`` with ``cfg.fused`` through K1 when ``cfg.n_fine ==
    0`` and the samples are not jittered (``cfg.perturb`` with a
    ``generator`` or ``noise``); everything else through the staged render,
    ``cfg.chunk`` rays at a time, each chunk drawing its noise from
    ``generator`` in turn. ``noise``, ``_draw_noise``'s pair for all the
    rays, is used instead of drawing. Returns dict(rgb, alpha, depth)."""
    o_g, d_g, t_near, t_far = march_rays(origins_nerf, dirs_nerf, aabb, sphere)
    jittered = cfg.perturb and (generator is not None or noise is not None)
    if _uses_kernels(field, cfg) and cfg.n_fine == 0 and not jittered:
        return fused_march_render(field, o_g, d_g, t_near, t_far, cfg.n_coarse,
                                  cfg.min_transmittance, cfg.density_scale)

    def chunk_noise(s):
        if noise is None:
            return _draw_noise(min(cfg.chunk, o_g.shape[0] - s), cfg, generator, o_g.device)
        return tuple(None if a is None else a[s : s + cfg.chunk] for a in noise)

    parts = [
        _render_staged(field, o_g[s : s + cfg.chunk], d_g[s : s + cfg.chunk],
                       t_near[s : s + cfg.chunk], t_far[s : s + cfg.chunk], cfg, chunk_noise(s))
        for s in range(0, o_g.shape[0], cfg.chunk)
    ]
    rgb, alpha, depth = (torch.cat(p) for p in zip(*parts))
    return {"rgb": rgb, "alpha": alpha, "depth": depth}


def render_image(
    field, c2w_nerf, fx, fy, cx, cy, width: int, height: int,
    aabb, cfg: RenderConfig, background=(1.0, 1.0, 1.0),
    sphere: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
):
    """Full-image render: dict(rgba (H, W, 4), depth (H, W))."""
    origins, dirs = rays_from_camera(c2w_nerf, fx, fy, cx, cy, width, height)
    out = render_rays(field, origins, dirs, aabb, cfg, sphere=sphere, generator=generator)
    rgb = out["rgb"].reshape(height, width, 3)
    alpha = out["alpha"].reshape(height, width)
    bg = torch.as_tensor(background, dtype=torch.float32, device=rgb.device)
    rgb = rgb + (1.0 - alpha[..., None]) * bg
    return {
        "rgba": torch.cat([rgb, alpha[..., None]], dim=-1),
        "depth": out["depth"].reshape(height, width),
    }
