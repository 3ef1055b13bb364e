"""The distilled render field: a frequency-encoded MLP, feature-major, and
how it is fitted.

Port of ``pixtrack_tpu/nerf/distill.py``: ``DistilledField``, its
initialisation, ``distill`` (regression to a teacher field at sampled
points), ``finetune_photometric`` (training through the volume renderer
against a capture's pixels), ``save_distilled`` and ``load_distilled``.
Every dense layer rounds its operands to bf16 and accumulates in f32, as the
JAX field does: the products of two bf16 values are exact in f32, so the
plain version computes ``w.bf16().float() @ h.bf16().float()`` in f32; in
training the casts round the gradients to bf16 too, as JAX's ``astype``
does. Training works on a copy of the field whose tensors are autograd
leaves and returns a new field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.nerf.field import sh_encoding_deg4_T
from pixtrack_tpu_torch.nerf.optim import Adam, exponential_decay


@dataclasses.dataclass
class DistilledField:
    """trunk: enc(3 + 6*octaves) -> width x depth -> head (1 + geo);
    color: (geo + SH16) -> 64 -> 64 -> 3 (sigmoid).
    Layers are {"kernel": (out, in), "bias": (out, 1)} tensors."""

    trunk: List[Dict[str, torch.Tensor]]
    head: Dict[str, torch.Tensor]
    color: List[Dict[str, torch.Tensor]]
    octaves: int = 8
    geo_features: int = 15

    @property
    def device(self) -> torch.device:
        return self.head["kernel"].device

    def layers(self) -> List[Dict[str, torch.Tensor]]:
        return self.trunk + [self.head] + self.color

    def tensors(self) -> List[torch.Tensor]:
        """Every kernel and bias, layer by layer."""
        return [t for p in self.layers() for t in (p["kernel"], p["bias"])]

    def _map(self, fn) -> "DistilledField":
        """A field of the same shape with every tensor replaced by fn(tensor)."""
        def layer(p):
            return {k: fn(v) for k, v in p.items()}

        return DistilledField(trunk=[layer(p) for p in self.trunk], head=layer(self.head),
                              color=[layer(p) for p in self.color], octaves=self.octaves,
                              geo_features=self.geo_features)

    def encode_T(self, xT: torch.Tensor) -> torch.Tensor:
        freqs = 2.0 ** torch.arange(self.octaves, dtype=torch.float32, device=xT.device) * torch.pi
        ang = (xT[:, None, :] * freqs[None, :, None]).reshape(3 * self.octaves, -1)
        return torch.cat([xT, torch.sin(ang), torch.cos(ang)], dim=0)

    @staticmethod
    def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        w = p["kernel"].to(torch.bfloat16).float()
        return w @ x.to(torch.bfloat16).float() + p["bias"]

    def density_T(self, xT: torch.Tensor):
        h = self.encode_T(xT)
        for p in self.trunk:
            h = torch.relu(self._dense(p, h))
        h = self._dense(self.head, h)
        # expm1 inverts the log1p density target; the stable form of exp - 1
        return torch.expm1(F.softplus(h[0])), h[1:]

    def color_T(self, geoT: torch.Tensor, dT: torch.Tensor) -> torch.Tensor:
        h = torch.cat([geoT, sh_encoding_deg4_T(dT)], dim=0)
        for p in self.color[:-1]:
            h = torch.relu(self._dense(p, h))
        return torch.sigmoid(self._dense(self.color[-1], h))

    def field_T(self, xT: torch.Tensor, dT: torch.Tensor):
        """Positions (3, N) and unit directions (3, N) -> (sigma (N,), rgb (3, N))."""
        sigma, geo = self.density_T(xT)
        return sigma, self.color_T(geo, dT)


def init_distilled(seed: int = 0, octaves: int = 8, width: int = 128, depth: int = 4,
                   color_width: int = 64, geo_features: int = 15, device=None) -> DistilledField:
    """A freshly initialised field, as the JAX package's ``init_distilled``
    draws it (He-normal weights, zero biases, density bias -3), from a numpy
    generator: the same seed gives other numbers than ``jax.random``.
    ``device`` None is the CUDA card."""
    rng = np.random.default_rng(seed)
    arrays = {"meta": np.asarray([octaves, geo_features, depth, 3])}

    def dense(name, n_out, n_in):
        arrays[f"{name}_k"] = rng.normal(size=(n_out, n_in)) * np.sqrt(2.0 / n_in)
        arrays[f"{name}_b"] = np.zeros((n_out, 1))

    n_in = 3 + 6 * octaves
    for i in range(depth):
        dense(f"trunk{i}", width, n_in)
        n_in = width
    dense("head", 1 + geo_features, width)
    arrays["head_b"][0, 0] = -3.0
    dense("color0", color_width, geo_features + 16)
    dense("color1", color_width, color_width)
    dense("color2", 3, color_width)
    return distilled_from_arrays(arrays, device=device)


def distilled_from_arrays(arrays, device=None) -> DistilledField:
    """Build a field from the npz layout ``save_distilled`` writes:
    ``trunk{i}_k`` (out, in), ``trunk{i}_b`` (out, 1), ``head_*``,
    ``color{i}_*`` and ``meta`` = (octaves, geo, n_trunk, n_color), on
    ``device`` (None is the CUDA card)."""
    device = resolve(device)
    octaves, geo, n_trunk, n_color = (int(v) for v in np.asarray(arrays["meta"]))

    def t(key):
        return torch.as_tensor(np.array(arrays[key], np.float32), device=device)

    def layer(prefix):
        return {"kernel": t(f"{prefix}_k"), "bias": t(f"{prefix}_b")}

    return DistilledField(
        trunk=[layer(f"trunk{i}") for i in range(n_trunk)],
        head=layer("head"),
        color=[layer(f"color{i}") for i in range(n_color)],
        octaves=octaves,
        geo_features=geo,
    )


def load_distilled(path, device=None) -> DistilledField:
    """A field saved by the JAX package's ``save_distilled``, on ``device``
    (None is the CUDA card)."""
    device = resolve(device)
    with np.load(path) as z:
        return distilled_from_arrays({k: z[k] for k in z.files}, device=device)


def save_distilled(path, field: DistilledField) -> None:
    """Write the field as the JAX package's ``save_distilled`` does (.npz)."""
    arrays = {}
    for name, layers in (("trunk", field.trunk), ("color", field.color)):
        for i, p in enumerate(layers):
            arrays[f"{name}{i}_k"] = p["kernel"].detach().cpu().numpy()
            arrays[f"{name}{i}_b"] = p["bias"].detach().cpu().numpy()
    arrays["head_k"] = field.head["kernel"].detach().cpu().numpy()
    arrays["head_b"] = field.head["bias"].detach().cpu().numpy()
    arrays["meta"] = np.asarray([field.octaves, field.geo_features, len(field.trunk), len(field.color)])
    np.savez(path, **arrays)


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    steps: int = 4000
    batch: int = 1 << 15
    dataset_size: int = 1 << 21
    lr: float = 2e-3
    lr_final: float = 1e-4
    octaves: int = 8
    width: int = 128
    depth: int = 4
    surface_frac: float = 0.7  # share of the points drawn near occupied cells
    sigma_weight_scale: float = 5.0  # weight of occupied-space points
    color_loss_weight: float = 5.0


def _sample_points(n: int, aabb, occ: Optional[np.ndarray], surface_frac: float, pad_frac: float = 0.25,
                   noise=None, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """(3, n) points: ``surface_frac`` of them jittered inside occupied cells
    of ``occ`` (indexed [x, y, z]), the rest uniform in the aabb grown by
    ``pad_frac`` of its extent (clipped to [0, 1]), so that the student
    learns empty space just outside the crop box too. ``noise`` = (cell
    picks (n_sur,), jitter (3, n_sur) and uniform (3, n - n_sur) in [0, 1))
    replaces the draws from ``generator``."""
    device = generator.device if generator is not None else resolve(device)
    lo = torch.as_tensor(np.asarray(aabb[0], np.float32), device=device)
    hi = torch.as_tensor(np.asarray(aabb[1], np.float32), device=device)
    ext = hi - lo
    lo, hi = (lo - pad_frac * ext).clamp(0.0, 1.0), (hi + pad_frac * ext).clamp(0.0, 1.0)
    n_sur = int(n * surface_frac) if occ is not None and occ.any() else 0
    if noise is None:
        n_occ = int(occ.sum()) if n_sur else 1
        noise = (torch.randint(0, n_occ, (n_sur,), generator=generator, device=device),
                 torch.rand(3, n_sur, generator=generator, device=device),
                 torch.rand(3, n - n_sur, generator=generator, device=device))
    pick, jit, u = (torch.as_tensor(a, device=device) for a in noise)
    pts = []
    if n_sur:
        cells = torch.as_tensor(np.stack(np.nonzero(occ)), device=device)  # (3, n_occ)
        pts.append((cells[:, pick.long()].float() + jit.float()) / occ.shape[0])
    pts.append(lo[:, None] + (hi - lo)[:, None] * u.float())
    return torch.cat(pts, dim=1)


def _trainable(field: DistilledField) -> DistilledField:
    return field._map(lambda t: t.detach().clone().requires_grad_(True))


def distill(teacher, aabb, occ: Optional[np.ndarray] = None, config: DistillConfig = DistillConfig(),
            seed: int = 0, teacher_chunk: int = 1 << 19, log_every: int = 0,
            density_mask: Optional[np.ndarray] = None, student: Optional[DistilledField] = None,
            noise=None) -> DistilledField:
    """Fit a DistilledField to any teacher with ``field_T`` and ``device``
    (NGPField, BakedField, analytic), on the teacher's device.

    The points come from ``_sample_points``; each looks back along a
    camera-like ray (an eye on a sphere 2.5 half-diagonals around the aabb's
    centre), not a uniform direction, as render-time rays do. Outside
    ``density_mask`` ((R, R, R) bool, indexed [x, y, z]) the teacher's
    density is clamped to zero. Density is regressed in log1p space,
    weighted up in occupied space, colour where the teacher is occupied.
    The batches walk one fixed permutation (``np.random.default_rng(0)``);
    Adam at optax's defaults under the exponential decay. ``student`` is the
    starting field (default ``init_distilled(seed)``, as wide as the
    config); ``noise`` = dict(points=_sample_points' noise, eye=(3, N)
    standard normal) replaces the draws from a generator seeded from
    ``seed``."""
    device = teacher.device
    generator = torch.Generator(device=device).manual_seed(seed)
    N = config.dataset_size
    noise = noise or {}
    x = _sample_points(N, aabb, occ, config.surface_frac, noise=noise.get("points"), generator=generator)
    lo, hi = (torch.as_tensor(np.asarray(a, np.float32), device=device) for a in aabb)
    ctr, half_diag = 0.5 * (lo + hi), 0.5 * torch.linalg.norm(hi - lo)
    u = noise.get("eye")
    u = torch.randn(3, N, generator=generator, device=device) if u is None else torch.as_tensor(u, device=device)
    u = u / torch.linalg.norm(u, dim=0, keepdim=True).clamp_min(1e-9)
    d = x - (ctr[:, None] + 2.5 * half_diag * u)
    d = d / torch.linalg.norm(d, dim=0, keepdim=True).clamp_min(1e-9)
    sig, rgb = torch.empty(N, device=device), torch.empty(3, N, device=device)
    with torch.no_grad():
        for s in range(0, N, teacher_chunk):
            sig[s : s + teacher_chunk], rgb[:, s : s + teacher_chunk] = teacher.field_T(
                x[:, s : s + teacher_chunk], d[:, s : s + teacher_chunk])
    if density_mask is not None:
        res = density_mask.shape[0]
        ix = (x * res).long().clamp(0, res - 1)
        mask = torch.as_tensor(density_mask, device=device)
        sig = torch.where(mask[ix[0], ix[1], ix[2]], sig, 0.0)
    log_sig = torch.log1p(sig)
    occupied = (sig > 0.01).float()
    w = 1.0 + config.sigma_weight_scale * occupied

    st = _trainable(student or init_distilled(seed, octaves=config.octaves, width=config.width,
                                              depth=config.depth, device=device))
    opt = Adam(st.tensors(), lambda k: exponential_decay(config.lr, config.steps, config.lr_final, k))

    def loss_fn(xb, db, ls_b, rgb_b, wb, ob):
        h = st.encode_T(xb)
        for p in st.trunk:
            h = torch.relu(st._dense(p, h))
        h = st._dense(st.head, h)
        ls_pred = F.softplus(h[0])  # the log1p(sigma) prediction
        rgb_pred = st.color_T(h[1:], db)
        l_sig = torch.mean(wb * (ls_pred - ls_b) ** 2)
        # colour is invisible where there is no density: fitted only where there is
        l_rgb = torch.sum(ob[None] * (rgb_pred - rgb_b) ** 2) / (3.0 * ob.sum().clamp_min(1.0))
        return l_sig + config.color_loss_weight * l_rgb

    perm = torch.as_tensor(np.random.default_rng(0).permutation(N), device=device)
    x, d, rgb = x[:, perm], d[:, perm], rgb[:, perm]
    log_sig, w, occupied = log_sig[perm], w[perm], occupied[perm]
    B = config.batch
    n_batches = max(N // B, 1)
    for i in range(config.steps):
        s = (i % n_batches) * B
        loss = loss_fn(x[:, s : s + B], d[:, s : s + B], log_sig[s : s + B], rgb[:, s : s + B],
                       w[s : s + B], occupied[s : s + B])
        loss.backward()
        opt.step()
        if log_every and (i + 1) % log_every == 0:
            print(f"distill step {i + 1}: loss {loss.item():.5f}", flush=True)
    return st._map(torch.Tensor.detach)


def finetune_photometric(student: DistilledField, dataset, aabb, steps: int = 3000, batch_rays: int = 1 << 13,
                         n_coarse: int = 64, lr: float = 1e-3, lr_final: float = 1e-4, background: str = "white",
                         ray_pool_cap: int = 1 << 21, seed: int = 0, log_every: int = 0) -> DistilledField:
    """Fine-tune a distilled student through the volume renderer against a
    capture's pixels (a NerfDataset), after ``distill``: the render's
    fidelity depends on where along each ray the density steps up, which a
    point-wise fit places a voxel or two off. Renders ``n_coarse`` jittered
    samples a ray through the staged render with ``fused=False`` (the
    kernels have no backward); the ray pool is capped as ``train.ray_pool``
    caps it. Adam at optax's defaults under the exponential decay; batch
    indices and noise from a device generator seeded from ``seed``. Returns
    a new field."""
    from pixtrack_tpu_torch.nerf.render import RenderConfig, render_rays
    from pixtrack_tpu_torch.nerf.train import batch_indices, ray_pool

    device = student.device
    origins, dirs, rgbs = ray_pool(dataset, ray_pool_cap, background, seed, device)
    n_rays = origins.shape[0]
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32), device=device)
    bg = 1.0 if background == "white" else 0.0
    rcfg = RenderConfig(n_coarse=n_coarse, n_fine=0, perturb=True, fused=False, min_transmittance=1e-4,
                        chunk=batch_rays)
    st = _trainable(student)
    opt = Adam(st.tensors(), lambda k: exponential_decay(lr, steps, lr_final, k))
    generator = torch.Generator(device=device).manual_seed(seed)
    for i in range(steps):
        idx = batch_indices(generator, n_rays, batch_rays)
        out = render_rays(st, origins[idx], dirs[idx], aabb_t, rcfg, generator=generator)
        pred = out["rgb"] + (1.0 - out["alpha"][:, None]) * bg
        loss = torch.mean((pred - rgbs[idx]) ** 2)
        loss.backward()
        opt.step()
        if log_every and (i + 1) % log_every == 0:
            print(f"finetune step {i + 1}: loss {loss.item():.6f}", flush=True)
    return st._map(torch.Tensor.detach)
