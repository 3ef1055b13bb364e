"""The multiresolution hash-grid NeRF field and the view-direction encoding.

Port of ``pixtrack_tpu/nerf/field.py``: ``trunc_exp``, the hash encoding,
the feature-major dense layer, ``NGPField`` and ``init_field``, plus
``ngp_from_flax_params`` / ``ngp_to_flax_params``, which carry weights
between the JAX package's flax tree and this module.

The field works feature-major, (3, N) positions in grid space [0, 1]^3, as
the JAX field does. The tables of all levels are one (L, F, T) parameter, so
that a sample's 8 L corner lookups are one gather and the gradient one
scatter-add; the flax tree holds them per level (``table{l}``, (F, T)).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from pixtrack_tpu_torch._device import resolve

# spatial-hash primes (Teschner et al.; instant-ngp's)
_PRIMES = (1, 2654435761, 805459861)
# the 8 trilinear corners, in the order the JAX encoding sums them
_CORNERS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))
# the dense layers, in flax's (sorted) order
_LAYERS = ("color_l1", "color_l2", "color_l3", "density_l1", "density_l2")


class _TruncExp(torch.autograd.Function):
    """exp(clip(x, -15, 15)); the gradient is exp(clip(x)) * dx everywhere,
    also where the clip is active (the JAX custom JVP)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(x.clamp(-15.0, 15.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def sh_encoding_deg4_T(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to degree 4, feature-major: (3, N) -> (16, N)."""
    x, y, z = d[0], d[1], d[2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    return torch.stack(
        [
            0.28209479177387814 * one,
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ],
        dim=0,
    )


def _level_resolutions(n_levels, base_res, max_res) -> np.ndarray:
    b = np.exp((np.log(max_res) - np.log(base_res)) / max(n_levels - 1, 1))
    return np.floor(base_res * (b ** np.arange(n_levels))).astype(np.int64)


def spatial_hash(cx, cy, cz, T: int) -> torch.Tensor:
    """The uint32 spatial hash of integer coordinates, masked to T slots, in
    int64: the low 32 bits of each int64 product are the uint32 product, and
    XOR and the mask keep only low bits."""
    return (cx * _PRIMES[0] ^ cy * _PRIMES[1] ^ cz * _PRIMES[2]) & (T - 1)


class HashEncoding(nn.Module):
    """Multires hash encoding, feature-major: (3, N) in [0, 1] -> (L*F, N)."""

    def __init__(self, n_levels=16, features_per_level=2, log2_table_size=19, base_res=16, max_res=2048):
        super().__init__()
        self.n_levels, self.features_per_level = n_levels, features_per_level
        self.log2_table_size, self.base_res, self.max_res = log2_table_size, base_res, max_res
        T = 1 << log2_table_size
        self.resolutions = _level_resolutions(n_levels, base_res, max_res)
        self.dense = [(int(r) + 1) ** 3 <= T for r in self.resolutions]
        for r, dense in zip(self.resolutions, self.dense):
            # a dense level's largest index, n + n^2 + n^3 at x = 1.0, must
            # lie inside its table: the JAX gather returns NaN there, a CUDA
            # one asserts (full width: 208,919 at resolution 58, of 2^19)
            n = int(r) + 1
            if dense and n * (1 + n + n * n) >= T:
                raise ValueError(f"a dense level of resolution {r} overruns a table of {T} entries at x = 1")
        self.tables = nn.Parameter(torch.zeros(n_levels, features_per_level, T))
        res = torch.as_tensor(self.resolutions, dtype=torch.float32)
        self.register_buffer("_res", res.reshape(-1, 1, 1), persistent=False)
        self.register_buffer("_dense", torch.as_tensor(self.dense).reshape(-1, 1), persistent=False)

    def _gather(self, slots: torch.Tensor) -> torch.Tensor:
        """The table entries of the corners' slots (L, 8, N): (F, L, 8, N)."""
        L, F, T = self.tables.shape
        with torch.no_grad():
            # the flat index of feature f: l*F*T + f*T + slot
            idx = slots + torch.arange(L, device=slots.device)[:, None, None] * (F * T)
            idx = idx[None] + (torch.arange(F, device=slots.device) * T).reshape(F, 1, 1, 1)
        return self.tables.reshape(-1)[idx.reshape(-1)].reshape(F, L, *slots.shape[1:])

    def forward(self, xT: torch.Tensor) -> torch.Tensor:
        L, F = self.n_levels, self.features_per_level
        T = 1 << self.log2_table_size
        N = xT.shape[1]
        xs = xT[None] * self._res  # (L, 3, N)
        x0 = torch.floor(xs)
        frac = xs - x0
        with torch.no_grad():
            x0i = x0.long()
            side = self._res.long()[:, 0] + 1  # (L, 1)
            slots = []
            for ci, cj, ck in _CORNERS:
                cx, cy, cz = x0i[:, 0] + ci, x0i[:, 1] + cj, x0i[:, 2] + ck
                dense = cx + side * (cy + side * cz)
                slots.append(torch.where(self._dense, dense, spatial_hash(cx, cy, cz, T)))
            slots = torch.stack(slots, dim=1)  # (L, 8, N), each in [0, T)
        vals = self._gather(slots)
        acc = None
        for c, (ci, cj, ck) in enumerate(_CORNERS):
            wx = frac[:, 0] if ci else 1.0 - frac[:, 0]
            wy = frac[:, 1] if cj else 1.0 - frac[:, 1]
            wz = frac[:, 2] if ck else 1.0 - frac[:, 2]
            contrib = vals[:, :, c] * (wx * wy * wz)[None]  # (F, L, N)
            acc = contrib if acc is None else acc + contrib
        return acc.transpose(0, 1).reshape(L * F, N)  # level-major, as the JAX concatenation


class TDense(nn.Module):
    """Feature-major dense layer: (C_in, N) -> (C_out, N) as W @ x + b, f32."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.kernel @ x + self.bias


class NGPField(nn.Module):
    """Hash encoding + density MLP + color MLP (instant-ngp's base shape).

    density(x):      enc(L*F) -> hidden -> 1 + geo features
    color(geo, dir): (geo + SH16) -> hidden -> hidden -> rgb (sigmoid)
    """

    def __init__(self, n_levels=16, features_per_level=2, log2_table_size=19, base_res=16, max_res=2048,
                 hidden=64, geo_features=15):
        super().__init__()
        self.n_levels, self.features_per_level, self.log2_table_size = n_levels, features_per_level, log2_table_size
        self.base_res, self.max_res, self.hidden, self.geo_features = base_res, max_res, hidden, geo_features
        self.encoding = HashEncoding(n_levels, features_per_level, log2_table_size, base_res, max_res)
        self.density_l1 = TDense(n_levels * features_per_level, hidden)
        self.density_l2 = TDense(hidden, 1 + geo_features)
        self.color_l1 = TDense(geo_features + 16, hidden)
        self.color_l2 = TDense(hidden, hidden)
        self.color_l3 = TDense(hidden, 3)

    @property
    def device(self) -> torch.device:
        return self.encoding.tables.device

    def density_T(self, xT: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """xT (3, N) in [0, 1] -> (sigma (N,), geo (G, N))."""
        h = torch.relu(self.density_l1(self.encoding(xT)))
        h = self.density_l2(h)
        return trunc_exp(h[0]), h[1:]

    def color_T(self, geoT: torch.Tensor, dT: torch.Tensor) -> torch.Tensor:
        """geoT (G, N), dT (3, N) unit directions -> rgb (3, N) in [0, 1]."""
        h = torch.cat([geoT, sh_encoding_deg4_T(dT)], dim=0)
        h = torch.relu(self.color_l1(h))
        h = torch.relu(self.color_l2(h))
        return torch.sigmoid(self.color_l3(h))

    def field_T(self, xT: torch.Tensor, dT: torch.Tensor):
        sigma, geo = self.density_T(xT)
        return sigma, self.color_T(geo, dT)

    def density(self, x: torch.Tensor):
        """x (N, 3) -> (sigma (N,), geo (N, G))."""
        sigma, geoT = self.density_T(x.T)
        return sigma, geoT.T

    def forward(self, x: torch.Tensor, d: torch.Tensor):
        """x, d (N, 3) -> (sigma (N,), rgb (N, 3))."""
        sigma, rgbT = self.field_T(x.T, d.T)
        return sigma, rgbT.T

    def config(self) -> Dict[str, int]:
        return {k: int(getattr(self, k)) for k in (
            "n_levels", "features_per_level", "log2_table_size", "base_res", "max_res", "hidden", "geo_features")}


def init_field(seed: int = 0, device=None, **kwargs) -> NGPField:
    """A freshly initialised field, drawn as the JAX package's ``init_field``
    draws it (tables uniform in +-1e-4; kernels flax's lecun_normal, a
    normal truncated at two deviations with its scale corrected; zero
    biases), from a numpy generator: the same seed gives other numbers than
    ``jax.random``. ``device`` None is the CUDA card."""
    device = resolve(device)
    field = NGPField(**kwargs)
    rng = np.random.default_rng(seed)
    enc = field.encoding
    shape = (enc.features_per_level, 1 << enc.log2_table_size)
    params = {"encoding": {f"table{lvl}": rng.uniform(-1e-4, 1e-4, shape) for lvl in range(enc.n_levels)}}
    for name in _LAYERS:
        n_out, n_in = getattr(field, name).kernel.shape
        w = rng.normal(size=(n_out, n_in))
        while (bad := np.abs(w) > 2.0).any():
            w[bad] = rng.normal(size=int(bad.sum()))
        params[name] = {"kernel": w * np.sqrt(1.0 / n_in) / 0.87962566103423978, "bias": np.zeros((n_out, 1))}
    _load_flax(field, {"params": params})
    return field.to(device)


def _load_flax(field: NGPField, params) -> None:
    p = params["params"]
    with torch.no_grad():
        enc = field.encoding
        tables = [np.asarray(p["encoding"][f"table{lvl}"], np.float32) for lvl in range(enc.n_levels)]
        enc.tables.copy_(torch.from_numpy(np.stack(tables)))
        for name in _LAYERS:
            layer = getattr(field, name)
            layer.kernel.copy_(torch.from_numpy(np.array(p[name]["kernel"], np.float32)))
            layer.bias.copy_(torch.from_numpy(np.array(p[name]["bias"], np.float32)))


def ngp_from_flax_params(params, device=None, **field_kw) -> NGPField:
    """A field holding the weights of a flax ``NGPField`` params tree
    (``params["params"]["encoding"]["table{l}"]`` (F, T); ``density_l1/l2``,
    ``color_l1/l2/l3``: ``kernel`` (out, in), ``bias`` (out, 1)), on
    ``device`` (None is the CUDA card). ``field_kw`` are the field's
    constructor arguments, as for the JAX field."""
    device = resolve(device)
    field = NGPField(**field_kw)
    _load_flax(field, params)
    return field.to(device)


def ngp_to_flax_params(field: NGPField) -> dict:
    """The field's weights as a flax params tree of numpy arrays (the
    inverse of ``ngp_from_flax_params``)."""
    tables = field.encoding.tables.detach().cpu().numpy()
    p = {"encoding": {f"table{lvl}": tables[lvl] for lvl in range(field.n_levels)}}
    for name in _LAYERS:
        layer = getattr(field, name)
        p[name] = {"bias": layer.bias.detach().cpu().numpy(), "kernel": layer.kernel.detach().cpu().numpy()}
    return {"params": p}
