"""The distilled render field: a frequency-encoded MLP, feature-major.

Port of ``DistilledField`` (``encode_T``, ``density_T``, ``color_T``,
``field_T``) and ``load_distilled`` from ``pixtrack_tpu/nerf/distill.py``.
Training and distillation are not ported. Every dense layer rounds its
operands to bf16 and accumulates in f32, as the JAX field does: the
products of two bf16 values are exact in f32, so the plain version computes
``w.bf16().float() @ h.bf16().float()`` in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.nerf.field import sh_encoding_deg4_T


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
