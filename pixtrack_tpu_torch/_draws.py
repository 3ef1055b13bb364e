"""Canonical draws and their maps, shared by the trainers.

Every trainer of the port takes its randomness as canonical draws from a
``torch.Generator`` (uniforms in [0, 1), standard normals), kept apart from
the arithmetic, and maps them to their ranges as ``jax.random`` maps its
own, so that the tests can feed the port the JAX package's draws. This
module imports nothing of the package.
"""

from __future__ import annotations

import numpy as np
import torch


def _rand(generator, device, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def _randn(generator, device, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


def _np_dtype(t: torch.Tensor):
    return np.float64 if t.dtype == torch.float64 else np.float32


def _uniform(u01: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """A [0, 1) draw mapped into [lo, hi) as jax.random.uniform maps its own:
    bounds in the draw's precision, clamped at lo."""
    dt = _np_dtype(u01)
    lo_, hi_ = dt(lo), dt(hi)
    return torch.clamp_min(u01 * float(hi_ - lo_) + float(lo_), float(lo_))


def _normal_of_uniform(u01: torch.Tensor) -> torch.Tensor:
    """The standard normal jax.random.normal makes of the same [0, 1) draw
    (a uniform on (nextafter(-1, 0), 1) through sqrt(2) erfinv)."""
    dt = _np_dtype(u01)
    return float(dt(np.sqrt(2.0))) * torch.erfinv(_uniform(u01, np.nextafter(dt(-1.0), dt(0.0)), 1.0))
