"""Adam, its learning-rate schedules and the global-norm clip, in optax's arithmetic.

The JAX package trains with ``optax.adam(schedule, b1, b2, eps)``, the
schedule an ``optax.exponential_decay(lr, n, lr_final / lr)`` (the NeRF), a
constant (the dense descriptor) or ``optax.warmup_cosine_decay_schedule``
behind ``optax.clip_by_global_norm(1.0)`` (the matcher). This is that
update, step for step: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2)
g^2``, ``u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``, ``p -=
lr(k) u`` with ``t = k + 1`` for the k-th update, k from 0; the schedules
are evaluated in f32 as optax evaluates them. No weight decay.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def exponential_decay(lr: float, n_steps: int, lr_final: float, k: int) -> float:
    """optax.exponential_decay(lr, n_steps, lr_final / lr) at count k, in f32."""
    rate = np.float32(lr_final / lr)
    return float(np.float32(lr) * np.power(rate, np.float32(k) / np.float32(n_steps)))


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                        end_value: float, k: int) -> float:
    """optax.warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps, end_value) at count k, in f32: a linear ramp
    to the peak over ``warmup_steps``, then a cosine from the peak to
    ``end_value`` over the remaining ``decay_steps - warmup_steps``."""
    f = np.float32
    if k < warmup_steps:
        frac = f(1.0) - f(min(max(k, 0), warmup_steps)) / f(warmup_steps)
        return float(f(init_value - peak_value) * frac + f(peak_value))
    span = decay_steps - warmup_steps
    count = f(min(k - warmup_steps, span))
    cosine = f(0.5) * (f(1.0) + np.cos(f(np.pi) * count / f(span)))
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return float(f(peak_value) * (f(1.0 - alpha) * cosine + f(alpha)))


def matcher_schedule(lr: float, n_steps: int) -> Callable[[int], float]:
    """The matcher trainers' schedule: warmup_cosine_decay_schedule(0, lr,
    min(200, n // 10), n, 0.05 lr)."""
    warmup = min(200, n_steps // 10)
    return lambda k: warmup_cosine_decay(0.0, lr, warmup, n_steps, 0.05 * lr, k)


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the parameters' ``.grad`` in place: each
    scaled as (g / norm) * max_norm when the global norm >= max_norm; no
    host sync. Returns the norm before clipping."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))
    return norm


class Adam:
    """optax.adam over ``params`` (tensors updated in place) at the rate
    ``schedule(k)`` of the k-th update: ``lambda k: lr`` for a constant
    rate, or one of the schedules above."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        """One update from each parameter's ``.grad``, which is then cleared;
        the update above as multi-tensor (``_foreach``) ops, a dozen launches
        for all the parameters together."""
        t = self.count + 1
        lr = self.schedule(self.count)
        c1, c2 = 1.0 - self.b1**t, 1.0 - self.b2**t
        grads = [p.grad for p in self.params]
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        den = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(self.params, upd)
        for p in self.params:
            p.grad = None
        self.count = t
