"""Adam under an exponential learning-rate decay, in optax's arithmetic.

The JAX package trains with ``optax.adam(optax.exponential_decay(lr, n,
lr_final / lr), b1, b2, eps)``. This is that update, step for step:
``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, ``u = (mu / (1 -
b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``, ``p -= lr(k) u`` with ``t = k + 1``
and ``lr(k) = lr * (lr_final / lr) ** (k / n)`` for the k-th update, k from
0. No weight decay.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def exponential_decay(lr: float, n_steps: int, lr_final: float, k: int) -> float:
    """optax.exponential_decay(lr, n_steps, lr_final / lr) at count k, in f32."""
    rate = np.float32(lr_final / lr)
    return float(np.float32(lr) * np.power(rate, np.float32(k) / np.float32(n_steps)))


class Adam:
    """optax.adam over ``params`` (tensors updated in place) with the
    exponential decay schedule."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, n_steps: int, lr_final: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.n_steps, self.lr_final = lr, n_steps, lr_final
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
        lr = exponential_decay(self.lr, self.n_steps, self.lr_final, self.count)
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
