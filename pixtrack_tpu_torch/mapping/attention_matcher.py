"""Attentional keypoint matcher (the SuperGlue role), at inference.

Port of ``pixtrack_tpu/mapping/attention_matcher.py``: a positional MLP
encoding plus alternating self / cross multi-head attention over the two
keypoint sets, then a dual-softmax assignment with a learned dustbin.
Padded keypoint sets carry a validity mask, so one shape serves every pair
of a power-of-two bucket.

The parameters keep flax's names and shapes (``Dense`` kernels (in, out);
the attention's query / key / value kernels (d_model, heads, head_dim) and
its out kernel (heads, head_dim, d_model), as ``DenseGeneral``; LayerNorm
``scale`` / ``bias``; the dustbin a scalar), so a checkpoint maps one to
one. Two details are flax's and not torch's defaults: LayerNorm's epsilon
(1e-6, and its variance as E[x^2] - E[x]^2), and the masked attention logits,
filled with the f32 minimum rather than -inf. A padded query row is masked
everywhere; with that fill its softmax is uniform and its output finite,
where -inf (or ``scaled_dot_product_attention``) gives NaN, which the next
block's zero weights carry into every valid row (0 * NaN = NaN).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from pixtrack_tpu_torch._device import resolve, true_f32

_TRUNC_STD = 0.87962566103423978  # stddev of a standard normal cut at +-2


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 5          # alternating self/cross blocks
    desc_dim: int = 845        # patch descriptor dim (13^2 x 5: color+grads)
    dustbin_init: float = 1.0


def _lecun_(p: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's default kernel initialisation in place (truncated lecun normal)."""
    nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
    p.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


class Dense(nn.Module):
    """flax ``Dense``: ``x @ kernel + bias``, kernel (in, out)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class MLP(nn.Module):
    def __init__(self, cin: int, dims: Tuple[int, ...]):
        super().__init__()
        self.n = len(dims)
        for i, d in enumerate(dims):
            setattr(self, f"Dense_{i}", Dense(cin, d))
            cin = d

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: epsilon 1e-6, variance E[x^2] - E[x]^2 clipped at 0."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class _Projection(nn.Module):
    """flax ``DenseGeneral`` onto (heads, head_dim)."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_model, n_heads, d_model // n_heads))
        self.bias = nn.Parameter(torch.zeros(n_heads, d_model // n_heads))

    def forward(self, x):
        return torch.einsum("bnd,dhk->bnhk", x, self.kernel) + self.bias


class _OutProjection(nn.Module):
    """flax ``DenseGeneral`` from (heads, head_dim) back to d_model."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_heads, d_model // n_heads, d_model))
        self.bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, x):
        return torch.einsum("bnhk,hkd->bnd", x, self.kernel) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (qkv_features = d_model): the
    query scaled by 1/sqrt(head_dim), masked logits filled with the f32
    minimum (never -inf), softmax over the keys."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.head_dim = d_model // n_heads
        self.query = _Projection(d_model, n_heads)
        self.key = _Projection(d_model, n_heads)
        self.value = _Projection(d_model, n_heads)
        self.out = _OutProjection(d_model, n_heads)

    def forward(self, x, source, mask):
        """``mask``: (B, 1, Nq, Nk) boolean."""
        q = self.query(x) / math.sqrt(self.head_dim)
        k, v = self.key(source), self.value(source)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class AttentionBlock(nn.Module):
    """Residual MHA + MLP, two LayerNorms."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(d_model, n_heads)
        self.LayerNorm_0 = LayerNorm(d_model)
        self.MLP_0 = MLP(d_model, (2 * d_model, d_model))
        self.LayerNorm_1 = LayerNorm(d_model)

    def forward(self, x, source, mask):
        x = x + self.MultiHeadDotProductAttention_0(x, source, mask)
        x = x + self.MLP_0(self.LayerNorm_0(x))
        return self.LayerNorm_1(x)


class AttentionMatcher(nn.Module):
    def __init__(self, cfg: MatcherConfig = MatcherConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.Dense_0 = Dense(c.desc_dim, c.d_model)
        self.MLP_0 = MLP(2, (32, 64, c.d_model))
        self.Dense_1 = Dense(c.desc_dim, c.d_model)
        self.MLP_1 = MLP(2, (32, 64, c.d_model))
        for i in range(c.n_layers):
            for name in ("self0", "self1", "cross0", "cross1"):
                setattr(self, f"{name}_{i}", AttentionBlock(c.d_model, c.n_heads))
        self.Dense_2 = Dense(c.d_model, c.d_model)
        self.Dense_3 = Dense(c.d_model, c.d_model)
        self.dustbin = nn.Parameter(torch.tensor(float(c.dustbin_init)))

    def forward(self, desc0, kp0, valid0, desc1, kp1, valid1):
        """All inputs batched: desc (B, N, D), kp (B, N, 2) normalised to
        [-1, 1], valid (B, N) bool. Returns the (B, N0+1, N1+1) assignment
        log-scores (last row / column = dustbins)."""
        c = self.cfg
        x0 = self.Dense_0(desc0) + self.MLP_0(kp0)
        x1 = self.Dense_1(desc1) + self.MLP_1(kp1)
        m00 = valid0[:, None, :, None] & valid0[:, None, None, :]
        m11 = valid1[:, None, :, None] & valid1[:, None, None, :]
        m01 = valid0[:, None, :, None] & valid1[:, None, None, :]
        m10 = valid1[:, None, :, None] & valid0[:, None, None, :]
        for i in range(c.n_layers):
            s0, s1 = getattr(self, f"self0_{i}"), getattr(self, f"self1_{i}")
            x0, x1 = s0(x0, x0, m00), s1(x1, x1, m11)
            c0, c1 = getattr(self, f"cross0_{i}"), getattr(self, f"cross1_{i}")
            x0, x1 = c0(x0, x1, m01), c1(x1, x0, m10)
        f0, f1 = self.Dense_2(x0), self.Dense_3(x1)
        scores = torch.einsum("bnd,bmd->bnm", f0, f1) / math.sqrt(c.d_model)
        B, N0, N1 = scores.shape
        scores = torch.cat([scores, self.dustbin.expand(B, N0, 1)], dim=2)
        scores = torch.cat([scores, self.dustbin.expand(B, 1, N1 + 1)], dim=1)
        # invalid (padded) keypoints may only match the dustbin
        ones = torch.ones((B, 1), dtype=torch.bool, device=valid0.device)
        v0, v1 = torch.cat([valid0, ones], dim=1), torch.cat([valid1, ones], dim=1)
        ok = v0[:, :, None] & v1[:, None, :]
        return torch.where(ok, scores, torch.full_like(scores, -1e9))


def assignment_log_probs(scores: torch.Tensor) -> torch.Tensor:
    """Dual-softmax log-probability matrix from raw scores (B, N0+1, N1+1):
    log P = 0.5 (log softmax over rows + log softmax over columns)."""
    return 0.5 * (torch.log_softmax(scores, dim=2) + torch.log_softmax(scores, dim=1))


def extract_matches(logp: np.ndarray, n0: int, n1: int, min_score: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """(matches0, scores0) from one (N0+1, N1+1) log-prob matrix: mutual
    argmax among real keypoints, beating the dustbin, above min_score."""
    P = np.exp(np.asarray(logp))
    real = P[:n0, :n1]
    best1 = real.argmax(axis=1)
    best0 = real.argmax(axis=0)
    mutual = best0[best1] == np.arange(n0)
    s = real[np.arange(n0), best1]
    beats_bin = s > P[:n0, n1]  # better than "unmatched"
    keep = mutual & beats_bin & (s >= min_score)
    matches0 = np.where(keep, best1, -1).astype(np.int32)
    return matches0, np.where(keep, s, 0.0).astype(np.float32)


def bucket_size(n0: int, n1: int) -> int:
    """The padded set size of a pair: the next power of two, at least 32."""
    return 1 << int(np.ceil(np.log2(max(n0, n1, 32))))


class LearnedMatcher:
    """``match_descriptors``-shaped callable around a matcher: pads each set
    to its power-of-two bucket, normalises keypoints by the image size, and
    runs on the matcher's device in true f32. ``desc_dim`` is the descriptor
    width the matcher was trained on."""

    def __init__(self, model: AttentionMatcher, min_score: float = 0.2):
        self.model = model.eval()
        self.min_score = min_score
        self.desc_dim = model.cfg.desc_dim

    def log_probs(self, desc0, kp0, shape0, desc1, kp1, shape1, N: Optional[int] = None) -> np.ndarray:
        """The (N+1, N+1) assignment log-probabilities of one pair padded to
        ``N`` (its bucket by default)."""
        n0, n1 = len(desc0), len(desc1)
        N = N or bucket_size(n0, n1)
        device = self.model.dustbin.device

        def prep(desc, kp, shape, n):
            H, W = shape[:2]
            kpn = (np.asarray(kp, np.float32) / np.array([W, H], np.float32)) * 2.0 - 1.0
            d = np.zeros((N, desc.shape[-1]), np.float32)
            k = np.zeros((N, 2), np.float32)
            v = np.zeros(N, bool)
            d[:n], k[:n], v[:n] = np.asarray(desc, np.float32), kpn, True
            return [torch.from_numpy(a[None]).to(device) for a in (d, k, v)]

        with torch.no_grad(), true_f32():
            logp = assignment_log_probs(self.model(*prep(desc0, kp0, shape0, n0), *prep(desc1, kp1, shape1, n1)))
        return logp[0].cpu().numpy()

    def __call__(self, desc0, kp0, shape0, desc1, kp1, shape1) -> Tuple[np.ndarray, np.ndarray]:
        desc0, desc1 = _np(desc0), _np(desc1)
        n0, n1 = len(desc0), len(desc1)
        if n0 == 0 or n1 == 0:
            return np.full(n0, -1, np.int32), np.zeros(n0, np.float32)
        logp = self.log_probs(desc0, _np(kp0), shape0, desc1, _np(kp1), shape1)
        return extract_matches(logp, n0, n1, self.min_score)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@torch.no_grad()
def init_matcher(cfg: MatcherConfig = MatcherConfig(), generator: Optional[torch.Generator] = None,
                 device=None) -> AttentionMatcher:
    """An ``AttentionMatcher`` on ``device`` (None is the CUDA card) with
    flax's default initialisation (truncated lecun-normal kernels over their
    input axis, zero biases, LayerNorm 1 / 0, the dustbin at
    ``cfg.dustbin_init``), drawn from ``generator``: the JAX package's
    distribution, not its bits."""
    device = resolve(device)
    model = AttentionMatcher(cfg)
    for m in model.modules():
        if isinstance(m, (Dense, _Projection)):
            _lecun_(m.kernel, m.kernel.shape[0], generator)
        elif isinstance(m, _OutProjection):
            _lecun_(m.kernel, m.kernel.shape[0] * m.kernel.shape[1], generator)
    return model.to(device).eval()


def _flax_key(name: str) -> str:
    return "params/" + name.replace(".", "/")


def save_matcher_weights(path, model: AttentionMatcher, cfg: Optional[MatcherConfig] = None) -> None:
    """The JAX package's checkpoint format: flax paths joined by "/" and a
    ``__meta__`` JSON with the key list and the config."""
    arrays = {_flax_key(k): v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    meta = {"keys": list(arrays), "cfg": dataclasses.asdict(cfg or model.cfg)}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_matcher_weights(path, device=None) -> Tuple[AttentionMatcher, MatcherConfig]:
    """A checkpoint of either package: (the matcher on ``device``, None is
    the CUDA card; its config)."""
    device = resolve(device)
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    cfg = MatcherConfig(**meta["cfg"])
    model = AttentionMatcher(cfg)
    if set(meta["keys"]) != {_flax_key(k) for k in model.state_dict()}:
        raise ValueError(f"{path}: its keys are not those of its config's matcher")
    state = {k: torch.from_numpy(np.asarray(data[_flax_key(k)], np.float32)) for k in model.state_dict()}
    model.load_state_dict(state, strict=True)
    return model.to(device).eval(), cfg
