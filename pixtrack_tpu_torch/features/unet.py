"""UNet feature-pyramid extractor as an ``nn.Module``.

Port of ``pixtrack_tpu/features/unet.py``. Module and parameter names follow
the flax tree (``ConvBlock_0``, ``Down_0..3``, ``Up_0..3``,
``head16/head4/head1.{feat,conf}``), so ``unet_state_dict_from_flax`` maps a
flax checkpoint name for name. The public layout stays NHWC like the JAX
model; inside, the network runs NCHW.

Matched to flax: GroupNorm(min(8, C)) with epsilon 1e-6 (torch's default is
1e-5) and flax's fast variance E[x^2] - E[x]^2; ``Up`` concatenates
``[upsampled, skip]``; the nearest 2x upsample is exact at inputs that are
multiples of 16. Parameters stay f32 and only the activations take the
model's ``dtype``, as flax's ``dtype``/``param_dtype`` split does.

The roundings are XLA's, not one per op: XLA (``xla_allow_excess_precision``,
on by default) keeps a bf16 op's result in f32 for the consumers it fuses
with. A convolution's output is rounded to ``dtype`` and its rounded bias
added in f32, unrounded; GroupNorm takes its statistics from that sum
rounded to ``dtype`` but normalises the unrounded sum, and rounds its
result; the heads' features and confidences are the unrounded f32 values
(``scripts_dev/unet_bf16_rounding.py`` reads the compiled HLO's effect
layer by layer). In f32 every rounding is the identity.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve

_FLAX_GN_EPS = 1e-6
# the standard deviation of a standard normal cut to (-2, 2)
_TRUNC_STD = 0.87962566103423978


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv(dtype=...)`` as XLA runs it: weights and bias rounded to
    the input's dtype, the convolution's output rounded to it, the bias added
    in f32 (f64 for an f64 model). Returns that sum, unrounded."""

    def forward(self, x):
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        acc = torch.promote_types(x.dtype, torch.float32)
        return y.to(acc) + self.bias.to(x.dtype).to(acc)[:, None, None]


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(dtype=...)`` as XLA runs it on a convolution's
    unrounded f32 output ``y``: the statistics of ``y`` rounded to ``dtype``
    (fast variance, each mean a sum times the reciprocal of the count), then
    ``(y - mean) * (rsqrt(var + eps) * scale) + bias`` in f32, rounded to
    ``dtype``."""

    def forward(self, y, dtype):
        B, C = y.shape[:2]
        per = C // self.num_groups
        yr = y.to(dtype).to(y.dtype).reshape(B, self.num_groups, -1)
        inv_n = 1.0 / yr.shape[-1]
        mean = yr.sum(-1) * inv_n
        var = torch.clamp((yr * yr).sum(-1) * inv_n - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(per, 1) * self.weight
        out = (y - mean.repeat_interleave(per, 1)[..., None, None]) * mul[..., None, None]
        return (out + self.bias[:, None, None]).to(dtype)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = Conv2d(cin, cout, 3, padding=1)
        self.GroupNorm_0 = GroupNorm(min(8, cout), cout, eps=_FLAX_GN_EPS)

    def forward(self, x):
        return F.relu(self.GroupNorm_0(self.Conv_0(x), x.dtype))


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(cin, cout)
        self.ConvBlock_1 = ConvBlock(cout, cout)

    def forward(self, x):
        return self.ConvBlock_1(self.ConvBlock_0(F.max_pool2d(x, 2, 2)))


class Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(cin, cout)
        self.ConvBlock_1 = ConvBlock(cout, cout)

    def forward(self, x, skip):
        x = F.interpolate(x, size=skip.shape[-2:], mode="nearest")
        return self.ConvBlock_1(self.ConvBlock_0(torch.cat([x, skip.to(x.dtype)], dim=1)))


class Head(nn.Module):
    """Per-level output: features and a sigmoid confidence, both in f32."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.feat = Conv2d(cin, dim, 1)
        self.conf = Conv2d(cin, 1, 1)

    def forward(self, x):
        return self.feat(x).float(), torch.sigmoid(self.conf(x)[:, 0]).float()


class UNetExtractor(nn.Module):
    """Encoder-decoder with heads at strides (1, 4, 16).

    Input (B, H, W, 3) floats in [0, 1], H and W multiples of 16. Output
    {"feature_maps": ((B, H, W, 32), (B, H/4, W/4, 128), (B, H/16, W/16, 128)),
    "confidences": ((B, H, W), ...)} in f32."""

    scales = (1, 4, 16)

    def __init__(
        self,
        encoder_dims: Sequence[int] = (32, 64, 128, 256, 256),
        output_dims: Sequence[int] = (32, 128, 128),
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        e = encoder_dims
        self.dtype = dtype
        self.ConvBlock_0 = ConvBlock(3, e[0])
        self.ConvBlock_1 = ConvBlock(e[0], e[0])
        self.Down_0 = Down(e[0], e[1])
        self.Down_1 = Down(e[1], e[2])
        self.Down_2 = Down(e[2], e[3])
        self.Down_3 = Down(e[3], e[4])
        self.head16 = Head(e[4], output_dims[2])
        self.Up_0 = Up(e[4] + e[3], e[3])
        self.Up_1 = Up(e[3] + e[2], e[2])
        self.head4 = Head(e[2], output_dims[1])
        self.Up_2 = Up(e[2] + e[1], e[1])
        self.Up_3 = Up(e[1] + e[0], e[0])
        self.head1 = Head(e[0], output_dims[0])

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2).to(self.dtype) * 2.0 - 1.0
        e0 = self.ConvBlock_1(self.ConvBlock_0(x))
        e1 = self.Down_0(e0)
        e2 = self.Down_1(e1)
        e3 = self.Down_2(e2)
        e4 = self.Down_3(e3)
        f16, c16 = self.head16(e4)
        d2 = self.Up_1(self.Up_0(e4, e3), e2)
        f4, c4 = self.head4(d2)
        d0 = self.Up_3(self.Up_2(d2, e1), e0)
        f1, c1 = self.head1(d0)
        return {
            "feature_maps": tuple(f.permute(0, 2, 3, 1) for f in (f1, f4, f16)),
            "confidences": (c1, c4, c16),
        }


def normalize_features(feat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-pixel L2 normalisation over channels (last axis)."""
    return feat / torch.linalg.norm(feat, dim=-1, keepdim=True).clamp_min(eps)


def unet_state_dict_from_flax(params) -> dict:
    """Flax UNet params (nested dict of numpy, optionally under "params") ->
    a state dict of ``UNetExtractor``: conv kernels HWIO -> OIHW, GroupNorm
    ``scale`` -> ``weight``."""
    if "params" in params:
        params = params["params"]
    out = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
                continue
            t = torch.as_tensor(np.array(v, np.float32))
            if k == "kernel":
                name, t = "weight", t.permute(3, 2, 0, 1).contiguous()
            elif k == "scale":
                name = "weight"
            else:
                name = k
            out[".".join(prefix + [name])] = t

    walk(params, [])
    return out


def flax_tree_from_unet(model: UNetExtractor) -> dict:
    """The inverse of ``unet_state_dict_from_flax``: ``{"params": nested dict
    of numpy}`` with conv kernels OIHW -> HWIO and GroupNorm ``weight`` ->
    ``scale``, as ``UNetExtractor.init`` names them in the JAX package."""
    tree: dict = {}
    for name, p in model.state_dict().items():
        *path, leaf = name.split(".")
        v = p.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf, v = ("kernel", v.transpose(2, 3, 1, 0)) if v.ndim == 4 else ("scale", v)
        d = tree
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = np.ascontiguousarray(v)
    return {"params": tree}


def flax_tree_from_npz(path) -> dict:
    """The nested parameter dict of a checkpoint written by the JAX
    package's ``save_unet_weights`` (a ``__meta__`` JSON list of flax key
    paths plus ``arr_i``), read with numpy alone."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        tree: dict = {}
        for i, keystr in enumerate(meta["keys"]):
            keys = [k.strip("'") for k in keystr.strip("[]").split("][")]
            d = tree
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = np.asarray(data[f"arr_{i}"])
    return tree


def init_unet(generator: Optional[torch.Generator] = None, device=None, **kwargs) -> UNetExtractor:
    """A ``UNetExtractor(**kwargs)`` on ``device`` (None is the CUDA card)
    with flax's default initialisation, as the JAX package's ``init_unet``
    gives it: conv kernels from ``variance_scaling(1.0, "fan_in",
    "truncated_normal")`` (a standard normal cut at +-2, times
    sqrt(1 / fan_in) / 0.87962566, the cut normal's stddev), zero biases,
    GroupNorm weight 1 and bias 0. The draws come from ``generator`` (a CPU
    generator; torch's default one when None): the same distribution as
    JAX's, not its bits."""
    device = resolve(device)
    model = UNetExtractor(**kwargs)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            init_flax_conv_(m, generator)
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return model.to(device)


@torch.no_grad()
def init_flax_conv_(conv: nn.Conv2d, generator: Optional[torch.Generator] = None) -> None:
    """flax's default conv initialisation in place: lecun_normal kernel, zero bias."""
    fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
    nn.init.trunc_normal_(conv.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    conv.weight.mul_(float(np.sqrt(1.0 / fan_in) / _TRUNC_STD))
    nn.init.zeros_(conv.bias)


def load_unet_weights(path, device=None, dtype: torch.dtype = torch.bfloat16) -> UNetExtractor:
    """The UNet of a JAX-package checkpoint, on ``device`` (None is the CUDA card)."""
    device = resolve(device)
    model = UNetExtractor(dtype=dtype)
    model.load_state_dict(unet_state_dict_from_flax(flax_tree_from_npz(path)))
    return model.to(device=device).eval()
