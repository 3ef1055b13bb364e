"""Half-resolution dense descriptor, at inference.

Port of ``pixtrack_tpu/mapping/dense_descriptor.py`` (45-121): the net, its
initialisation, its checkpoint in the JAX package's npz format, and
``describe_at_dense`` (decoupled description: the production Harris
keypoints, the learned descriptors sampled bilinearly at them). The
training bank and the trainer are not ported yet.

The net: per-image standardisation (population std), a three-stage
encoder, c3 upsampled to c2's size (bilinear, half-pixel centres, the edge
sample repeated: what ``jax.image.resize(..., "linear")`` gives when it
upsamples, also at odd sizes where c2 is not twice c3), a skip from c2, and
an L2-normalised 128-d head at half resolution. Layers keep flax's names
(``Conv_0`` ... ``Conv_7``) so that the checkpoint maps one to one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve, true_f32

_CHANNELS = ((3, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (192, 128), (128, None))


class DenseDescriptorNet(nn.Module):
    """Encoder with a stride-2 descriptor head fed by a full-res skip."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.dim = dim
        for i, (cin, cout) in enumerate(_CHANNELS):
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, cout or dim, 3, padding=1))

    def convs(self):
        return [getattr(self, f"Conv_{i}") for i in range(len(_CHANNELS))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) float; returns (B, H/2, W/2, dim) L2-normalised
        (the JAX module's layout, channels last)."""
        c = self.convs()
        mu = x.mean(dim=(1, 2, 3), keepdim=True)
        sd = x.std(dim=(1, 2, 3), keepdim=True, correction=0)
        x = ((x - mu) / sd.clamp_min(1e-5)).permute(0, 3, 1, 2)
        c1 = F.relu(c[1](F.relu(c[0](x))))
        c2 = F.relu(c[3](F.relu(c[2](F.max_pool2d(c1, 2)))))
        c3 = F.relu(c[5](F.relu(c[4](F.max_pool2d(c2, 2)))))
        u = F.interpolate(c3, size=c2.shape[-2:], mode="bilinear", align_corners=False)
        h = F.relu(c[6](torch.cat([u, c2], dim=1)))
        d = c[7](h).permute(0, 2, 3, 1)
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)


def _flax_key(i: int, leaf: str) -> str:
    return f"['params']['Conv_{i}']['{leaf}']"


def init_descriptor(generator: Optional[torch.Generator] = None, device=None) -> DenseDescriptorNet:
    """A ``DenseDescriptorNet`` on ``device`` (None is the CUDA card) with
    flax's default initialisation (lecun-normal kernels, zero biases), drawn
    from ``generator``: the JAX package's distribution, not its bits."""
    from pixtrack_tpu_torch.features.unet import init_flax_conv_

    device = resolve(device)
    net = DenseDescriptorNet()
    for conv in net.convs():
        init_flax_conv_(conv, generator)
    return net.to(device).eval()


def save_descriptor_weights(path, net: DenseDescriptorNet) -> None:
    """The JAX package's checkpoint: one array per flax key path
    (``"['params']['Conv_0']['kernel']"``, kernels (kh, kw, in, out))."""
    flat = {}
    for i, conv in enumerate(net.convs()):
        flat[_flax_key(i, "bias")] = conv.bias.detach().cpu().numpy()
        flat[_flax_key(i, "kernel")] = conv.weight.detach().permute(2, 3, 1, 0).cpu().numpy()
    np.savez(path, **flat)


def load_descriptor_weights(path, device=None) -> DenseDescriptorNet:
    """A checkpoint of either package, on ``device`` (None is the CUDA card)."""
    device = resolve(device)
    z = np.load(path)
    net = DenseDescriptorNet()
    with torch.no_grad():
        for i, conv in enumerate(net.convs()):
            kernel, bias = z[_flax_key(i, "kernel")], z[_flax_key(i, "bias")]
            if kernel.shape != tuple(conv.weight.permute(2, 3, 1, 0).shape):
                raise ValueError(f"{path}: Conv_{i}'s kernel is {kernel.shape}")
            conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
            conv.bias.copy_(torch.from_numpy(bias))
    return net.to(device).eval()


def _as_rgb(image, device) -> torch.Tensor:
    img = torch.as_tensor(np.asarray(image))
    img = img.to(torch.float32) / 255.0 if img.dtype == torch.uint8 else img.to(torch.float32)
    if img.ndim == 2:
        img = img[..., None].expand(*img.shape, 3)
    return img.to(device)


def describe_at_dense(net: DenseDescriptorNet, image, kp) -> np.ndarray:
    """Sample the learned dense descriptor map at GIVEN keypoints (N, 2) xy,
    full-resolution pixel coordinates; (N, dim) unit rows. The net runs on
    its own device in true f32; the map's centres sit at 2x + 0.5."""
    from pixtrack_tpu_torch.align.interpolate import interpolate_features

    device = next(net.parameters()).device
    img = _as_rgb(image, device)
    H, W = img.shape[:2]
    with torch.no_grad(), true_f32():
        dmap = net(img[None, : H - H % 2, : W - W % 2])[0]
        pts = torch.as_tensor(np.asarray(kp), dtype=torch.float32, device=device) / 2.0 - 0.25
        d, _, _ = interpolate_features(dmap, pts, compute_grad=False)
    d = d.cpu().numpy()
    return d / np.linalg.norm(d, axis=1, keepdims=True).clip(1e-8)
