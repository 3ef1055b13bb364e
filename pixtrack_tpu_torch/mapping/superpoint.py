"""SuperPoint detector / descriptor, at inference.

Port of ``pixtrack_tpu/mapping/superpoint.py`` and of
``load_superpoint_weights`` / ``save_superpoint_weights``
(``pixtrack_tpu/mapping/train_superpoint.py:519-537``): the VGG-style
shared encoder, the 65-way cell detector head and the 256-d descriptor
head, with the JAX module's layer order (a 2x2 max-pool before its second,
fourth and sixth 3x3 conv). The layers carry the public SuperPoint names
(``conv1a`` ... ``conv4b``, ``convPa``, ``convPb``, ``convDa``,
``convDb``), so a public torch state_dict loads as it is
(``port_torch_weights``), and ``load_superpoint_weights`` maps the JAX
package's flax paths (``params/_VGGBlock_i/Conv_0``, ``Conv_0``,
``Conv_1``: the layout of ``assets/superpoint_candidate.npz``) onto them
through ``superpoint_from_flax``.
Outputs keep the (keypoints, scores, descriptors) contract of
``mapping/detector.py``.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pixtrack_tpu_torch._device import resolve, true_f32

_TORCH_LAYER_ORDER = ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b"]
# (output channels, max-pool before the conv) of the eight encoder convs
_ENCODER = [(64, False), (64, True), (64, False), (64, True), (128, False), (128, True), (128, False),
            (128, False)]
# the JAX package's flax path of each layer
_FLAX_PATH = {**{name: f"_VGGBlock_{i}/Conv_0" for i, name in enumerate(_TORCH_LAYER_ORDER)},
              "convPa": "_VGGBlock_8/Conv_0", "convPb": "Conv_0", "convDa": "_VGGBlock_9/Conv_0",
              "convDb": "Conv_1"}
_GREY = (0.299, 0.587, 0.114)


class SuperPointNet(nn.Module):
    """Encoder + detector head (65 = 8x8 cell + dustbin) + descriptor head."""

    def __init__(self, descriptor_dim: int = 256):
        super().__init__()
        cin = 1
        for name, (cout, _) in zip(_TORCH_LAYER_ORDER, _ENCODER):
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
            cin = cout
        self.convPa = nn.Conv2d(128, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDa = nn.Conv2d(128, 256, 3, padding=1)
        self.convDb = nn.Conv2d(256, descriptor_dim, 1)

    def forward(self, image: torch.Tensor):
        """image (B, H, W, 1) greyscale in [0, 1], H and W multiples of 8;
        returns det (B, H/8, W/8, 65) logits and desc (B, H/8, W/8, D) unit
        rows (channels last, as the JAX module)."""
        x = image.permute(0, 3, 1, 2)
        for name, (_, pool) in zip(_TORCH_LAYER_ORDER, _ENCODER):
            if pool:
                x = F.max_pool2d(x, 2)
            x = F.relu(getattr(self, name)(x))
        det = self.convPb(F.relu(self.convPa(x))).permute(0, 2, 3, 1)
        desc = self.convDb(F.relu(self.convDa(x))).permute(0, 2, 3, 1)
        return det, desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-8)


def dense_scores(det_logits: torch.Tensor) -> torch.Tensor:
    """(B, Hc, Wc, 65) logits -> (B, H, W) per-pixel keypoint probability."""
    prob = torch.softmax(det_logits, dim=-1)[..., :64]  # drop the dustbin
    B, Hc, Wc, _ = prob.shape
    return prob.reshape(B, Hc, Wc, 8, 8).permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)


def _grey(image, device) -> torch.Tensor:
    img = torch.as_tensor(np.asarray(image))
    img = img.to(torch.float32) / 255.0 if img.dtype == torch.uint8 else img.to(torch.float32)
    img = img.to(device)
    if img.ndim == 3:
        img = img @ torch.tensor(_GREY, dtype=torch.float32, device=device)
    return img


def _sample_descriptors(desc: torch.Tensor, kp: torch.Tensor) -> np.ndarray:
    """The 1/8-resolution descriptor map sampled bilinearly at full-resolution
    keypoints, as unit rows."""
    from pixtrack_tpu_torch.align.interpolate import interpolate_features

    d, _, _ = interpolate_features(desc, kp / 8.0 - 0.5, compute_grad=False)
    d = d.cpu().numpy()
    return d / np.linalg.norm(d, axis=1, keepdims=True).clip(1e-8)


def extract_superpoint(net: SuperPointNet, image, max_keypoints: int = 1024, nms_radius: int = 4,
                       threshold: float = 0.005, subpixel: bool = True):
    """Full SuperPoint extraction on the net's device: (keypoints (N, 2),
    scores (N,), descriptors (N, D)) as numpy. NMS by a max-pool of the
    dense score map, the top ``max_keypoints`` peaks (ties lowest index
    first, as ``lax.top_k``), above ``threshold``. ``subpixel`` refines each
    peak by a quadratic fit of the raw score map over its 3x3 neighbourhood,
    with the JAX module's flat-index clipping and its interior mask."""
    device = next(net.parameters()).device
    img = _grey(image, device)
    H, W = img.shape
    H8, W8 = H - H % 8, W - W % 8
    with torch.no_grad(), true_f32():
        det, desc = net(img[None, :H8, :W8, None])
        scores_raw = dense_scores(det)[0]
        r = nms_radius
        pooled = F.max_pool2d(scores_raw[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
        scores = torch.where(scores_raw >= pooled, scores_raw, torch.zeros_like(scores_raw))
        vals, idx = torch.sort(scores.reshape(-1), descending=True, stable=True)
        vals, idx = vals[:max_keypoints], idx[:max_keypoints]
        kp = torch.stack([idx % W8, idx // W8], dim=-1).to(torch.float32)
        if subpixel:
            raw = scores_raw.reshape(-1)

            def at(dy, dx):
                return raw[torch.clamp(idx + dy * W8 + dx, 0, H8 * W8 - 1)]

            gx = 0.5 * (at(0, 1) - at(0, -1))
            gy = 0.5 * (at(1, 0) - at(-1, 0))
            hxx = at(0, 1) - 2.0 * at(0, 0) + at(0, -1)
            hyy = at(1, 0) - 2.0 * at(0, 0) + at(-1, 0)
            hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
            den = hxx * hyy - hxy * hxy
            safe = den.abs() > 1e-18
            den = torch.where(safe, den, torch.ones_like(den))
            dx = -(hyy * gx - hxy * gy) / den
            dy = -(hxx * gy - hxy * gx) / den
            # the 3x3 reads clip the flat index, so a border peak's dx = +-1
            # neighbours wrap into the next row: no refinement there
            px, py = idx % W8, idx // W8
            interior = (px > 0) & (px < W8 - 1) & (py > 0) & (py < H8 - 1)
            ok = safe & interior & (dx.abs() < 1.0) & (dy.abs() < 1.0)
            zero = torch.zeros_like(dx)
            off = torch.stack([torch.where(ok, dx, zero), torch.where(ok, dy, zero)], dim=-1)
            kp = kp + off.clamp(-0.6, 0.6)
        keep = vals > threshold
        kp, vals = kp[keep], vals[keep]
        d = _sample_descriptors(desc[0], kp)
    return kp.cpu().numpy(), vals.cpu().numpy(), d


def describe_at(net: SuperPointNet, image, kp) -> np.ndarray:
    """Sample the SuperPoint descriptor map at GIVEN keypoints (N, 2) xy:
    decoupled description at any detector's keypoints."""
    device = next(net.parameters()).device
    img = _grey(image, device)
    H, W = img.shape
    with torch.no_grad(), true_f32():
        _, desc = net(img[None, : H - H % 8, : W - W % 8, None])
        return _sample_descriptors(desc[0], torch.as_tensor(np.asarray(kp), dtype=torch.float32, device=device))


def init_superpoint(generator: Optional[torch.Generator] = None, device=None) -> SuperPointNet:
    """A ``SuperPointNet`` on ``device`` (None is the CUDA card) with flax's
    default initialisation, drawn from ``generator``: the JAX package's
    distribution, not its bits."""
    from pixtrack_tpu_torch.features.unet import init_flax_conv_

    device = resolve(device)
    net = SuperPointNet()
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            init_flax_conv_(m, generator)
    return net.to(device).eval()


def port_torch_weights(state_dict, device=None) -> SuperPointNet:
    """A ``SuperPointNet`` holding a public SuperPoint state_dict (tensors or
    numpy arrays), checked key by key and shape by shape."""
    device = resolve(device)
    net = SuperPointNet()
    net.load_state_dict({k: torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v))
                         for k, v in state_dict.items()}, strict=True)
    return net.to(device).eval()


def save_superpoint_weights(path, net: SuperPointNet) -> None:
    """The JAX package's checkpoint format: flax paths joined by "/" (kernels
    (kh, kw, in, out)) and a ``__meta__`` JSON with the key list."""
    arrays = {}
    for name, flax in _FLAX_PATH.items():
        conv = getattr(net, name)
        arrays[f"params/{flax}/kernel"] = conv.weight.detach().permute(2, 3, 1, 0).cpu().numpy()
        arrays[f"params/{flax}/bias"] = conv.bias.detach().cpu().numpy()
    np.savez(path, __meta__=json.dumps({"keys": list(arrays)}), **arrays)


def superpoint_from_flax(arrays: dict, device=None) -> SuperPointNet:
    """A ``SuperPointNet`` on ``device`` (None is the CUDA card) from a flat
    dict of numpy arrays keyed ``params/<flax path>/kernel|bias`` (the JAX
    package's ``flatten_dict`` of its parameters, joined by "/"), every key
    used and no other allowed."""
    keys = set(arrays)
    state = {}
    for name, flax in _FLAX_PATH.items():
        kernel, bias = f"params/{flax}/kernel", f"params/{flax}/bias"
        state[f"{name}.weight"] = np.ascontiguousarray(np.asarray(arrays[kernel]).transpose(3, 2, 0, 1))
        state[f"{name}.bias"] = np.asarray(arrays[bias])
        keys -= {kernel, bias}
    if keys:
        raise ValueError(f"unexpected SuperPoint keys: {sorted(keys)}")
    return port_torch_weights(state, device=device)


def load_superpoint_weights(path, device=None) -> SuperPointNet:
    """A checkpoint of either package (``assets/superpoint_candidate.npz``'s
    layout), on ``device`` (None is the CUDA card)."""
    data = np.load(path, allow_pickle=False)
    return superpoint_from_flax({k: data[k] for k in json.loads(str(data["__meta__"]))["keys"]}, device=device)
