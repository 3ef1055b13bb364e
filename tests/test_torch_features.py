"""Parity of the PyTorch UNet and feature extractor with the JAX package.

Tolerances: in f32 on both sides, 1e-4 on features and confidences (the
convolutions sum in another order); in bf16, where both sides round every
activation to 8 bits of mantissa at different points, 0.1 on any value and
2e-2 on the mean; the antialiased resize, 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pixtrack_tpu.features.extractor import FeatureExtractor as JExtractor
from pixtrack_tpu.features.train import load_unet_weights as jload_unet
from pixtrack_tpu.features.unet import UNetExtractor as JUNet
from pixtrack_tpu.features.unet import init_unet
from pixtrack_tpu_torch.features.extractor import FeatureExtractor
from pixtrack_tpu_torch.features.unet import (
    UNetExtractor,
    flax_tree_from_npz,
    load_unet_weights,
    unet_state_dict_from_flax,
)

torch.set_num_threads(2)
WEIGHTS = Path(__file__).resolve().parents[1] / "assets" / "unet_basin.npz"


def _image(H=64, W=64, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    # smooth it so features are not pure noise
    from scipy.ndimage import gaussian_filter

    return np.clip(gaussian_filter(img, (2, 2, 0)) * 1.5 - 0.25, 0, 1).astype(np.float32)


def _compare(pj, pt, atol, mean_tol=None):
    for a, b in zip(list(pj["feature_maps"]) + list(pj["confidences"]),
                    list(pt["feature_maps"]) + list(pt["confidences"])):
        a, b = np.asarray(a), b.detach().float().numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)
        if mean_tol is not None:
            assert np.abs(a - b).mean() <= mean_tol


@pytest.fixture(scope="module")
def jax_params():
    return jload_unet(WEIGHTS)[1]


def test_unet_f32_shipped_weights(jax_params):
    img = _image()
    pj = JUNet(dtype=jnp.float32).apply(jax_params, jnp.asarray(img)[None])
    model = load_unet_weights(WEIGHTS, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        pt = model(torch.as_tensor(img)[None])
    _compare(pj, pt, atol=1e-4)


def test_unet_bf16_shipped_weights(jax_params):
    img = _image(seed=1)
    pj = JUNet().apply(jax_params, jnp.asarray(img)[None])
    model = load_unet_weights(WEIGHTS, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        pt = model(torch.as_tensor(img)[None])
    _compare(pj, pt, atol=0.1, mean_tol=2e-2)


def test_unet_random_flax_init_converts():
    """Weight conversion from freshly initialised flax parameters."""
    model_j, params = init_unet(jax.random.PRNGKey(7), 32, 32, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = UNetExtractor(dtype=torch.float32)
    sd = unet_state_dict_from_flax(tree)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    img = _image(32, 32, seed=2)
    with torch.no_grad():
        pt = model(torch.as_tensor(img)[None])
    _compare(model_j.apply(params, jnp.asarray(img)[None]), pt, atol=1e-4)
    # the npz reader yields the same tree as the JAX loader
    flat = flax_tree_from_npz(WEIGHTS)["params"]["Up_1"]["ConvBlock_0"]["Conv_0"]["kernel"]
    assert flat.shape == (3, 3, 384, 128)


def test_antialiased_resize_matches_jax_linear():
    img = np.random.default_rng(3).uniform(0, 1, (480, 640, 3)).astype(np.float32)
    a = np.asarray(jax.image.resize(jnp.asarray(img), (192, 256, 3), method="linear"))
    b = F.interpolate(torch.as_tensor(img).permute(2, 0, 1)[None], size=(192, 256), mode="bilinear",
                      antialias=True, align_corners=False)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_extractor_resize_policy_and_pyramid(jax_params):
    """Image scale 4 sends a 96x128 query to 64x48 (target 1024 // 4 = 256
    with resize=256): levels, (sx, sy) scales and values all match."""
    img = _image(96, 128, seed=4)
    je = JExtractor(JUNet(dtype=jnp.float32), params=jax_params, resize=256)
    te = FeatureExtractor(load_unet_weights(WEIGHTS, device="cpu", dtype=torch.float32), resize=256)
    for scale in (4, 1):
        pj = je(img, image_scale=scale)
        pt = te(img, image_scale=scale)
        assert pj.scales == pt.scales
        for a, b in zip(pj.levels + pj.confidences, pt.levels + pt.confidences):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4)
