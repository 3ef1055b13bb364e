"""Parity of the PyTorch UNet and feature extractor with the JAX package.

Tolerances: in f32 on both sides, 1e-4 on features and confidences (the
convolutions sum in another order); in bf16, where both sides round every
activation to 8 bits of mantissa at different points, 0.1 on any value and
2e-2 on the mean; the antialiased resize, 1e-5; the handcrafted extractor
(Gaussian blurs as two depthwise convolutions, written-out gradients), 1e-5
on every level and confidence map.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pixtrack_tpu.features import handcrafted as jhand
from pixtrack_tpu.features.extractor import FeatureExtractor as JExtractor
from pixtrack_tpu.features.train import load_unet_weights as jload_unet
from pixtrack_tpu.features.unet import UNetExtractor as JUNet
from pixtrack_tpu.features.unet import init_unet
from pixtrack_tpu_torch.features import handcrafted as thand
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
    """Against XLA's compiled bf16 UNet (the trackers jit it), whose roundings
    the port takes: measured max 0.0625 (one bf16 ulp at 8-16), mean at most
    2.1e-3, and 74-87 % of the feature values bit-equal (1-4 % when every op
    rounds, scripts_dev/unet_bf16_rounding.py)."""
    img = _image(seed=1)
    pj = jax.jit(JUNet().apply)(jax_params, jnp.asarray(img)[None])
    model = load_unet_weights(WEIGHTS, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        pt = model(torch.as_tensor(img)[None])
    _compare(pj, pt, atol=0.07, mean_tol=2.5e-3)
    for a, b in zip(pj["feature_maps"], pt["feature_maps"]):
        assert np.mean(np.asarray(a) == b.float().numpy()) >= 0.7


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


@pytest.mark.parametrize("shape,sigma", [((40, 56), 1.0), ((40, 56, 3), 2.828), ((17, 23, 4), 0.66), ((30, 30), 9.6)])
def test_gaussian_blur_matches(shape, sigma):
    """Edge padding and kernel radius as the JAX blur, also where the kernel
    is wider than the image; 1e-5."""
    img = np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32)
    a = np.asarray(jhand.gaussian_blur(jnp.asarray(img), sigma))
    b = thand.gaussian_blur(torch.as_tensor(img), sigma)
    assert tuple(b.shape) == shape
    np.testing.assert_allclose(a, b.numpy(), atol=1e-5)


def test_gradient_is_numpy_gradient_at_the_edges():
    """Central differences inside, one-sided at the borders: jnp.gradient,
    np.gradient and torch.gradient all agree with the written-out form."""
    img = np.random.default_rng(6).normal(size=(9, 13)).astype(np.float32)
    for axis in (0, 1):
        g = thand._gradient(torch.as_tensor(img), axis).numpy()
        np.testing.assert_allclose(g, np.gradient(img, axis=axis), atol=1e-6)
        np.testing.assert_allclose(g, np.asarray(jnp.gradient(jnp.asarray(img), axis=axis)), atol=1e-6)
        np.testing.assert_allclose(g, torch.gradient(torch.as_tensor(img), dim=axis)[0].numpy(), atol=1e-6)
        np.testing.assert_array_equal(g[(0, -1), :] if axis == 0 else g[:, (0, -1)].T,
                                      np.stack([np.take(img, 1, axis) - np.take(img, 0, axis),
                                                np.take(img, -1, axis) - np.take(img, -2, axis)]))


@pytest.mark.parametrize("strides", [(1, 4, 16), (1, 2, 8)], ids=["cascade", "per_level"])
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_handcrafted_extractor_matches(strides, gray):
    """Both stride sets (the cascade and the per-level path) on a 96x128 RGB
    and a gray image: levels, scales and confidences within 1e-5."""
    img = _image(96, 128, seed=7)
    if gray:
        img = img[..., 0]
    pj = jhand.HandcraftedExtractor(strides)(jnp.asarray(img))
    pt = thand.HandcraftedExtractor(strides, device="cpu")(torch.as_tensor(img))
    assert pj.scales == pt.scales and pt.num_levels == 3
    for a, b in zip(pj.levels + pj.confidences, pt.levels + pt.confidences):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5)
    assert pt.levels[0].shape[-1] == (8 if gray else 11)


def test_feature_extractor_over_handcrafted_matches():
    """The FeatureExtractor wrapper over the handcrafted model: resize policy
    (image_scale 2 of a 96x128 image at resize=128 -> 48x64), L2
    normalisation and scales; 1e-5. uint8 input is scaled to [0, 1]."""
    img = (_image(96, 128, seed=8) * 255).astype(np.uint8)
    je = JExtractor(jhand.HandcraftedExtractor(), resize=128)
    te = FeatureExtractor(thand.HandcraftedExtractor(device="cpu"), resize=128)
    assert te.device.type == "cpu" and te.scales == (1, 4, 16)
    for scale in (2, 1):
        pj, pt = je(img, image_scale=scale), te(img, image_scale=scale)
        assert pj.scales == pt.scales
        for a, b in zip(pj.levels + pj.confidences, pt.levels + pt.confidences):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5)


def test_default_extractor_falls_back_to_handcrafted(monkeypatch, tmp_path):
    """With no checkpoint at the configured path both packages hand back the
    handcrafted pyramid; with it, the UNet."""
    from pixtrack_tpu import features as jfeatures
    from pixtrack_tpu_torch import features as tfeatures

    monkeypatch.setenv("PIXTRACK_UNET_WEIGHTS", str(tmp_path / "missing.npz"))
    je, te = jfeatures.default_extractor(resize=512), tfeatures.default_extractor(resize=512, device="cpu")
    assert isinstance(je.model, jhand.HandcraftedExtractor) and isinstance(te.model, thand.HandcraftedExtractor)
    assert te.resize == je.resize == 512 and te.device.type == "cpu"
    monkeypatch.delenv("PIXTRACK_UNET_WEIGHTS")
    assert isinstance(tfeatures.default_extractor(device="cpu").model, UNetExtractor)
