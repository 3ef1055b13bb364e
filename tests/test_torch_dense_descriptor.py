"""The port's dense descriptor (``mapping/dense_descriptor.py``) and its
held-out mesh-pair bank (``mapping/train_matcher.py``) against the JAX
package's, on the CPU.

Tolerances, and what was measured: the net's output with the shipped
weights at 1e-5 (measured 4.9e-7 at 190 x 150, where c2 is 95 x 75 and c3
47 x 37, so the upsampling is not an exact 2x; 5.7e-7 at 121 x 77);
``describe_at_dense`` at 1e-5 (measured 4.5e-7); checkpoints read across
packages exactly. The one-scene bank: the same pairs and angles (1e-5), and
keypoints and ground truth equal except where a render pixel flips: the
look-at translations part by an ulp (5.96e-8), which moved one pixel of one
of 8 views at 160 px and with it a few of that view's keypoints (measured:
99.7 % of the ground-truth entries equal, 2 of 16 pairs with any keypoint
apart); the gates are 98 % and 4 of 16.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pixtrack_tpu.mapping import dense_descriptor as jdd
from pixtrack_tpu.mapping.train_matcher import build_mesh_pair_bank as jbank
from pixtrack_tpu_torch.mapping import dense_descriptor as tdd
from pixtrack_tpu_torch.mapping.train_matcher import build_mesh_pair_bank

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
WEIGHTS = REPO / "assets" / "dense_descriptor.npz"
CPU = "cpu"


@pytest.fixture(scope="module")
def shipped():
    _, jparams = jdd.load_descriptor_weights(WEIGHTS)
    return jparams, tdd.load_descriptor_weights(WEIGHTS, device=CPU)


class TestNet:
    def test_output_contract(self):
        net = tdd.init_descriptor(torch.Generator().manual_seed(0), device=CPU)
        x = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
        with torch.no_grad():
            d = net(torch.from_numpy(x)).numpy()
        assert d.shape == (2, 32, 32, 128)
        assert np.allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)

    def test_photometric_invariance_of_standardization(self):
        """A global gain / offset does not move the descriptors."""
        net = tdd.init_descriptor(torch.Generator().manual_seed(0), device=CPU)
        x = torch.from_numpy(np.random.default_rng(1).uniform(size=(1, 64, 64, 3)).astype(np.float32))
        with torch.no_grad():
            assert (net(x) - net(0.5 * x + 0.2)).abs().max() < 1e-3

    def test_save_load_describe_roundtrip(self, tmp_path):
        net = tdd.init_descriptor(torch.Generator().manual_seed(1), device=CPU)
        img = np.random.default_rng(2).uniform(0, 255, (96, 96, 3)).astype(np.uint8)
        kp = np.array([[10.0, 12.0], [50.5, 30.25], [80.0, 90.0]])
        d = tdd.describe_at_dense(net, img, kp)
        assert d.shape == (3, 128)
        tdd.save_descriptor_weights(tmp_path / "w.npz", net)
        assert np.allclose(d, tdd.describe_at_dense(tdd.load_descriptor_weights(tmp_path / "w.npz", device=CPU),
                                                    img, kp), atol=1e-5)

    def test_init_distribution_is_flax(self):
        """flax's lecun-normal kernels (std sqrt(1 / fan_in)) and zero biases."""
        net = tdd.init_descriptor(torch.Generator().manual_seed(0), device=CPU)
        w = net.Conv_6.weight.detach().numpy()
        assert abs(w.std() * np.sqrt(9 * 192) - 1.0) < 0.05 and np.abs(w).max() <= 2 / np.sqrt(9 * 192) / 0.8796 + 1e-6
        assert all(float(c.bias.detach().abs().max()) == 0.0 for c in net.convs())


@pytest.mark.parametrize("size", [(190, 150), (121, 77)], ids=["odd-half", "odd"])
def test_net_matches_flax_with_the_shipped_weights(shipped, size):
    jparams, net = shipped
    H, W = size
    x = np.random.default_rng(3).uniform(size=(1, H - H % 2, W - W % 2, 3)).astype(np.float32)
    ref = np.asarray(jdd.DenseDescriptorNet().apply(jparams, x))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, H // 2, W // 2, 128)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_describe_at_dense_matches_jax(shipped):
    jparams, net = shipped
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (190, 150, 3)).astype(np.uint8)
    kp = rng.uniform(0, [149, 189], (64, 2)).astype(np.float32)
    np.testing.assert_allclose(tdd.describe_at_dense(net, img, kp), jdd.describe_at_dense(jparams, img, kp),
                               atol=1e-5)
    grey = img[..., 0]  # a single-channel image is replicated to three
    np.testing.assert_allclose(tdd.describe_at_dense(net, grey, kp), jdd.describe_at_dense(jparams, grey, kp),
                               atol=1e-5)


def test_checkpoints_read_across_packages(tmp_path, shipped):
    """The port reads the JAX package's file (the shipped one, above) and the
    JAX package reads the port's, with the same keys and arrays."""
    jparams, net = shipped
    tdd.save_descriptor_weights(tmp_path / "port.npz", net)
    _, back = jdd.load_descriptor_weights(tmp_path / "port.npz")
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    z0, z1 = np.load(WEIGHTS), np.load(tmp_path / "port.npz")
    assert sorted(z0.files) == sorted(z1.files)


def test_default_descriptor(tmp_path, monkeypatch):
    from pixtrack_tpu.mapping import default_descriptor as jdefault
    from pixtrack_tpu_torch.mapping import default_descriptor

    monkeypatch.setenv("PIXTRACK_DENSE_DESCRIPTOR_WEIGHTS", str(tmp_path / "missing.npz"))
    assert default_descriptor(device=CPU) is None
    monkeypatch.delenv("PIXTRACK_DENSE_DESCRIPTOR_WEIGHTS")
    det, jdet = default_descriptor(max_keypoints=128, device=CPU), jdefault(max_keypoints=128)
    assert (det.desc_dim, det.name, det.match_kw) == (jdet.desc_dim, jdet.name, jdet.match_kw) == (
        128, "harris+dense", dict(min_score=0.1, ratio=0.98))
    img = np.random.default_rng(5).uniform(0, 255, (96, 96, 3)).astype(np.uint8)
    kp, sc, d = det(img, nms_radius=1)
    jkp, jsc, jd = jdet(img, nms_radius=1)
    np.testing.assert_allclose(kp.numpy(), np.asarray(jkp), atol=1e-4)
    np.testing.assert_allclose(d, jd, atol=1e-5)


def test_mesh_pair_bank_matches_jax(tmp_path):
    kw = dict(n_scenes=1, n_views=8, res=160, max_kp=128, min_deg=20.0, max_deg=52.0, seed=31)
    ref = jbank(tmp_path / "jax", **kw)
    got = build_mesh_pair_bank(tmp_path / "port", device=CPU, **kw)
    assert got["gt"].shape == ref["gt"].shape and len(ref["gt"]) >= 8
    np.testing.assert_allclose(got["angle_deg"], ref["angle_deg"], atol=1e-5)
    np.testing.assert_array_equal(got["valid0"], ref["valid0"])
    np.testing.assert_array_equal(got["valid1"], ref["valid1"])
    assert (got["gt"] == ref["gt"]).mean() >= 0.98
    apart = [p for p in range(len(ref["gt"])) if np.abs(got["kpn0"][p] - ref["kpn0"][p]).max() > 1e-4]
    assert len(apart) <= 4, apart
    same = [p for p in range(len(ref["gt"])) if p not in apart]
    np.testing.assert_allclose(got["desc0"][same], ref["desc0"][same], atol=1e-4)
