"""The port's SuperPoint (``mapping/superpoint.py``) and ``default_detector``
against the JAX package's, on the CPU, with the shipped candidate weights
(``assets/superpoint_candidate.npz``; its eval JSON says it was not
accepted, which matters for what it detects, not for parity).

Tolerances, and what was measured: detector logits 1e-4 (measured 1.4e-5;
their magnitude reaches ~50), descriptors 1e-5 (1.7e-7); extraction gives
the same keypoint set (300 of 300 at 190 x 150; ``torch.topk``'s tie order
is not ``lax.top_k``'s, so sets and not orders are compared, and the
extraction takes a stable sort, lowest index first as ``lax.top_k``), the
sub-pixel keypoints within 1e-4 px (1.5e-5), scores 1e-5 (1e-6),
descriptors 1e-5 (2.5e-7); checkpoints read across packages exactly.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from pixtrack_tpu.mapping import superpoint as jsp
from pixtrack_tpu.mapping.train_superpoint import load_superpoint_weights as jload
from pixtrack_tpu.mapping.train_superpoint import save_superpoint_weights as jsave
from pixtrack_tpu_torch.mapping import superpoint as tsp

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
CANDIDATE = REPO / "assets" / "superpoint_candidate.npz"
CPU = "cpu"


@pytest.fixture(scope="module")
def candidate():
    return jload(CANDIDATE), tsp.load_superpoint_weights(CANDIDATE, device=CPU)


def _textured(h, w, seed=0):
    """A contrasty smoothed-noise image, rich in corners."""
    rng = np.random.default_rng(seed)
    img = ndi.gaussian_filter(rng.uniform(0, 255, (h, w, 3)), (2, 2, 0))
    return np.clip((img - img.mean()) * 4 + 128, 0, 255).astype(np.uint8)


def _paired(kp, jkp, tol=1e-4):
    """The index of each keypoint's counterpart in ``jkp``; asserts that the
    two are one set (each within ``tol`` px of its counterpart, both ways)."""
    d = np.linalg.norm(np.asarray(kp)[:, None] - np.asarray(jkp)[None], axis=-1)
    nn = d.argmin(axis=1)
    assert len(kp) == len(jkp) and sorted(nn) == list(range(len(jkp))), "not the same keypoint set"
    assert d[np.arange(len(kp)), nn].max() <= tol
    return nn


def test_net_matches_flax(candidate):
    jparams, net = candidate
    img = _textured(184, 144)
    x = ((img.astype(np.float32) / 255) @ np.array([0.299, 0.587, 0.114], np.float32))[None, ..., None]
    jdet, jdesc = jsp.SuperPointNet().apply(jparams, x)
    with torch.no_grad():
        det, desc = net(torch.from_numpy(x))
    assert det.shape == (1, 23, 18, 65) and desc.shape == (1, 23, 18, 256)
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), atol=1e-4)
    np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), atol=1e-5)
    np.testing.assert_allclose(tsp.dense_scores(det).numpy(), np.asarray(jsp.dense_scores(jdet)), atol=1e-6)


@pytest.mark.parametrize("nms_radius,subpixel", [(2, True), (4, False)])
def test_extraction_matches_jax(candidate, nms_radius, subpixel):
    jparams, net = candidate
    img = _textured(190, 150, seed=1)
    jkp, jsc, jd = jsp.extract_superpoint(jparams, img, max_keypoints=300, nms_radius=nms_radius, subpixel=subpixel)
    kp, sc, d = tsp.extract_superpoint(net, img, max_keypoints=300, nms_radius=nms_radius, subpixel=subpixel)
    assert len(jkp) > 100
    nn = _paired(kp, jkp)
    np.testing.assert_allclose(sc, jsc[nn], atol=1e-5)
    np.testing.assert_allclose(d, jd[nn], atol=1e-5)


def test_describe_at_matches_jax(candidate):
    jparams, net = candidate
    img = _textured(100, 90, seed=2)
    kp = np.random.default_rng(3).uniform(8, 80, (40, 2)).astype(np.float32)
    np.testing.assert_allclose(tsp.describe_at(net, img, kp), jsp.describe_at(jparams, img, kp), atol=1e-5)


def test_checkpoints_read_across_packages(tmp_path, candidate):
    jparams, net = candidate
    tsp.save_superpoint_weights(tmp_path / "port.npz", net)
    back = jload(tmp_path / "port.npz")
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _, fresh = jsp.init_superpoint(jax.random.PRNGKey(4))
    jsave(tmp_path / "jax.npz", fresh)
    net2 = tsp.load_superpoint_weights(tmp_path / "jax.npz", device=CPU)
    np.testing.assert_array_equal(net2.convDb.weight.detach().numpy(),
                                  np.asarray(fresh["params"]["Conv_1"]["kernel"]).transpose(3, 2, 0, 1))


def test_port_torch_weights_is_a_checked_load(candidate):
    """A public state_dict (``conv1a.weight`` ...) loads as it is; a missing
    or misshapen entry raises."""
    _, net = candidate
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    again = tsp.port_torch_weights(state, device=CPU)
    for k, v in again.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    with pytest.raises(RuntimeError):
        tsp.port_torch_weights({k: v for k, v in state.items() if k != "convPb.bias"}, device=CPU)
    with pytest.raises(RuntimeError):
        tsp.port_torch_weights({**state, "convDb.weight": state["convDb.weight"][:128]}, device=CPU)


class TestSuperPointArch:
    def test_shapes_and_extraction(self):
        net = tsp.init_superpoint(torch.Generator().manual_seed(0), device=CPU)
        img = np.random.default_rng(0).uniform(size=(64, 64)).astype(np.float32)
        kp, scores, desc = tsp.extract_superpoint(net, img, max_keypoints=128, threshold=0.0)
        assert kp.shape[1] == 2
        assert desc.shape[1] == 256
        np.testing.assert_allclose(np.linalg.norm(desc, axis=1), 1.0, atol=1e-4)


class TestDefaultDetector:
    def test_env_override_and_absence(self, tmp_path, monkeypatch):
        """default_detector resolves the checkpoint (or its environment
        override) into a detect_and_describe-contract callable."""
        from pixtrack_tpu_torch.mapping import default_detector

        monkeypatch.setenv("PIXTRACK_SUPERPOINT_WEIGHTS", str(tmp_path / "missing.npz"))
        assert default_detector(device=CPU) is None

        tsp.save_superpoint_weights(tmp_path / "sp.npz", tsp.init_superpoint(torch.Generator().manual_seed(0),
                                                                             device=CPU))
        monkeypatch.setenv("PIXTRACK_SUPERPOINT_WEIGHTS", str(tmp_path / "sp.npz"))
        det = default_detector(max_keypoints=64, device=CPU)
        assert det is not None and det.desc_dim == 256 and det.name == "superpoint"
        img = np.random.default_rng(0).uniform(0, 255, (96, 96, 3)).astype(np.uint8)
        # Harris-specific kwargs must be absorbed, not crash SuperPoint
        kp, scores, desc = det(img, nms_radius=1)
        assert kp.shape[1] == 2 and desc.shape[1] == 256
        assert len(kp) == len(scores) == len(desc) <= 64

    def test_candidate_weights_through_the_override(self, monkeypatch, candidate):
        """PIXTRACK_SUPERPOINT_WEIGHTS=assets/superpoint_candidate.npz: the
        same keypoints as the JAX package's default_detector."""
        from pixtrack_tpu.mapping import default_detector as jdefault
        from pixtrack_tpu_torch.mapping import default_detector

        monkeypatch.setenv("PIXTRACK_SUPERPOINT_WEIGHTS", str(CANDIDATE))
        img = _textured(128, 128, seed=5)
        kp, _, d = default_detector(max_keypoints=128, device=CPU)(img, nms_radius=1)
        jkp, _, jd = jdefault(max_keypoints=128)(img, nms_radius=1)
        assert len(jkp) > 20
        np.testing.assert_allclose(d, jd[_paired(kp, jkp)], atol=1e-5)
