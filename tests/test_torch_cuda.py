"""K1's and K2's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are tests/test_fused_mlp.py's: K1 5e-3 on alpha, rgb and depth;
K2 2e-3 on sigma and 5e-3 on rgb; on random production-shape fields and on
the shipped trained ones. Both versions round every product's operands to
bf16 and sum in f32, in another order; K1's plain version places its
samples, angles and direction norms with the kernel's own roundings, and K2
and its plain version take the same positions, so each pair rounds its
activations to bf16 at the same points.
"""

from pathlib import Path


import numpy as np
import pytest
import torch

from pixtrack_tpu_torch.nerf import fused_mlp
from pixtrack_tpu_torch.nerf.distill import init_distilled, load_distilled
from pixtrack_tpu_torch.nerf.render import RenderConfig, _to_grid, ray_aabb_intersect, render_rays

TOL = 5e-3
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _field(octaves, device, seed=0):
    """A random production-shape field with non-zero biases, so the render
    has density and colour to disagree on."""
    field = init_distilled(seed, octaves=octaves, device=device)
    g = torch.Generator().manual_seed(seed)
    for p in field.trunk + [field.head] + field.color:
        p["bias"] += 0.1 * torch.randn(p["bias"].shape, generator=g).to(device)
    return field


def _rays(R, device, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.6
    d = -o + 0.3 * rng.normal(size=(R, 3)).astype(np.float32)
    d[-R // 8:] = -d[-R // 8:]  # misses
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_g, d_g = _to_grid(torch.as_tensor(o, device=device), torch.as_tensor(d, device=device))
    aabb = torch.tensor([[0.25] * 3, [0.75] * 3], device=device)
    tn, tf, hit = ray_aabb_intersect(o_g, d_g, aabb[0], aabb[1])
    return o_g, d_g, tn, torch.where(hit, torch.maximum(tf, tn + 1e-4), tn)


@pytest.mark.cuda
@pytest.mark.parametrize("octaves,S,R,weights", [
    (10, 96, 3001, None), (8, 48, 4096, None), (8, 1, 63, None),
    (8, 96, 4096, "assets/bench_field.npz"), (10, 96, 4096, "assets/mesh_world/field.npz"),
])
def test_k1_cuda_matches_plain(octaves, S, R, weights, cuda_device):
    """Random fields (``weights`` None) and the shipped trained ones."""
    field = _field(octaves, cuda_device) if weights is None else load_distilled(REPO / weights, device=cuda_device)
    assert field.octaves == octaves
    o_g, d_g, tn, tf = _rays(R, cuda_device)
    assert int((tf <= tn).sum()) > 0
    before = fused_mlp.launch_count(fused_mlp.K1)
    out = fused_mlp.fused_march_render(field, o_g, d_g, tn, tf, S, 1e-7)
    torch.cuda.synchronize()
    assert fused_mlp.launch_count(fused_mlp.K1) == before + 1
    ref = fused_mlp.march_render_reference(field, o_g, d_g, tn, tf, S, 1e-7)
    assert float(ref["alpha"].max()) > 0.05  # the rays meet density
    for k in ("rgb", "alpha", "depth"):
        assert torch.isfinite(out[k]).all()
        torch.testing.assert_close(out[k], ref[k], atol=TOL, rtol=0)


@pytest.mark.cuda
def test_k1_wrapper_refuses_bad_input(cuda_device):
    field = _field(8, cuda_device)
    o_g, d_g, tn, tf = _rays(64, cuda_device)
    with pytest.raises(ValueError):
        fused_mlp.fused_march_render(field, o_g[:, :2], d_g, tn, tf, 8, 1e-7)
    with pytest.raises(ValueError):
        fused_mlp.fused_march_render(field, o_g, d_g.cpu(), tn, tf, 8, 1e-7)
    narrow = _field(8, cuda_device)
    narrow.head["kernel"] = narrow.head["kernel"][:8]
    with pytest.raises(ValueError):
        fused_mlp.fused_march_render(narrow, o_g, d_g, tn, tf, 8, 1e-7)


def _samples(n, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return torch.as_tensor(x, device=device), torch.as_tensor(d, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("octaves,N,weights", [
    (10, 1000, None), (8, 4096, None), (10, 1, None), (10, 524288, None),
    (8, 100003, "assets/bench_field.npz"), (10, 100003, "assets/mesh_world/field.npz"),
])
def test_k2_cuda_matches_plain(octaves, N, weights, cuda_device):
    """Random fields (``weights`` None) and the shipped trained ones; N
    ragged, single, and a full fine chunk of the staged render."""
    field = _field(octaves, cuda_device) if weights is None else load_distilled(REPO / weights, device=cuda_device)
    assert field.octaves == octaves
    x, d = _samples(N, cuda_device)
    before = fused_mlp.launch_count(fused_mlp.K2)
    sigma, rgb = fused_mlp.fused_distilled_eval(field, x, d)
    torch.cuda.synchronize()
    assert fused_mlp.launch_count(fused_mlp.K2) == before + 1
    s_ref, c_ref = fused_mlp.distilled_eval_reference(field, x, d)
    assert sigma.shape == (N,) and rgb.shape == (3, N)
    assert torch.isfinite(sigma).all() and torch.isfinite(rgb).all()
    torch.testing.assert_close(sigma, s_ref, atol=2e-3, rtol=1e-5)
    torch.testing.assert_close(rgb, c_ref, atol=5e-3, rtol=0)


@pytest.mark.cuda
def test_staged_render_launches_k2_only(cuda_device, monkeypatch):
    """render_rays with an importance pass goes through K2 (two launches per
    chunk) and never K1, and agrees with the same render through K2's plain
    version on the card."""
    from pixtrack_tpu_torch.nerf import render as trender

    field = _field(10, cuda_device)
    rng = np.random.default_rng(2)
    o = rng.normal(size=(700, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.6
    d = -o + 0.3 * rng.normal(size=(700, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    aabb = torch.tensor([[0.25] * 3, [0.75] * 3])
    cfg = RenderConfig(n_coarse=32, n_fine=16, chunk=256)
    k1, k2 = fused_mlp.launch_count(fused_mlp.K1), fused_mlp.launch_count(fused_mlp.K2)
    out = render_rays(field, torch.as_tensor(o, device=cuda_device), torch.as_tensor(d, device=cuda_device),
                      aabb.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert fused_mlp.launch_count(fused_mlp.K1) == k1
    assert fused_mlp.launch_count(fused_mlp.K2) == k2 + 2 * 3
    monkeypatch.setattr(trender, "fused_distilled_eval", fused_mlp.distilled_eval_reference)
    ref = render_rays(field, torch.as_tensor(o, device=cuda_device), torch.as_tensor(d, device=cuda_device),
                      aabb.to(cuda_device), cfg)
    assert fused_mlp.launch_count(fused_mlp.K2) == k2 + 2 * 3
    assert float(ref["alpha"].max()) > 0.05
    for k in ("rgb", "alpha"):
        torch.testing.assert_close(out[k], ref[k], atol=5e-3, rtol=0)


@pytest.mark.cuda
def test_k2_wrapper_refuses_bad_input(cuda_device):
    field = _field(8, cuda_device)
    x, d = _samples(64, cuda_device)
    for bad in ((x[:2], d), (x, d.cpu()), (x.double(), d), (x, d.T.contiguous().T), (x[:, :32], d)):
        with pytest.raises(ValueError):
            fused_mlp.fused_distilled_eval(field, *bad)
    narrow = _field(8, cuda_device)
    narrow.head["kernel"] = narrow.head["kernel"][:8]
    with pytest.raises(ValueError):
        fused_mlp.fused_distilled_eval(narrow, x, d)
