"""The distilled field's two kernels and their plain PyTorch versions.

K1, ``fused_march_render``, replaces the Pallas kernel of the same name in
``pixtrack_tpu/nerf/fused_mlp.py``: stratified sampling, the distilled MLP
and compositing in one launch, with per-ray device-memory traffic only (CUDA
``csrc/march_render.cu``; plain version ``march_render_reference``).

K2, ``fused_distilled_eval``, replaces the Pallas kernel of the same name:
the distilled MLP at each of N samples, for the staged render's importance
pass (CUDA ``csrc/distilled_eval.cu``; plain version
``distilled_eval_reference``, which is ``DistilledField.field_T``).

On a CUDA tensor each wrapper launches its hand-written kernel (built at
first use) or raises; on a CPU tensor it runs the plain version, which the
tests and ``chip_smoke.py`` hold the kernel against. Each wrapper counts its
launches (``launch_count``), the proof that a path went through it.
"""

from __future__ import annotations

import ctypes

import torch

from pixtrack_tpu_torch import _build

K1, K2 = "fused_march_render", "fused_distilled_eval"
# kernel launches since the last reset (the main-path proof)
_launches = {K1: 0, K2: 0}
# csrc/<source>.cu of each kernel
_SOURCES = {K1: "march_render", K2: "distilled_eval"}
_libs = {}
# largest dynamic shared memory a block may use on an H100
_MAX_SMEM = 232448
# rays per slice of K1's plain version (bounds its per-sample activations)
_PLAIN_CHUNK = 8192


def launch_count(kernel: str) -> int:
    return _launches[kernel]


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def build_kernels() -> None:
    """Build (nvcc, one process per source, in parallel) and load both kernels."""
    _build.load_libraries(list(_SOURCES.values()))
    for kernel in _SOURCES:
        _library(kernel)


def _library(kernel: str):
    if kernel not in _libs:
        lib = _build.load_library(_SOURCES[kernel])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if kernel == K1:
            lib.k1_march_render.restype = i
            lib.k1_march_render.argtypes = [p, i, p, p, i, i, i, f, f, p, p]
            lib.k1_smem_bytes.restype = ctypes.c_size_t
            lib.k1_smem_bytes.argtypes = [i, i]
        else:
            lib.k2_distilled_eval.restype = i
            lib.k2_distilled_eval.argtypes = [p, p, i, p, p, i, i, p, p]
            lib.k2_smem_bytes.restype = ctypes.c_size_t
            lib.k2_smem_bytes.argtypes = [i, i]
        _libs[kernel] = lib
    return _libs[kernel]


def _pack_weights(field, device):
    """The field's weights in the kernels' layout (K1 and K2 share it): one bf16 buffer
    [W1 (128, enc_pad) | trunk (depth-1, 128, 128) | head (16, 128) |
    color0 (64, 32) | color1 (64, 64) | color2 (3, 64)] and one f32 buffer
    of the matching biases. Cached on the field per device."""
    cache = field.__dict__.setdefault("_kernel_pack", {})
    key = str(device)
    if key in cache:
        return cache[key]
    depth = len(field.trunk)
    width = field.trunk[0]["kernel"].shape[0]
    n_enc = 3 + 6 * field.octaves
    shapes_ok = (
        field.octaves in (8, 10)
        and width == 128
        and field.trunk[0]["kernel"].shape[1] == n_enc
        and all(tuple(p["kernel"].shape) == (128, 128) for p in field.trunk[1:])
        and tuple(field.head["kernel"].shape) == (16, 128)
        and len(field.color) == 3
        and tuple(field.color[0]["kernel"].shape) in ((64, 31), (64, 32))
        and tuple(field.color[1]["kernel"].shape) == (64, 64)
        and tuple(field.color[2]["kernel"].shape) == (3, 64)
    )
    if not shapes_ok:
        raise ValueError(
            "K1 and K2 are specialised to the production field: 8 or 10 octaves, a "
            "128-wide trunk, a 16-row head and colour 31/32->64->64->3"
        )
    enc_pad = -(-n_enc // 8) * 8

    def pad_cols(w, cols):
        out = torch.zeros((w.shape[0], cols), dtype=torch.float32, device=device)
        out[:, : w.shape[1]] = w.to(device)
        return out

    mats = [pad_cols(field.trunk[0]["kernel"], enc_pad)]
    mats += [p["kernel"].to(device) for p in field.trunk[1:]]
    mats += [field.head["kernel"].to(device), pad_cols(field.color[0]["kernel"], 32)]
    mats += [field.color[1]["kernel"].to(device), field.color[2]["kernel"].to(device)]
    layers = field.trunk + [field.head] + field.color
    w = torch.cat([m.reshape(-1) for m in mats]).to(torch.bfloat16).contiguous()
    b = torch.cat([p["bias"].reshape(-1).to(device) for p in layers]).float().contiguous()
    cache[key] = (field.octaves, depth, w, b)
    return cache[key]


def march_render_reference(
    field, o_g, d_g, t_near, t_far, n_samples: int, min_transmittance: float,
    density_scale: float = 1.0,
):
    """Plain PyTorch version of K1, from the staged render's pieces:
    midpoint stratified samples, ``DistilledField.field_T`` and
    ``_composite``. Rays are grid-space origins/directions (R, 3); a miss
    is encoded as ``t_far <= t_near``. Returns dict(rgb (R, 3), alpha (R,),
    depth (R,))."""
    from pixtrack_tpu_torch.nerf.render import _composite, _sample_stratified

    S, chunk = int(n_samples), _PLAIN_CHUNK
    rgbs, alphas, depths = [], [], []
    for s in range(0, o_g.shape[0], chunk):
        o, d = o_g[s : s + chunk].float(), d_g[s : s + chunk].float()
        tn, tf = t_near[s : s + chunk].float(), t_far[s : s + chunk].float()
        r = o.shape[0]
        ts = _sample_stratified(tn, tf, S)  # (r, S)
        x = (o.T[:, :, None] + ts[None] * d.T[:, :, None]).clamp(0.0, 1.0).reshape(3, r * S)
        # the kernel's norm: ((x*x + y*y) + z*z), square root, floor 1e-9
        dn = d.T / (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]).sqrt().clamp_min(1e-9)
        drep = dn[:, :, None].expand(3, r, S).reshape(3, r * S)
        sigma, rgbT = field.field_T(x, drep)
        rgb, acc, depth = _composite(
            sigma.reshape(r, S), rgbT.reshape(3, r, S), ts, tf, tf > tn,
            min_transmittance, density_scale,
        )
        rgbs.append(rgb)
        alphas.append(acc)
        depths.append(depth)
    return {"rgb": torch.cat(rgbs), "alpha": torch.cat(alphas), "depth": torch.cat(depths)}


def fused_march_render(
    field, o_g, d_g, t_near, t_far, n_samples: int, min_transmittance: float,
    density_scale: float = 1.0,
):
    """Whole-ray fused render of a DistilledField (K1).

    o_g, d_g (R, 3) grid-space rays, t_near/t_far (R,) with t in NeRF units
    (a miss has t_far <= t_near). CUDA tensors launch the CUDA kernel; CPU
    tensors take the plain version. Returns dict(rgb (R, 3), alpha (R,),
    depth (R,))."""
    device = o_g.device
    if device.type == "cpu":
        return march_render_reference(
            field, o_g, d_g, t_near, t_far, n_samples, min_transmittance, density_scale
        )
    if device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {device.type}")
    R = o_g.shape[0]
    if o_g.shape != (R, 3) or d_g.shape != (R, 3) or t_near.shape != (R,) or t_far.shape != (R,):
        raise ValueError("K1 expects o_g, d_g (R, 3) and t_near, t_far (R,)")
    if any(x.device != device for x in (d_g, t_near, t_far)):
        raise ValueError("K1's inputs must lie on one device")
    if int(n_samples) < 1:
        raise ValueError("K1 needs at least one sample per ray")
    octaves, depth, w, b = _pack_weights(field, device)
    lib = _library(K1)
    if lib.k1_smem_bytes(octaves, depth) > _MAX_SMEM:
        raise ValueError(f"a {depth}-layer trunk does not fit K1's shared memory")
    rays = torch.cat(
        [o_g.T.float(), d_g.T.float(), t_near[None].float(), t_far[None].float()], dim=0
    ).contiguous()
    out = torch.empty((5, R), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.k1_march_render(
            rays.data_ptr(), R, w.data_ptr(), b.data_ptr(), octaves, depth,
            int(n_samples), float(min_transmittance), float(density_scale),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 (march_render.cu) failed to launch: CUDA error {err}")
    _launches[K1] += 1
    return {"rgb": out[1:4].T, "alpha": out[0], "depth": out[4]}


def distilled_eval_reference(field, xT, dT):
    """Plain PyTorch version of K2: ``DistilledField.field_T``."""
    return field.field_T(xT, dT)


def fused_distilled_eval(field, xT, dT):
    """The distilled field at positions xT (3, N) and unit directions dT
    (3, N), float32 and contiguous (K2). Returns (sigma (N,), rgbT (3, N)),
    the contract of ``DistilledField.field_T``. CUDA tensors launch the CUDA
    kernel; CPU tensors take the plain version."""
    device = xT.device
    if device.type == "cpu":
        return distilled_eval_reference(field, xT, dT)
    if device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {device.type}")
    N = xT.shape[-1]
    if xT.shape != (3, N) or dT.shape != (3, N):
        raise ValueError("K2 expects positions and directions of shape (3, N)")
    if dT.device != device:
        raise ValueError("K2's inputs must lie on one device")
    if xT.dtype != torch.float32 or dT.dtype != torch.float32:
        raise ValueError("K2 takes float32 positions and directions")
    if not (xT.is_contiguous() and dT.is_contiguous()):
        raise ValueError("K2 takes contiguous (3, N) tensors")
    if N >= 2**31 // 4:
        raise ValueError(f"K2 takes fewer than 2**29 samples per call, not {N}")
    octaves, depth, w, b = _pack_weights(field, device)
    lib = _library(K2)
    if lib.k2_smem_bytes(octaves, depth) > _MAX_SMEM:
        raise ValueError(f"a {depth}-layer trunk does not fit K2's shared memory")
    out = torch.empty((4, N), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.k2_distilled_eval(
            xT.data_ptr(), dT.data_ptr(), N, w.data_ptr(), b.data_ptr(), octaves, depth,
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K2 (distilled_eval.cu) failed to launch: CUDA error {err}")
    _launches[K2] += 1
    return out[0], out[1:4]
