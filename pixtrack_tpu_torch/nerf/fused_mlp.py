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
# encoding columns of the kernels' first layer (6 * octaves + 3, zero-padded)
_K_ENC = 64
# the counters of the last K1 launch (see last_samples_evaluated)
_k1_scratch = None


def launch_count(kernel: str) -> int:
    return _launches[kernel]


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def last_samples_evaluated():
    """What the last K1 launch walked through the network: dict(hit_rays,
    evaluated = 64 x the tile steps of every warpgroup, empty slots
    included, live = those of them that belonged to a ray that could still
    add colour, which is what the rays need). Synchronises; None before the
    first launch."""
    if _k1_scratch is None:
        return None
    n_hit, _, evaluated, live = (int(v) for v in _k1_scratch.cpu())
    return {"hit_rays": n_hit, "evaluated": evaluated, "live": live}


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
            lib.k1_march_render.argtypes = [p, i, p, p, i, i, i, f, f, p, p, p, p]
            lib.k1_smem_bytes.restype = ctypes.c_size_t
            lib.k1_smem_bytes.argtypes = [i]
        else:
            lib.k2_distilled_eval.restype = i
            lib.k2_distilled_eval.argtypes = [p, p, i, p, p, i, i, p, p]
            lib.k2_smem_bytes.restype = ctypes.c_size_t
            lib.k2_smem_bytes.argtypes = [i]
        _libs[kernel] = lib
    return _libs[kernel]


# ---- the kernels' weight layout, written once here and read back by _unpack_weights ----
#
# A layer's (out, in) matrix becomes the tensor cores' B operand: `in` is K, `out` is N.
# 1. Columns (K). The first layer's 6 * octaves + 3 encoding columns [xyz, sin of
#    3 * octaves angles, cos of the same] are reordered to [sin a_0, cos a_0, sin a_1,
#    cos a_1, ..., x, y, z] and zero-padded to 64, so that a thread's pair of
#    neighbouring columns is one sincos. The first colour layer's columns [15 geometry,
#    16 SH (, 1 unused)] become [1 zero column, 15 geometry, 16 SH]: the head's 16 outputs
#    [raw density, 15 geometry] then feed columns 0..15 as they are, the raw density
#    against the zero column.
# 2. Rows (N). The last colour layer's 3 rows are zero-padded to 8.
# 3. Tiling. Each (N, K) matrix, in bf16, is stored as 8x8 core matrices of 128
#    contiguous bytes in the order [k // 8][n // 8][n % 8][k % 8], the layout a wgmma
#    shared-memory descriptor reads without a swizzle.
# Biases stay f32 in layer order, the last zero-padded to 8.


def _enc_columns(octaves: int):
    """For each of the kernel's 64 encoding columns, the row of
    ``DistilledField.encode_T`` it holds, or -1 for a zero column."""
    n_ang = 3 * octaves
    cols = [-1] * _K_ENC
    for m in range(n_ang):
        cols[2 * m], cols[2 * m + 1] = 3 + m, 3 + n_ang + m
    cols[2 * n_ang : 2 * n_ang + 3] = [0, 1, 2]
    return cols


# the kernel's 32 colour-input columns: -1 the zero column, then the field's 15 + 16
_COLOR_COLUMNS = [-1] + list(range(31))


def _gather_columns(w, cols):
    """(N, len(cols)) with column c = w[:, cols[c]], zeros where cols[c] < 0."""
    idx = torch.as_tensor(cols, device=w.device)
    return torch.where(idx >= 0, w[:, idx.clamp_min(0)], torch.zeros((), dtype=w.dtype, device=w.device))


def _tile(m):
    """(N, K) -> flat [k // 8][n // 8][n % 8][k % 8]."""
    n, k = m.shape
    return m.reshape(n // 8, 8, k // 8, 8).permute(2, 0, 1, 3).reshape(-1)


def _untile(flat, n, k):
    """The inverse of ``_tile``."""
    return flat.reshape(k // 8, n // 8, 8, 8).permute(1, 2, 0, 3).reshape(n, k)


def _layer_shapes(depth: int):
    """(N, K) of every matrix in the packed buffer, in order."""
    return [(128, _K_ENC)] + [(128, 128)] * (depth - 1) + [(16, 128), (64, 32), (64, 64), (8, 64)]


def _unpack_weights(w, depth: int):
    """The packed bf16 buffer read back as its list of (N, K) matrices
    (bf16), columns and padding as the kernels see them."""
    mats, at = [], 0
    for n, k in _layer_shapes(depth):
        mats.append(_untile(w[at : at + n * k], n, k))
        at += n * k
    return mats


def _pack_weights(field, device):
    """The field's weights in the kernels' layout (K1 and K2 share it; the
    comment above defines it): one bf16 buffer of the tiled matrices [W1
    (128, 64) | trunk (depth-1, 128, 128) | head (16, 128) | color0 (64, 32)
    | color1 (64, 64) | color2 (8, 64)] and one f32 buffer of the matching
    biases. Cached on the field per device."""
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
    layers = field.trunk + [field.head] + field.color
    mats = [p["kernel"].to(device).float() for p in layers]
    mats[0] = _gather_columns(mats[0], _enc_columns(field.octaves))
    mats[depth + 1] = _gather_columns(mats[depth + 1], _COLOR_COLUMNS)
    mats[-1] = torch.cat([mats[-1], torch.zeros((5, 64), device=device)])
    w = torch.cat([_tile(m.to(torch.bfloat16)) for m in mats]).contiguous()
    biases = [p["bias"].reshape(-1).to(device).float() for p in layers] + [torch.zeros(5, device=device)]
    b = torch.cat(biases).contiguous()
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
    if lib.k1_smem_bytes(depth) > _MAX_SMEM:
        raise ValueError(f"a {depth}-layer trunk does not fit K1's shared memory")
    rays = torch.cat(
        [o_g.T.float(), d_g.T.float(), t_near[None].float(), t_far[None].float()], dim=0
    ).contiguous()
    out = torch.empty((5, R), dtype=torch.float32, device=device)
    # the kernel's scratch: the list of hit rays, and its zeroed counters
    hits = torch.empty((R,), dtype=torch.int32, device=device)
    scratch = torch.zeros((4,), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = lib.k1_march_render(
            rays.data_ptr(), R, w.data_ptr(), b.data_ptr(), octaves, depth,
            int(n_samples), float(min_transmittance), float(density_scale),
            out.data_ptr(), hits.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 (march_render.cu) failed to launch: CUDA error {err}")
    _launches[K1] += 1
    global _k1_scratch
    _k1_scratch = scratch
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
    if lib.k2_smem_bytes(depth) > _MAX_SMEM:
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
