"""Textured-mesh loading, rasterisation and surface sampling (host numpy).

Port of ``load_obj``, ``icosphere_directions``, ``look_at_rig_for_mesh``
and ``render_mesh`` from ``pixtrack_tpu/mapping/mesh_render.py`` (the
projection runs through the port's Pose and Camera), plus
``sample_mesh_surface``. The texture is read
by a small PNG decoder of its own, so nothing beyond numpy and the standard
library is needed.
"""

from __future__ import annotations

import struct
import zlib
from itertools import combinations
from pathlib import Path
from typing import List

import numpy as np
import torch

from pixtrack_tpu_torch.geometry import Pose

_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if ftype == 0:
        return row
    if ftype == 2:
        return (row.astype(np.int32) + prev).astype(np.uint8)
    if ftype == 1:
        out = row.astype(np.int64).reshape(-1, bpp)
        return (np.cumsum(out, axis=0) % 256).astype(np.uint8).reshape(-1)
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = up[x]
        if ftype == 3:
            out[x] = (out[x] + ((a + b) >> 1)) & 0xFF
        elif ftype == 4:
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[x] = (out[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path) -> np.ndarray:
    """8-bit, non-interlaced PNG -> uint8 (H, W, C) array, channels as stored."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8 : pos + 8 + n])
        elif kind == b"IDAT":
            idat.append(data[pos + 8 : pos + 8 + n])
        pos += 12 + n
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG layout in {path}")
    bpp = _PNG_CHANNELS[ctype]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, stride + 1)
    rows = []
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        prev = _unfilter_row(int(raw[r, 0]), raw[r, 1:], prev, bpp)
        rows.append(prev)
    return np.stack(rows).reshape(height, width, bpp)


def load_obj(path) -> dict:
    """Minimal OBJ loader: vertices, uvs, faces (v/vt), RGB texture in [0, 1]."""
    path = Path(path)
    verts: List[List[float]] = []
    uvs: List[List[float]] = []
    faces_v: List[List[int]] = []
    faces_vt: List[List[int]] = []
    mtl = None
    for line in path.read_text().splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "v":
            verts.append([float(x) for x in tok[1:4]])
        elif tok[0] == "vt":
            uvs.append([float(tok[1]), float(tok[2])])
        elif tok[0] == "mtllib":
            mtl = path.parent / tok[1]
        elif tok[0] == "f":
            fv, fvt = [], []
            for part in tok[1:]:
                comps = part.split("/")
                fv.append(int(comps[0]) - 1)
                fvt.append(int(comps[1]) - 1 if len(comps) > 1 and comps[1] else 0)
            for k in range(1, len(fv) - 1):  # fan-triangulate polygons
                faces_v.append([fv[0], fv[k], fv[k + 1]])
                faces_vt.append([fvt[0], fvt[k], fvt[k + 1]])
    texture = None
    if mtl is not None and mtl.exists():
        for line in mtl.read_text().splitlines():
            tok = line.split()
            if tok and tok[0] == "map_Kd":
                tex_path = mtl.parent / tok[-1]
                if tex_path.exists():
                    img = read_png(tex_path)
                    if img.shape[-1] < 3:
                        img = np.repeat(img[..., :1], 3, axis=-1)
                    texture = img[..., :3].astype(np.float32) / 255.0
    return {
        "vertices": np.asarray(verts, np.float64),
        "uvs": np.asarray(uvs, np.float64) if uvs else np.zeros((1, 2)),
        "faces": np.asarray(faces_v, np.int64),
        "faces_uv": np.asarray(faces_vt, np.int64),
        "texture": texture,
    }


def icosphere_directions(subdiv: int = 1) -> np.ndarray:
    """Unit directions of the icosahedron's 12 vertices, and with ``subdiv``
    >= 1 the midpoints of its 30 edges too (42 in all)."""
    phi = (1 + 5**0.5) / 2
    v = np.array(
        [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0], [0, -1, phi], [0, 1, phi],
         [0, -1, -phi], [0, 1, -phi], [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if subdiv >= 1:
        extra = []
        for a, b in combinations(range(len(v)), 2):
            if v[a] @ v[b] > 0.4:  # adjacent
                m = v[a] + v[b]
                extra.append(m / np.linalg.norm(m))
        v = np.unique(np.round(np.concatenate([v, extra]), 9), axis=0)
    return v


def look_at_rig_for_mesh(vertices: np.ndarray, n_margin: float = 2.8, subdiv: int = 1) -> List[Pose]:
    """World-to-camera poses (CPU) on a sphere of ``n_margin`` times the
    mesh's radius about its centroid, each looking at the centroid: the
    mapping rig of the object pipeline."""
    center = vertices.mean(axis=0)
    dist = np.linalg.norm(vertices - center, axis=1).max() * n_margin
    poses = []
    for d in icosphere_directions(subdiv):
        eye = center + d * dist
        up = np.array([0.0, 1.0, 0.0]) if abs(d @ np.array([0.0, 1.0, 0.0])) <= 0.95 else np.array([1.0, 0.0, 0.0])
        z = center - eye
        z = z / np.linalg.norm(z)
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z]).astype(np.float32)
        poses.append(Pose.from_Rt(R, (-R @ eye).astype(np.float32)))
    return poses


def sample_mesh_surface(mesh: dict, n: int, seed: int = 0) -> np.ndarray:
    """Points spread uniformly by area over the mesh surface, (n, 3) f32."""
    rng = np.random.default_rng(seed)
    V, F = mesh["vertices"], mesh["faces"]
    v0, v1, v2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    fi = rng.choice(len(F), size=n, p=area / area.sum())
    r1, r2 = rng.uniform(size=(2, n))
    s1 = np.sqrt(r1)
    w = np.stack([1 - s1, s1 * (1 - r2), s1 * r2], axis=1)
    return (w[:, 0:1] * V[F[fi, 0]] + w[:, 1:2] * V[F[fi, 1]] + w[:, 2:3] * V[F[fi, 2]]).astype(np.float32)


def render_mesh(mesh: dict, T_w2c, camera, background=(1.0, 1.0, 1.0), ambient: float = 0.55,
                directional: float = 0.45, return_depth: bool = False):
    """Z-buffered rasterisation with perspective-correct texture lookup and
    flat shading. Returns uint8 (H, W, 3) (and f32 depth, 0 off the mesh)."""
    cpu = torch.device("cpu")
    W = int(float(camera.width))
    H = int(float(camera.height))
    V = mesh["vertices"].astype(np.float32)
    F = mesh["faces"]
    R, t = T_w2c.R.to(cpu), T_w2c.t.to(cpu)
    p_cam_t = torch.as_tensor(V) @ R.T + t
    p2d = camera.to(cpu).project(p_cam_t)[0].numpy()
    p_cam = p_cam_t.numpy()
    z = p_cam[:, 2]

    img = np.ones((H, W, 3), np.float32) * np.asarray(background, np.float32)
    zbuf = np.full((H, W), np.inf, np.float32)
    tex, uvs, fuv = mesh.get("texture"), mesh["uvs"], mesh["faces_uv"]

    v0w, v1w, v2w = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    nrm = np.cross(v1w - v0w, v2w - v0w)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    cam_center = (-(R.T @ t)).numpy()
    light_dir = cam_center - V.mean(axis=0)
    light_dir /= np.linalg.norm(light_dir)
    shade_f = ambient + directional * np.abs(nrm @ light_dir)

    order = np.argsort(-np.minimum.reduce([z[F[:, 0]], z[F[:, 1]], z[F[:, 2]]]))
    for fi in order:
        i0, i1, i2 = F[fi]
        if z[i0] <= 1e-4 or z[i1] <= 1e-4 or z[i2] <= 1e-4:
            continue
        tri = p2d[[i0, i1, i2]]
        xmin = max(int(np.floor(tri[:, 0].min())), 0)
        xmax = min(int(np.ceil(tri[:, 0].max())) + 1, W)
        ymin = max(int(np.floor(tri[:, 1].min())), 0)
        ymax = min(int(np.ceil(tri[:, 1].max())) + 1, H)
        if xmin >= xmax or ymin >= ymax:
            continue
        xs, ys = np.meshgrid(np.arange(xmin, xmax), np.arange(ymin, ymax))
        d = (tri[1, 1] - tri[2, 1]) * (tri[0, 0] - tri[2, 0]) + (tri[2, 0] - tri[1, 0]) * (tri[0, 1] - tri[2, 1])
        if abs(d) < 1e-12:
            continue
        l0 = ((tri[1, 1] - tri[2, 1]) * (xs - tri[2, 0]) + (tri[2, 0] - tri[1, 0]) * (ys - tri[2, 1])) / d
        l1 = ((tri[2, 1] - tri[0, 1]) * (xs - tri[2, 0]) + (tri[0, 0] - tri[2, 0]) * (ys - tri[2, 1])) / d
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        iz = l0 / z[i0] + l1 / z[i1] + l2 / z[i2]
        zpix = 1.0 / np.maximum(iz, 1e-12)
        closer = inside & (zpix < zbuf[ymin:ymax, xmin:xmax])
        if not closer.any():
            continue
        if tex is not None and len(uvs) > 1:
            u0, u1, u2 = uvs[fuv[fi, 0]], uvs[fuv[fi, 1]], uvs[fuv[fi, 2]]
            u = (l0 * u0[0] / z[i0] + l1 * u1[0] / z[i1] + l2 * u2[0] / z[i2]) * zpix
            v = (l0 * u0[1] / z[i0] + l1 * u1[1] / z[i1] + l2 * u2[1] / z[i2]) * zpix
            th, tw = tex.shape[:2]
            ui = np.clip((u * (tw - 1)).astype(int), 0, tw - 1)
            vi = np.clip(((1 - v) * (th - 1)).astype(int), 0, th - 1)
            color = tex[vi, ui]
        else:
            color = np.ones((*xs.shape, 3), np.float32) * 0.7
        color = color * shade_f[fi]
        img[ymin:ymax, xmin:xmax][closer] = color[closer]
        zbuf[ymin:ymax, xmin:xmax][closer] = zpix[closer]

    out = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if return_depth:
        return out, np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
    return out
