"""Procedural textured meshes + texture synthesis.

Two consumers:
- the SECOND benchmark world (VERDICT r4 #2): an asymmetric textured mesh
  driven through the full obj asset pipeline (reference obj_pipeline.sh:
  create_sfm_from_obj -> train_ingp_nerf -> augment) into a closed-loop
  tracking + ADD/ADD-S headline in bench.py;
- detector/descriptor training diversity (VERDICT r4 #1): the r4 learned
  attempts lost to Harris+MNN partly because every teacher scene was one
  of 5 mesh worlds — procedural texture + shape variation generates an
  unbounded scene family for training banks.

All meshes are emitted as OBJ + MTL + texture PNG (the exact input contract
of mapping/mesh_render.load_obj, i.e. reference create_sfm_from_obj.py's
textured-obj input), with per-face UV tiles in one atlas so no two faces
share texture (a shared texture makes opposite faces of a symmetric shape
indistinguishable and SfM locks onto 180-degree false matches).

Port of ``pixtrack_tpu/mapping/procedural.py`` (numpy and scipy): the same
draws, vertices, UVs and atlas pixels; the atlas is written by the port's
PNG writer instead of ``cv2``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np


# ---------------------------------------------------------------- textures ---
def _smooth(img: np.ndarray, sigma: float) -> np.ndarray:
    import scipy.ndimage as ndi

    return ndi.gaussian_filter(img, (sigma, sigma, 0))


def _norm01(img: np.ndarray) -> np.ndarray:
    lo, hi = img.min(), img.max()
    return (img - lo) / max(hi - lo, 1e-9)


def procedural_texture(
    seed: int, size: Tuple[int, int] = (128, 128), style: str = "patches"
) -> np.ndarray:
    """One (H, W, 3) float [0,1] texture tile in the requested style."""
    rng = np.random.default_rng(seed)
    H, W = size
    if style == "patches":
        t = _smooth(rng.uniform(0, 1, (H, W, 3)), 2.0)
    elif style == "voronoi":
        n = rng.integers(8, 24)
        pts = rng.uniform(0, 1, (n, 2)) * [H, W]
        cols = rng.uniform(0.05, 0.95, (n, 3))
        yy, xx = np.mgrid[0:H, 0:W]
        d = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
        t = cols[np.argmin(d, axis=-1)]
        t = _smooth(t, 0.8)
    elif style == "stripes":
        ang = rng.uniform(0, np.pi)
        freq = rng.uniform(4, 14)
        phase = rng.uniform(0, 2 * np.pi)
        yy, xx = np.mgrid[0:H, 0:W]
        u = (np.cos(ang) * xx / W + np.sin(ang) * yy / H) * 2 * np.pi * freq
        wave = 0.5 + 0.5 * np.sign(np.sin(u + phase))
        c0, c1 = rng.uniform(0.05, 0.95, (2, 3))
        t = wave[..., None] * c0 + (1 - wave[..., None]) * c1
        t += rng.normal(0, 0.03, t.shape)
        t = _smooth(t, 0.6)
    elif style == "checker":
        ny, nx = rng.integers(3, 8, 2)
        jy = np.sort(rng.uniform(0.2, 1.0, ny)); jy = np.cumsum(jy) / jy.sum()
        jx = np.sort(rng.uniform(0.2, 1.0, nx)); jx = np.cumsum(jx) / jx.sum()
        yy, xx = np.mgrid[0:H, 0:W]
        iy = np.searchsorted(jy, (yy + 0.5) / H)
        ix = np.searchsorted(jx, (xx + 0.5) / W)
        cols = rng.uniform(0.05, 0.95, (ny + 1, nx + 1, 3))
        t = cols[iy, ix]
        t = _smooth(t, 0.5)
    elif style == "dots":
        base = rng.uniform(0.1, 0.9, 3)
        t = np.tile(base, (H, W, 1)) + rng.normal(0, 0.02, (H, W, 3))
        yy, xx = np.mgrid[0:H, 0:W]
        for _ in range(int(rng.integers(10, 30))):
            cy, cx = rng.uniform(0, H), rng.uniform(0, W)
            r = rng.uniform(0.03, 0.12) * min(H, W)
            col = rng.uniform(0.05, 0.95, 3)
            m = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
            t[m] = col
        t = _smooth(t, 0.7)
    elif style == "noise_octaves":
        t = np.zeros((H, W, 3))
        for o in range(4):
            s = 2 ** o
            low = rng.uniform(0, 1, (max(2, H // (8 * s)), max(2, W // (8 * s)), 3))
            import scipy.ndimage as ndi

            t += ndi.zoom(
                low, (H / low.shape[0], W / low.shape[1], 1), order=1
            )[:H, :W] / s
    else:
        raise ValueError(f"unknown texture style {style!r}")
    return np.clip(_norm01(t), 0, 1).astype(np.float32)


TEXTURE_STYLES = ("patches", "voronoi", "stripes", "checker", "dots",
                  "noise_octaves")


def texture_atlas(
    n_tiles: int, seed: int, tile: int = 96, styles=TEXTURE_STYLES
) -> Tuple[np.ndarray, List[Tuple[float, float, float, float]]]:
    """Stitch n distinct tiles into one atlas. Returns (atlas (H, W, 3),
    [(u0, v0, u1, v1) per tile] in OBJ UV convention (v up))."""
    rng = np.random.default_rng(seed)
    cols = int(np.ceil(np.sqrt(n_tiles)))
    rows = int(np.ceil(n_tiles / cols))
    atlas = np.zeros((rows * tile, cols * tile, 3), np.float32)
    rects = []
    for i in range(n_tiles):
        r, c = divmod(i, cols)
        style = styles[int(rng.integers(len(styles)))]
        atlas[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = (
            procedural_texture(int(rng.integers(1 << 31)), (tile, tile), style)
        )
        # inset 2px to avoid bilinear bleed across tile borders
        eps = 2.0
        u0 = (c * tile + eps) / (cols * tile)
        u1 = ((c + 1) * tile - eps) / (cols * tile)
        # OBJ v runs bottom-up; atlas row 0 is the top
        v1 = 1.0 - (r * tile + eps) / (rows * tile)
        v0 = 1.0 - ((r + 1) * tile - eps) / (rows * tile)
        rects.append((u0, v0, u1, v1))
    return atlas, rects


# ------------------------------------------------------------------ meshes ---
def _quad(vs, quads, a, b, c, d):
    """Register quad (two tris) over vertex indices a,b,c,d (ccw)."""
    quads.append((a, b, c, d))


def _box_quads(vs: List, quads: List, lo, hi):
    """Axis-aligned box [lo, hi]; appends 8 verts + 6 quads."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    base = len(vs)
    vs.extend([
        (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
        (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1),
    ])
    for (a, b, c, d) in [
        (0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
        (2, 3, 7, 6), (0, 3, 7, 4), (1, 2, 6, 5),
    ]:
        _quad(vs, quads, base + a, base + b, base + c, base + d)


def make_house_obj(out_dir, seed: int = 0, size: float = 0.3,
                   tile: int = 96) -> Path:
    """Asymmetric textured 'house': box body + ridge roof + offset chimney.

    The shape has no rotational symmetry (roof ridge breaks top/bottom,
    chimney offset breaks left/right AND front/back) and every face gets a
    distinct procedural texture tile — the second benchmark world's object
    (reference obj pipeline input, create_sfm_from_obj.py:44-59).
    Writes house.obj + house.mtl + atlas png; returns the OBJ path.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    s = size
    vs: List[Tuple[float, float, float]] = []
    quads: List[Tuple[int, int, int, int]] = []
    tris: List[Tuple[int, int, int]] = []

    # body: [-s/2, s/2] x [-s/2.6, s/2.6] x [0, s*0.55]
    _box_quads(vs, quads, (-s / 2, -s / 2.6, 0.0), (s / 2, s / 2.6, 0.55 * s))
    # roof: ridge prism on top, ridge along x, apex off-center in y
    b = len(vs)
    z0, z1 = 0.55 * s, 0.95 * s
    vs.extend([
        (-s / 2, -s / 2.6, z0), (s / 2, -s / 2.6, z0),
        (s / 2, s / 2.6, z0), (-s / 2, s / 2.6, z0),
        (-s / 2, -s * 0.08, z1), (s / 2, -s * 0.08, z1),  # ridge (off-center)
    ])
    quads.append((b + 0, b + 1, b + 5, b + 4))          # front slope
    quads.append((b + 3, b + 2, b + 5, b + 4))          # back slope
    tris.append((b + 0, b + 3, b + 4))                  # left gable
    tris.append((b + 1, b + 2, b + 5))                  # right gable
    # chimney: small box, offset to one corner, above the roof slope
    _box_quads(
        vs, quads,
        (0.12 * s, 0.08 * s, 0.55 * s), (0.28 * s, 0.22 * s, 1.1 * s),
    )

    return _write_obj(out_dir, "house", vs, quads, tris, seed, tile)


def make_lshape_obj(out_dir, seed: int = 0, size: float = 0.3,
                    tile: int = 96) -> Path:
    """Asymmetric textured L-shaped block (two fused boxes)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    s = size
    vs, quads, tris = [], [], []
    _box_quads(vs, quads, (-s / 2, -s / 2, 0.0), (s / 2, 0.0, 0.4 * s))
    _box_quads(vs, quads, (-s / 2, 0.0, 0.0), (0.1 * s, s / 2, 0.75 * s))
    return _write_obj(out_dir, "lshape", vs, quads, tris, seed, tile)


def make_box_obj(out_dir, seed: int = 0, size: float = 0.3,
                 aspect=(1.0, 0.7, 0.45), tile: int = 96) -> Path:
    """Textured rectangular box with per-face distinct tiles."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ax, ay, az = aspect
    s = size
    vs, quads, tris = [], [], []
    _box_quads(vs, quads, (-s * ax / 2, -s * ay / 2, 0.0),
               (s * ax / 2, s * ay / 2, s * az))
    return _write_obj(out_dir, "box", vs, quads, tris, seed, tile)


MESH_MAKERS = {"house": make_house_obj, "lshape": make_lshape_obj,
               "box": make_box_obj}


def _write_obj(out_dir: Path, name: str, vs, quads, tris, seed: int,
               tile: int) -> Path:
    """Emit OBJ/MTL/atlas: each quad gets its own atlas tile (split into 2
    tris), each standalone tri half a tile."""
    from pixtrack_tpu_torch.mapping.mesh_render import write_png

    n_faces = len(quads) + len(tris)
    atlas, rects = texture_atlas(n_faces, seed, tile=tile)
    write_png(out_dir / f"{name}_tex.png", (atlas * 255).astype(np.uint8))
    (out_dir / f"{name}.mtl").write_text(
        f"newmtl m\nmap_Kd {name}_tex.png\n"
    )
    lines = [f"mtllib {name}.mtl", "usemtl m"]
    for v in vs:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    vts: List[Tuple[float, float]] = []
    faces: List[List[Tuple[int, int]]] = []  # [(vi, vti), ...] per face

    def add_vt(u, v):
        vts.append((u, v))
        return len(vts) - 1

    fi = 0
    for (a, b, c, d) in quads:
        u0, v0, u1, v1 = rects[fi]
        fi += 1
        t00, t10 = add_vt(u0, v0), add_vt(u1, v0)
        t11, t01 = add_vt(u1, v1), add_vt(u0, v1)
        faces.append([(a, t00), (b, t10), (c, t11)])
        faces.append([(a, t00), (c, t11), (d, t01)])
    for (a, b, c) in tris:
        u0, v0, u1, v1 = rects[fi]
        fi += 1
        t0 = add_vt(u0, v0)
        t1 = add_vt(u1, v0)
        t2 = add_vt(0.5 * (u0 + u1), v1)
        faces.append([(a, t0), (b, t1), (c, t2)])
    for (u, v) in vts:
        lines.append(f"vt {u:.6f} {v:.6f}")
    for f in faces:
        lines.append(
            "f " + " ".join(f"{vi + 1}/{ti + 1}" for (vi, ti) in f)
        )
    path = out_dir / f"{name}.obj"
    path.write_text("\n".join(lines) + "\n")
    return path
