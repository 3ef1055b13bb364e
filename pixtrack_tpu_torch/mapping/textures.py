"""Procedural texture families + textured-cube scenes for training banks.

The r2/r3 matcher and detector banks drew every face texture from ONE
family (gaussian-blurred uniform noise) and the trained models measurably
overfit it (assets/negative/matcher_meshbank_r2_eval.json; the r3
SuperPoint texture-bank rejection). The deployment distribution — SfM on
NeRF renders of arbitrary real objects (reference
scripts/run_reconstruction.py:39-50) — has no single texture statistic,
so training banks must mix families. These generators are shared by the
SuperPoint dense-distillation bank (mapping/train_superpoint_dense.py)
and the attention-matcher bank (mapping/train_matcher.py).

Port of ``pixtrack_tpu/mapping/textures.py`` (numpy and scipy); the texture
is written by the port's PNG writer instead of ``cv2`` (the same pixels).
"""

from __future__ import annotations

import numpy as np


def rich_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """One random texture tile from a diverse family mix (uint8 RGB).

    Families: correlated blob noise at random correlation lengths (the
    legacy family), hard-edged voronoi-ish patches, stripes/checkers at
    random frequency+angle, and sparse speckle — plus a random global
    contrast squeeze so low-texture regions appear too."""
    import scipy.ndimage as ndi

    fam = rng.integers(0, 4)
    if fam == 0:  # correlated blob noise (the legacy family)
        tex = rng.uniform(0, 255, (h, w, 3))
        tex = ndi.gaussian_filter(tex, (rng.uniform(0.8, 4.0),) * 2 + (0,))
    elif fam == 1:  # voronoi-ish hard patches: nearest of K random sites
        K = int(rng.integers(8, 40))
        sites = rng.uniform(0, 1, (K, 2)) * [h, w]
        cols = rng.uniform(0, 255, (K, 3))
        yy, xx = np.mgrid[0:h, 0:w]
        d = (yy[..., None] - sites[:, 0]) ** 2 + (xx[..., None] - sites[:, 1]) ** 2
        tex = cols[np.argmin(d, axis=-1)]
    elif fam == 2:  # stripes / checker at random angle+frequency
        th = rng.uniform(0, np.pi)
        f1 = rng.uniform(2, 14)
        f2 = rng.uniform(2, 14)
        yy, xx = np.mgrid[0:h, 0:w]
        u = (np.cos(th) * xx + np.sin(th) * yy) / w
        v = (-np.sin(th) * xx + np.cos(th) * yy) / h
        a = np.sin(2 * np.pi * f1 * u)
        b = np.sin(2 * np.pi * f2 * v) if rng.uniform() < 0.5 else 1.0
        base = rng.uniform(0, 255, 3)
        alt = rng.uniform(0, 255, 3)
        m = ((a * b) > 0)[..., None]
        tex = np.where(m, base, alt) + rng.normal(0, 8, (h, w, 3))
    else:  # sparse speckle on a smooth background
        tex = ndi.gaussian_filter(rng.uniform(60, 200, (h, w, 3)), (6, 6, 0))
        n_dots = int(rng.integers(30, 150))
        ys = rng.integers(1, h - 1, n_dots)
        xs = rng.integers(1, w - 1, n_dots)
        cols = rng.uniform(0, 255, (n_dots, 3))
        r = int(rng.integers(1, 3))
        for (y, x, c) in zip(ys, xs, cols):
            tex[max(0, y - r):y + r + 1, max(0, x - r):x + r + 1] = c
    # random global contrast squeeze (low-texture nuisance)
    lo = rng.uniform(0.0, 0.35)
    hi = rng.uniform(0.65, 1.0)
    tex = (tex - tex.min()) / max(np.ptp(tex), 1e-6)
    tex = (lo + (hi - lo) * tex) * 255.0
    return tex.astype(np.uint8)


def write_cube_obj(d, tex: np.ndarray) -> None:
    """Write cube.obj/.mtl/tex.png for a 0.4-side cube whose six faces map
    the six tiles of a 2x3 texture atlas."""
    from pixtrack_tpu_torch.mapping.mesh_render import write_png

    write_png(d / "tex.png", tex)
    (d / "cube.mtl").write_text("newmtl m\nmap_Kd tex.png\n")
    s = 0.2
    v = [(x, y, z) for x in (-s, s) for y in (-s, s) for z in (-s, s)]
    faces = [  # (vertex quad, uv tile) per cube face
        ((0, 1, 3, 2), 0), ((4, 6, 7, 5), 1), ((0, 4, 5, 1), 2),
        ((2, 3, 7, 6), 3), ((0, 2, 6, 4), 4), ((1, 5, 7, 3), 5),
    ]
    lines = ["mtllib cube.mtl\nusemtl m"]
    for x, y, z in v:
        lines.append(f"v {x} {y} {z}")
    uv_tiles = [(c / 3.0, r / 2.0) for r in range(2) for c in range(3)]
    for (u0, v0) in uv_tiles:
        for (du, dv) in ((0, 0), (1 / 3, 0), (1 / 3, 1 / 2), (0, 1 / 2)):
            lines.append(f"vt {u0 + du} {v0 + dv}")
    for (quad, tile) in faces:
        a, b, c, dd = (i + 1 for i in quad)
        t = tile * 4 + 1
        lines.append(f"f {a}/{t} {b}/{t + 1} {c}/{t + 2}")
        lines.append(f"f {a}/{t} {c}/{t + 2} {dd}/{t + 3}")
    (d / "cube.obj").write_text("\n".join(lines) + "\n")


def rich_cube_mesh(workdir, seed: int, tile: int = 64):
    """Textured cube with one independently drawn rich-family texture tile
    per face (2x3 atlas)."""
    from pixtrack_tpu_torch.mapping.mesh_render import load_obj

    d = workdir / f"rcube_{seed}"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    tex = np.zeros((2 * tile, 3 * tile, 3), np.uint8)
    for r in range(2):
        for c in range(3):
            tex[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = (
                rich_texture(rng, tile, tile)
            )
    write_cube_obj(d, tex)
    return load_obj(d / "cube.obj")
