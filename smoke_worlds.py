"""Geometry of the worlds that ``chip_smoke.py`` drives, in numpy.

The blob world's SfM-space surface points and the look-at poses that both
worlds' ground-truth orbits are built from are the ``demo`` world's
(``pixtrack_tpu_torch/pipelines/demo_world.py``, the same definitions as
``tests/synthetic_world.py``, which needs JAX); the textured cube of the
mapper's arc rig is ``tests/test_mesh_render.py::make_cube_obj``'s, which
writes its texture with cv2. The mesh world's points come from
``pixtrack_tpu_torch.mapping.mesh_render.sample_mesh_surface``. Test
fixtures, not part of the package: ``chip_smoke.py`` and the port's tests
import this file from the repository root.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pixtrack_tpu_torch.pipelines.demo_world import look_at_w2c, sphere_surface_points

__all__ = ["look_at_w2c", "make_cube_obj", "sphere_surface_points"]


def make_cube_obj(directory, size: float = 0.2) -> Path:
    """A textured cube: ``cube.obj``, ``cube.mtl`` and ``tex.png`` in
    ``directory``; the path of the OBJ. The texture is an aperiodic atlas of
    smoothed random colours, one distinct 64 x 64 tile per face (a shared
    texture makes opposite faces identical, and SfM then locks onto
    180-degree false matches). The same files as the JAX package's test
    fixture: that one hands the array to ``cv2.imwrite``, which takes it as
    BGR, so its PNG holds the channels reversed, and so does this one."""
    import scipy.ndimage as ndi

    from pixtrack_tpu_torch.mapping.mesh_render import write_png

    d = Path(directory)
    rng = np.random.default_rng(3)
    tex = rng.uniform(0, 255, (128, 192, 3))
    tex = ndi.gaussian_filter(tex, (2, 2, 0))
    tex = ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.uint8)
    write_png(d / "tex.png", tex[..., ::-1])
    (d / "cube.mtl").write_text("newmtl m\nmap_Kd tex.png\n")
    s = size
    verts = [(-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s), (-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]
    faces = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8)]  # 1-based quads
    # atlas tiles: 3 columns x 2 rows; face k -> tile (k % 3, k // 3)
    uvs = []
    for k in range(6):
        cx0, cy0 = (k % 3) / 3.0, (k // 3) / 2.0
        cx1, cy1 = cx0 + 1 / 3.0, cy0 + 0.5
        uvs += [(cx0, cy0), (cx1, cy0), (cx1, cy1), (cx0, cy1)]
    lines = ["mtllib cube.mtl", "usemtl m"]
    lines += [f"v {v[0]} {v[1]} {v[2]}" for v in verts]
    lines += [f"vt {u[0]} {u[1]}" for u in uvs]
    lines += ["f " + " ".join(f"{vi}/{4 * fk + k + 1}" for k, vi in enumerate(f)) for fk, f in enumerate(faces)]
    p = d / "cube.obj"
    p.write_text("\n".join(lines) + "\n")
    return p
