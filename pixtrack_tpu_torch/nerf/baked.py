"""The baked cell-packed field, the occupancy grid and its main component.

Port of ``pixtrack_tpu/nerf/baked.py`` in plain PyTorch, at the JAX
package's layout and numbers. ``bake`` packs the 8 trilinear corner vectors
of every cell of a level into one column of a per-level table (8F, cells):
levels whose res^3 cells fit in 2^max_cell_table_log2 get an exact dense
table; finer levels a hashed one, filled only for cells near occupied space
(``occupancy_grid``), so unoccupied cells read zero and colliding cells
share a slot. The JAX package bakes to cut TPU gathers; here the baked field
is kept because it is what ``Testbed.distill`` distills from when a baked
field is installed, and on hashed levels it differs from the vertex field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from pixtrack_tpu_torch.nerf.field import (
    NGPField,
    _CORNERS,
    _LAYERS,
    _level_resolutions,
    sh_encoding_deg4_T,
    spatial_hash,
    trunc_exp,
)


def _cell_hash(xi, yi, zi, T: int, dense: bool, res: int) -> torch.Tensor:
    """Slot of cell (xi, yi, zi) in a level table of T columns: row-major
    over res^3 cells on a dense level, the vertex tables' hash otherwise."""
    if dense:
        return xi + res * (yi + res * zi)
    return spatial_hash(xi, yi, zi, T)


@dataclasses.dataclass
class BakedField:
    """Cell-packed tables and the trained field's MLP weights."""

    tables: List[torch.Tensor]  # per level (8F, T_cells)
    resolutions: np.ndarray  # per level cell-grid resolution
    dense: List[bool]  # per level: exact dense indexing?
    f_per_level: int
    mlp_params: Dict[str, Dict[str, torch.Tensor]]  # the NGPField dense layers
    hidden: int = 64
    geo_features: int = 15

    @property
    def device(self) -> torch.device:
        return self.tables[0].device

    def encode_T(self, xT: torch.Tensor) -> torch.Tensor:
        """(3, N) in [0, 1] -> (L*F, N): one gather per level."""
        F = self.f_per_level
        outs = []
        for lvl, table in enumerate(self.tables):
            res = int(self.resolutions[lvl])
            xs = xT * res
            x0 = torch.floor(xs.clamp(0.0, res - 1e-4))
            frac = xs - x0
            xi = x0.long()
            idx = _cell_hash(xi[0], xi[1], xi[2], table.shape[1], self.dense[lvl], res)
            v = table[:, idx].reshape(8, F, -1)
            # the 8 corners summed in the vertex encoding's order, so that a
            # dense level equals the vertex field's to the last bit
            acc = None
            for c, (ci, cj, ck) in enumerate(_CORNERS):
                wx = frac[0] if ci else 1.0 - frac[0]
                wy = frac[1] if cj else 1.0 - frac[1]
                wz = frac[2] if ck else 1.0 - frac[2]
                contrib = v[c] * (wx * wy * wz)[None]
                acc = contrib if acc is None else acc + contrib
            outs.append(acc)
        return torch.cat(outs, dim=0)

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = self.mlp_params[name]
        return p["kernel"] @ x + p["bias"]

    def density_T(self, xT: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = torch.relu(self._dense("density_l1", self.encode_T(xT)))
        h = self._dense("density_l2", h)
        return trunc_exp(h[0]), h[1:]

    def color_T(self, geoT: torch.Tensor, dT: torch.Tensor) -> torch.Tensor:
        h = torch.cat([geoT, sh_encoding_deg4_T(dT)], dim=0)
        h = torch.relu(self._dense("color_l1", h))
        h = torch.relu(self._dense("color_l2", h))
        return torch.sigmoid(self._dense("color_l3", h))

    def field_T(self, xT: torch.Tensor, dT: torch.Tensor):
        sigma, geo = self.density_T(xT)
        return sigma, self.color_T(geo, dT)


def _pack_corners(vtab: torch.Tensor, cx, cy, cz, res: int, Tv: int) -> torch.Tensor:
    """The 8 corner vertex vectors of cells (cx, cy, cz) from a level's
    vertex table (F, Tv), indexed as the hash encoding indexes them:
    (8F, n_cells), corner-major."""
    rows = []
    for ci, cj, ck in _CORNERS:
        vx, vy, vz = cx + ci, cy + cj, cz + ck
        if (res + 1) ** 3 <= Tv:
            vidx = vx + (res + 1) * (vy + (res + 1) * vz)
        else:
            vidx = spatial_hash(vx, vy, vz, Tv)
        rows.append(vtab[:, vidx])
    return torch.cat(rows, dim=0)


@torch.no_grad()
def occupancy_grid(field, res: int = 128, sigma_threshold: float = 0.01, dilate: int = 1,
                   chunk: int = 1 << 19) -> np.ndarray:
    """(res, res, res) bool, indexed [x, y, z]: density above the threshold
    at the cell centres of [0, 1]^3, dilated ``dilate`` times (6-neighbour).
    ``field`` is anything with ``density_T`` and ``device``."""
    centers = (np.arange(res, dtype=np.float32) + 0.5) / res
    zz, yy, xx = np.meshgrid(centers, centers, centers, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=0)
    sig = np.empty(pts.shape[1], np.float32)
    for s in range(0, pts.shape[1], chunk):
        blk = torch.as_tensor(pts[:, s : s + chunk], device=field.device)
        sig[s : s + chunk] = field.density_T(blk)[0].cpu().numpy()
    occ = (sig.reshape(res, res, res) > sigma_threshold).transpose(2, 1, 0)
    return _dilate(occ, dilate)


def _dilate(occ: np.ndarray, times: int) -> np.ndarray:
    for _ in range(times):
        g = occ.copy()
        g[1:] |= occ[:-1]; g[:-1] |= occ[1:]
        g[:, 1:] |= occ[:, :-1]; g[:, :-1] |= occ[:, 1:]
        g[:, :, 1:] |= occ[:, :, :-1]; g[:, :, :-1] |= occ[:, :, 1:]
        occ = g
    return occ


def main_component(occ: np.ndarray, dilate: int = 2) -> np.ndarray:
    """The largest 26-connected component of an occupancy grid, dilated
    ``dilate`` times: the object, without the floaters a short training
    leaves around it."""
    from scipy import ndimage

    labels, n = ndimage.label(occ, structure=np.ones((3, 3, 3), bool))
    if n <= 1:
        keep = occ.copy()
    else:
        sizes = ndimage.sum_labels(occ, labels, index=np.arange(1, n + 1))
        keep = labels == (1 + int(np.argmax(sizes)))
    return _dilate(keep, dilate)


@torch.no_grad()
def bake(field: NGPField, max_cell_table_log2: int = 19, occ_res: int = 128, sigma_threshold: float = 0.01,
         max_cells_per_chunk: int = 1 << 23) -> BakedField:
    """Pack the trained vertex hash grid into per-cell corner tables, on the
    field's device. Hashed levels are filled for the fine cells that overlap
    an occupied cell of ``occupancy_grid(field, occ_res, sigma_threshold)``."""
    occ = None
    enc = field.encoding
    F, Tv, dev = enc.features_per_level, 1 << enc.log2_table_size, field.device
    resolutions = _level_resolutions(enc.n_levels, enc.base_res, enc.max_res)
    vtabs = enc.tables.detach()
    tables, dense_flags = [], []
    for lvl in range(enc.n_levels):
        res = int(resolutions[lvl])
        cell_dense = res**3 <= (1 << max_cell_table_log2)
        if cell_dense:
            g = torch.arange(res, device=dev)
            zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
            table = _pack_corners(vtabs[lvl], xx.reshape(-1), yy.reshape(-1), zz.reshape(-1), res, Tv)
        else:
            if occ is None:
                occ = occupancy_grid(field, occ_res, sigma_threshold)
            Tc = 1 << max_cell_table_log2
            table = torch.zeros((8 * F, Tc), device=dev)
            # the fine cells overlapping each occupied coarse cell: a span of
            # ceil(res / occ_res) + 1 covers a partial overlap at the far edge
            ox, oy, oz = (torch.as_tensor(a, device=dev) for a in np.nonzero(occ))
            w = -(-res // occ_res) + 1
            sub = torch.arange(w, device=dev)
            sz, sy, sx = (a.reshape(-1) for a in torch.meshgrid(sub, sub, sub, indexing="ij"))
            per_chunk = max(1, max_cells_per_chunk // w**3)
            base = [(a * res) // occ_res for a in (ox, oy, oz)]
            for s in range(0, len(ox), per_chunk):
                cx, cy, cz = ((b[s : s + per_chunk, None] + o[None, :]).clamp_max(res - 1).reshape(-1)
                              for b, o in zip(base, (sx, sy, sz)))
                slot = _cell_hash(cx, cy, cz, Tc, False, res)
                # where cells collide the last one written wins, as in the JAX
                # package's sequential scatter (a CUDA scatter would pick any):
                # keep each slot's last cell, the end of its run in a stable sort
                sorted_slot, order = torch.sort(slot, stable=True)
                ends = torch.ones_like(sorted_slot, dtype=torch.bool)
                ends[:-1] = sorted_slot[1:] != sorted_slot[:-1]
                keep = order[ends]
                table[:, slot[keep]] = _pack_corners(vtabs[lvl], cx[keep], cy[keep], cz[keep], res, Tv)
        tables.append(table)
        dense_flags.append(cell_dense)
    mlp = {name: {"kernel": getattr(field, name).kernel.detach(), "bias": getattr(field, name).bias.detach()}
           for name in _LAYERS}
    return BakedField(tables=tables, resolutions=resolutions, dense=dense_flags, f_per_level=F, mlp_params=mlp,
                      hidden=field.hidden, geo_features=field.geo_features)
