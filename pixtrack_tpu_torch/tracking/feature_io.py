"""Precomputed reference-feature store (``reference_features.h5``).

Port of ``pixtrack_tpu/tracking/feature_io.py``, with the same layout, so a
file written by either package loads in the other::

    ref_<image_id>/
        p3d      (P, 3)   packed world points
        mask     (P,)     validity
        pose     (4, 4)   w2c pose the features were observed at
        ref_ids  (K,)     contributing reference image ids
        level_<j>/feat    (P, C_j)
        level_<j>/weight  (P,)
        level_<j>/valid   (P,)

Produced offline by :func:`save_reference_features`, consumed by the
trackers via ``StaticRefConfig.features_h5`` or directly with
:func:`load_reference_features`. ``h5py`` is imported inside the functions.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from pixtrack_tpu_torch._device import resolve
from pixtrack_tpu_torch.geometry import Pose
from pixtrack_tpu_torch.tracking.refiner import ReferenceFeatures


def _np(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def save_reference_features(path, refs: Dict[int, ReferenceFeatures]) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        for rid, rf in refs.items():
            g = f.create_group(f"ref_{int(rid)}")
            g.create_dataset("p3d", data=_np(rf.p3d, np.float32))
            g.create_dataset("mask", data=_np(rf.mask, bool))
            g.create_dataset("pose", data=_np(rf.pose.to_4x4(), np.float64))
            g.create_dataset("ref_ids", data=np.asarray(list(rf.ref_ids), np.int64))
            for j, (ft, w, v) in enumerate(zip(rf.feats, rf.weights, rf.valids)):
                lg = g.create_group(f"level_{j}")
                lg.create_dataset("feat", data=_np(ft, np.float32))
                lg.create_dataset("weight", data=_np(w, np.float32))
                lg.create_dataset("valid", data=_np(v, bool))


def load_reference_features(path, ref_ids: Optional[Iterable[int]] = None,
                            device=None) -> Dict[int, ReferenceFeatures]:
    """The stored packs (all, or those of ``ref_ids`` that exist), their
    tensors on ``device`` (None is the CUDA card)."""
    import h5py

    device = resolve(device)

    def load(ds):
        return torch.as_tensor(ds[()], device=device)

    out: Dict[int, ReferenceFeatures] = {}
    with h5py.File(path, "r") as f:
        names = list(f.keys()) if ref_ids is None else [f"ref_{int(r)}" for r in ref_ids]
        for name in names:
            if name not in f:
                continue
            g = f[name]
            n_levels = sum(1 for k in g.keys() if k.startswith("level_"))
            levels = [g[f"level_{j}"] for j in range(n_levels)]
            out[int(name.split("_", 1)[1])] = ReferenceFeatures(
                p3d=load(g["p3d"]),
                mask=load(g["mask"]),
                feats=tuple(load(lg["feat"]) for lg in levels),
                weights=tuple(load(lg["weight"]) for lg in levels),
                valids=tuple(load(lg["valid"]) for lg in levels),
                pose=Pose.from_4x4(g["pose"][()].astype(np.float32), device=device),
                ref_ids=[int(x) for x in g["ref_ids"][()]],
            )
    return out


def precompute_reference_features(refiner, scene, render_fn, path, image_ids=None) -> None:
    """Offline producer: observe every reference image's points in a render
    at its own SfM pose (``render_fn(image_id, pose) -> (image, camera,
    alpha)``) and store the result."""
    refs = {}
    ids = scene.image_ids if image_ids is None else image_ids
    for rid in ids:
        pose = scene.pose_w2c(int(rid), device=refiner.device)
        img, camera, alpha = render_fn(int(rid), pose)
        refs[int(rid)] = refiner.extract_reference_features([int(rid)], pose, img, camera, ref_alpha=alpha)
    save_reference_features(path, refs)
