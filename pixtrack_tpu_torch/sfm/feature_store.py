"""HDF5 feature/match stores, layout-compatible with the reference pipeline.

The reference reads/writes hloc-style h5 files (features.h5 with per-image
groups holding keypoints/descriptors/scores, matches.h5 with pair groups
holding matches0/matching_scores0 — pixtrack/utils/hloc_utils.py:51-101), and
optionally a precomputed reference_features.h5 consumed by the refiner
(pixloc_pose_refiners.py:175-198). Same on-disk contract, first-party code.

Port of ``pixtrack_tpu/sfm/feature_store.py``; ``h5py`` is imported inside
each function that touches a file, so the module imports without it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def pair_key(name0: str, name1: str) -> str:
    """hloc's names_to_pair convention."""
    return "/".join((name0.replace("/", "-"), name1.replace("/", "-")))


# ------------------------------------------------------------- features ----
def write_features(
    path, name: str, keypoints: np.ndarray,
    descriptors: Optional[np.ndarray] = None,
    scores: Optional[np.ndarray] = None,
    image_size: Optional[Tuple[int, int]] = None,
) -> None:
    import h5py

    with h5py.File(path, "a") as f:
        if name in f:
            del f[name]
        g = f.create_group(name)
        g.create_dataset("keypoints", data=np.asarray(keypoints, np.float32))
        if descriptors is not None:
            g.create_dataset("descriptors", data=np.asarray(descriptors, np.float32))
        if scores is not None:
            g.create_dataset("scores", data=np.asarray(scores, np.float32))
        if image_size is not None:
            g.create_dataset("image_size", data=np.asarray(image_size, np.int64))


def read_features(path, name: str) -> Dict[str, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        g = f[name]
        return {k: g[k][...] for k in g.keys()}


def list_feature_names(path):
    import h5py

    names = []

    def visit(key, obj):
        if isinstance(obj, h5py.Group) and "keypoints" in obj:
            names.append(key)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return names


# -------------------------------------------------------------- matches ----
def write_matches(
    path, name0: str, name1: str, matches0: np.ndarray,
    scores0: Optional[np.ndarray] = None,
) -> None:
    """matches0[i] = index in name1's keypoints matched to keypoint i (or -1)."""
    import h5py

    with h5py.File(path, "a") as f:
        key = pair_key(name0, name1)
        if key in f:
            del f[key]
        g = f.create_group(key)
        g.create_dataset("matches0", data=np.asarray(matches0, np.int32))
        if scores0 is not None:
            g.create_dataset("matching_scores0", data=np.asarray(scores0, np.float32))


def read_matches(path, name0: str, name1: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    import h5py

    with h5py.File(path, "r") as f:
        key = pair_key(name0, name1)
        rkey = pair_key(name1, name0)
        if key in f:
            g = f[key]
            m = g["matches0"][...]
            s = g["matching_scores0"][...] if "matching_scores0" in g else None
            return m, s
        if rkey in f:
            g = f[rkey]
            m_rev = g["matches0"][...]
            # invert the mapping
            n1 = len(m_rev)
            # length of the forward array = max matched index + 1 unknown; return pairs instead
            pairs = np.stack([m_rev, np.arange(n1)], axis=1)
            pairs = pairs[m_rev >= 0]
            m = np.full(int(pairs[:, 0].max()) + 1 if len(pairs) else 0, -1, np.int32)
            m[pairs[:, 0]] = pairs[:, 1]
            s = None
            return m, s
    raise KeyError(f"no matches for ({name0}, {name1})")


def matches_as_pairs(matches0: np.ndarray) -> np.ndarray:
    """(N, 2) array of (idx0, idx1) from a matches0 vector."""
    idx0 = np.nonzero(matches0 >= 0)[0]
    return np.stack([idx0, matches0[idx0]], axis=1).astype(np.int64)
