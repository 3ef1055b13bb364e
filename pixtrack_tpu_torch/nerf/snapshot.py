"""Hash-grid NeRF snapshots, in the JAX package's file layout.

Port of ``pixtrack_tpu/nerf/snapshot.py``. A snapshot holds the flax params
tree of an ``NGPField`` flattened in flax's (sorted) key order, the field's
constructor arguments and a free ``extra`` dict:
- ``.npz``: ``__meta__`` (JSON: ``format``, ``field``, ``extra``, ``keys``
  such as ``"['params']['encoding']['table0']"``) and ``arr_{i}``;
- ``.msgpack``: the same meta and a list of {dtype, shape, data} arrays.
Files written by either package load in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

from pixtrack_tpu_torch.nerf.field import NGPField, ngp_from_flax_params, ngp_to_flax_params


def _flatten(tree, prefix=""):
    """(key string, leaf) pairs in flax's order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}['{k}']")
    else:
        yield prefix, tree


def save_snapshot(path, field: NGPField, extra: dict | None = None) -> None:
    path = Path(path)
    flat = list(_flatten(ngp_to_flax_params(field)))
    meta = {
        "format": "pixtrack-tpu-nerf-v1",
        "field": field.config(),
        "extra": extra or {},
        "keys": [k for k, _ in flat],
    }
    arrays = [np.ascontiguousarray(v) for _, v in flat]
    if path.suffix == ".msgpack":
        import msgpack

        payload = {
            "meta": meta,
            "arrays": [{"dtype": str(a.dtype), "shape": list(a.shape), "data": a.tobytes()} for a in arrays],
        }
        path.write_bytes(msgpack.packb(payload, use_bin_type=True))
    else:
        np.savez(path, __meta__=json.dumps(meta), **{f"arr_{i}": a for i, a in enumerate(arrays)})


def load_snapshot(path, device=None) -> Tuple[NGPField, dict]:
    """Returns (field on ``device`` (None is the CUDA card), extra)."""
    path = Path(path)
    if path.suffix == ".msgpack":
        import msgpack

        payload = msgpack.unpackb(path.read_bytes(), raw=False)
        meta = payload["meta"]
        arrays = [np.frombuffer(a["data"], dtype=a["dtype"]).reshape(a["shape"]) for a in payload["arrays"]]
    else:
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            arrays = [data[f"arr_{i}"] for i in range(len(meta["keys"]))]
    params: dict = {}
    for keystr, arr in zip(meta["keys"], arrays):
        keys = [k.strip("'") for k in keystr.strip("[]").split("][")]
        d = params
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = arr
    return ngp_from_flax_params(params, device=device, **meta["field"]), meta.get("extra", {})
