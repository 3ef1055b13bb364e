"""The JAX package's numpy-only modules, loaded by file path.

``geometry/nerf_transform.py``, ``sfm/colmap_io.py`` and ``eval/metrics.py``
of ``pixtrack_tpu`` import nothing but numpy, but their package
``__init__``s import JAX. Loading the three files directly shares their code
without dragging JAX into this package.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_JAX_PKG = Path(__file__).resolve().parents[1] / "pixtrack_tpu"


def _load(rel_path: str, name: str):
    full = f"pixtrack_tpu_torch._shared_{name}"
    if full in sys.modules:
        return sys.modules[full]
    spec = importlib.util.spec_from_file_location(full, _JAX_PKG / rel_path)
    mod = importlib.util.module_from_spec(spec)
    # dataclasses look their module up in sys.modules while the class body runs
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


nerf_transform = _load("geometry/nerf_transform.py", "nerf_transform")
colmap_io = _load("sfm/colmap_io.py", "colmap_io")
metrics = _load("eval/metrics.py", "metrics")
