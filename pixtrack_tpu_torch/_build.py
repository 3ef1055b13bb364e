"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by nvcc for Hopper (``sm_90a``) into a
shared library with a plain C interface, under ``build/kernels/<hash>/`` at
the repository root; the hash covers the source and the flags, so an edited
kernel rebuilds and an unchanged one loads from the cache.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "kernels"
# -fmad=false: a multiply and an add stay two roundings, as in the plain
# PyTorch versions (explicit fmaf() calls are unaffected), so that the
# inputs the kernels round to bf16 match theirs bit for bit
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded = {}
# name -> {"seconds": build time (0.0 from the cache), "log": nvcc/ptxas output}
build_info = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it."""
    if name in _loaded:
        return _loaded[name]
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _BUILD_ROOT / digest
    lib_path = out_dir / f"lib{name}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
        (out_dir / f"{name}.log").write_text(log)
        os.replace(tmp, lib_path)
        seconds = time.perf_counter() - t0
    else:
        seconds = 0.0
    log_file = out_dir / f"{name}.log"
    build_info[name] = {
        "seconds": seconds,
        "log": log_file.read_text() if log_file.exists() else "",
    }
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib
