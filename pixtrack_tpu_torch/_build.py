"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by nvcc for Hopper (``sm_90a``) into a
shared library with a plain C interface, under ``build/kernels/<hash>/`` at
the repository root; the hash covers the source, the headers it may include
(every ``csrc/*.cuh``) and the flags, so an edited kernel or header rebuilds
and an unchanged one loads from the cache.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

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


def _out_dir(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / h.hexdigest()[:16]


def load_libraries(names: Sequence[str]) -> None:
    """Compile every ``csrc/<name>.cu`` whose build is missing, one nvcc per
    source, all started together, then load them all."""
    names = [n for n in names if n not in _loaded]
    started = {}
    t0 = time.perf_counter()
    for name in names:
        out_dir = _out_dir(name)
        if (out_dir / f"lib{name}.so").exists():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in started.items():
        log, _ = proc.communicate()
        out_dir = _out_dir(name)
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}.cu:\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    for name in names:
        out_dir = _out_dir(name)
        log_file = out_dir / f"{name}.log"
        build_info[name] = {
            "seconds": seconds if name in started else 0.0,
            "log": log_file.read_text() if log_file.exists() else "",
        }
        _loaded[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it."""
    load_libraries([name])
    return _loaded[name]
