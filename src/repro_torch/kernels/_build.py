"""Build a kernel's CUDA sources with ``nvcc`` into a shared library with a
plain C interface, and load it with ``ctypes``.

The library goes into ``build/`` at the root of the checkout, named by a
hash of the sources and flags, so the first call after a change builds it
and later calls (in this process or another) load it.  Nothing here runs
at import time, and a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """The CUDA compiler that PyTorch's own extension builder would use."""
    from torch.utils.cpp_extension import CUDA_HOME  # resolves CUDA_HOME / PATH
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
            "CUDA kernels are built from source at first use")
    return nvcc


def library_path(name: str, sources: Sequence[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Compile ``sources`` (once per content hash) and load the library.
    The compiler's output, with ptxas's register and spill counts, is kept
    beside it as ``<library>.log``."""
    out = library_path(name, sources)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
