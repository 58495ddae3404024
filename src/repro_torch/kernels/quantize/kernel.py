"""Fused int8 quantize + error feedback — the hand-written CUDA kernel for
Hopper.

``quantize_ef_fwd`` is the twin of the Pallas TPU kernel
``repro.kernels.quantize.kernel.quantize_ef_fwd``; the design and its bound
are set out in ``csrc/quantize_ef_fwd.cu``.  It takes CUDA tensors only and
raises on anything the kernel does not take; the CPU path is
``ref.quantize_ef_ref``, chosen by ``ops.quantize_ef``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels._build import build_library

# the codec's default block (2048) and the JAX kernel's test sweep
SUPPORTED_BLOCKS = (128, 512, 2048)
SOURCES = (Path(__file__).parent / "csrc" / "quantize_ef_fwd.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset: one per successful launch, so a run
# can show that its main path went through the kernel.
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build_library("quantize_ef_fwd", SOURCES)
    fn = lib.repro_quantize_ef_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_quantize_ef_error_string.argtypes = [ctypes.c_int]
    lib.repro_quantize_ef_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_quantize_ef_error_string


def build() -> None:
    """Build (or load) the kernel's library now rather than at first use."""
    _entry()


def _check(x: torch.Tensor, block: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"quantize_ef_fwd takes CUDA tensors; x is on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 1-D tensor, got shape "
                         f"{tuple(x.shape)}")
    if block not in SUPPORTED_BLOCKS:
        raise ValueError(f"block {block} not supported; the kernel is built "
                         f"for {SUPPORTED_BLOCKS}")
    n = x.shape[0]
    if n < 1 or n % block:
        raise ValueError(f"n={n} must be a positive multiple of block={block}")


def quantize_ef_fwd(x: torch.Tensor, *, block: int = 2048
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: contiguous (n,) fp32 or bf16 on the card, n % block == 0.  Returns
    (q (n,) int8, scales (n/block,) fp32, err (n,) fp32), bit-equal to
    ``ref.quantize_ef_ref``."""
    global LAUNCHES
    _check(x, block)
    n = x.shape[0]
    q = torch.empty((n,), dtype=torch.int8, device=x.device)
    scales = torch.empty((n // block,), dtype=torch.float32, device=x.device)
    err = torch.empty((n,), dtype=torch.float32, device=x.device)
    aligned = x.data_ptr() % (4 * x.element_size()) == 0
    fn, err_string = _entry()
    code = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), err.data_ptr(),
              _DTYPE_CODES[x.dtype], n // block, block, int(aligned),
              x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"quantize_ef_fwd launch failed: "
                           f"{err_string(code).decode()} ({code})")
    LAUNCHES += 1
    return q, scales, err
