"""Flash attention forward — the hand-written CUDA kernel for Hopper.

``flash_attention_fwd`` is the twin of the Pallas TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_fwd``; the design
and its bound are set out in ``csrc/flash_attention_fwd.cu``.  It takes
CUDA tensors only and raises on anything the kernel does not take; the
CPU path is ``ref.attention_ref``, chosen by ``ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library

# every head_dim in the configs, and 32 for the JAX kernel's test sweep
SUPPORTED_HEAD_DIMS = (16, 24, 32, 64, 128, 160, 192)
SOURCES = (Path(__file__).parent / "csrc" / "flash_attention_fwd.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset: one per successful launch, so a run
# can show that its main path went through the kernel.
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build_library("flash_attention_fwd", SOURCES)
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def build() -> None:
    """Build (or load) the kernel's library now rather than at first use."""
    _entry()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_fwd takes CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} dtype {t.dtype} not supported "
                             f"(float32, bfloat16)")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim must be contiguous")
    if not (q.device == k.device == v.device and q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one device and one dtype")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if k.shape != v.shape or k.shape != (B, KV, S, hd):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if KV == 0 or H % KV != 0:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported; the kernel is built "
                         f"for {SUPPORTED_HEAD_DIMS}")
    if S < 1 or B < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd), on the card, fp32 or bf16.
    Any strides with a contiguous last dim.  Returns (B, H, S, hd) in q's
    dtype and in q's memory layout."""
    global LAUNCHES
    _check(q, k, v)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    o = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *o.stride()[:3])
    fn, err_string = _entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _DTYPE_CODES[q.dtype], B, H, KV, S, hd, int(causal), strides,
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{err_string(err).decode()} ({err})")
    LAUNCHES += 1
    return o
