"""Flash attention forward — the hand-written CUDA kernel for Hopper.

``flash_attention_fwd`` is the twin of the Pallas TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_fwd``.  The library
holds two bodies, chosen by dtype: bf16 runs on the tensor cores
(``wgmma``, K/V tiles by TMA, a producer warp and a ring of stages), fp32
stays exact fp32 on the CUDA cores (register-tiled, ``cp.async``); the
design and its bound are set out in ``csrc/flash_attention_fwd.cu``.  It
takes CUDA tensors only and raises on anything the kernel does not take,
among them views whose pointer or strides TMA cannot address
(``layout_error``); the CPU path is ``ref.attention_ref``, chosen by
``ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Sequence

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


def layout_error(name: str, shape: Sequence[int], strides: Sequence[int],
                 itemsize: int, ptr: int) -> Optional[str]:
    """Why the kernel cannot read the (B, heads, S, hd) view ``name``, or
    None if it can.  Both bodies read 16-byte pieces (TMA boxes in bf16,
    ``cp.async`` in fp32): head_dim must be contiguous, and the data pointer
    and every stride of a dim longer than 1, in bytes, multiples of 16 (TMA
    also takes no stride of 2**40 bytes or more)."""
    if shape[-1] > 1 and strides[-1] != 1:
        return f"{name}'s head_dim must be contiguous (stride {strides[-1]})"
    if ptr % 16:
        return (f"{name}'s data pointer is {ptr % 16} bytes past a 16-byte "
                f"boundary")
    for dim, (n, st) in enumerate(zip(shape[:-1], strides[:-1])):
        nbytes = st * itemsize
        if n > 1 and (nbytes % 16 or nbytes >= 2 ** 40):
            return (f"{name}'s stride along dim {dim} is {nbytes} bytes, not a "
                    f"multiple of 16 below 2**40")
    return None


def kernel_strides(shape: Sequence[int], strides: Sequence[int]) -> list:
    """The (batch, head, seq) strides handed to the kernel: a dim of size 1
    is never stepped along, so its stride, which TMA still checks, becomes
    the contiguous one."""
    out, inner = [], shape[-1]
    for n, st in zip(reversed(shape[:-1]), reversed(strides[:-1])):
        out.append(st if n > 1 else inner)
        inner *= n
    return out[::-1]


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        err = layout_error(name, t.shape, t.stride(), t.element_size(),
                           t.data_ptr())
        if err is not None:
            raise ValueError(err)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd), on the card, fp32 or bf16.
    Any strides that ``layout_error`` accepts.  Returns (B, H, S, hd) in q's
    dtype and in q's memory layout."""
    global LAUNCHES
    _check(q, k, v)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    o = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, o) for st in
                                      kernel_strides(t.shape, t.stride())))
    fn, err_string = _entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _DTYPE_CODES[q.dtype], B, H, KV, S, hd, int(causal), strides,
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{err_string(err).decode()} ({err})")
    LAUNCHES += 1
    return o
