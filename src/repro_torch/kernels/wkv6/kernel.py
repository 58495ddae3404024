"""WKV6 forward — the hand-written CUDA kernel for Hopper.

``wkv6_fwd`` is the twin of the Pallas TPU kernel
``repro.kernels.wkv6.kernel.wkv6_fwd``; the design and its bound are set
out in ``csrc/wkv6_fwd.cu``.  It takes CUDA tensors only and raises on
anything the kernel does not take; the CPU path is ``ref.wkv6_ref``, chosen
by ``ops.wkv6``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels._build import build_library

# the rwkv6 configs' head size, and the JAX kernel's test sweep
SUPPORTED_HEAD_DIMS = (16, 32, 64)
SOURCES = (Path(__file__).parent / "csrc" / "wkv6_fwd.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset: one per successful launch, so a run
# can show that its main path went through the kernel.
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build_library("wkv6_fwd", SOURCES)
    fn = lib.repro_wkv6_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_wkv6_error_string.argtypes = [ctypes.c_int]
    lib.repro_wkv6_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_wkv6_error_string


def build() -> None:
    """Build (or load) the kernel's library now rather than at first use."""
    _entry()


def _check(r, k, v, w, u, s0) -> None:
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"wkv6_fwd takes CUDA tensors; {name} is on "
                             f"{t.device}")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("r, k, v, w, u, s0 must lie on one device")
    if r.dtype not in _DTYPE_CODES:
        raise ValueError(f"r dtype {r.dtype} not supported (float32, bfloat16)")
    if not r.dtype == k.dtype == v.dtype:
        raise ValueError("r, k, v must share one dtype")
    for name, t in (("w", w), ("u", u), ("s0", s0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r must be 4-D (B, H, S, hd), got {tuple(r.shape)}")
    B, H, S, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != r's "
                             f"{tuple(r.shape)}")
    for name, t in named[:4]:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim must be contiguous")
    if u.shape != (H, hd) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous ({H}, {hd}), got "
                         f"{tuple(u.shape)}")
    if s0.shape != (B, H, hd, hd) or not s0.is_contiguous():
        raise ValueError(f"s0 must be a contiguous ({B}, {H}, {hd}, {hd}), "
                         f"got {tuple(s0.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported; the kernel is built "
                         f"for {SUPPORTED_HEAD_DIMS}")
    if S < 1 or B < 1 or H < 1:
        raise ValueError(f"empty wkv6 input {tuple(r.shape)}")


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, H, S, hd) fp32 or bf16; w: (B, H, S, hd) fp32; u: (H, hd)
    fp32; s0: (B, H, hd, hd) fp32, rows the key dim.  r, k, v, w may have any
    strides with a contiguous last dim.  Returns (y (B, H, S, hd) fp32 in
    r's memory layout, final state (B, H, hd, hd) fp32)."""
    global LAUNCHES
    _check(r, k, v, w, u, s0)
    B, H, S, hd = r.shape
    y = torch.empty_like(r, dtype=torch.float32)
    sT = torch.empty_like(s0)
    strides = (ctypes.c_int64 * 15)(*r.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *w.stride()[:3],
                                    *y.stride()[:3])
    fn, err_string = _entry()
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
             _DTYPE_CODES[r.dtype], B, H, S, hd, strides, r.device.index,
             torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: "
                           f"{err_string(err).decode()} ({err})")
    LAUNCHES += 1
    return y, sT
