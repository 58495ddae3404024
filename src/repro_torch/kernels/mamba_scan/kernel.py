"""Mamba selective scan forward — the hand-written CUDA kernel for Hopper.

``mamba_scan_fwd`` is the twin of the Pallas TPU kernel
``repro.kernels.mamba_scan.kernel.mamba_scan_fwd``; the design and its
bound are set out in ``csrc/mamba_scan_fwd.cu``.  It takes CUDA tensors
only and raises on anything the kernel does not take; the CPU path is
``ref.mamba_scan_ref``, chosen by ``ops.mamba_scan``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels._build import build_library

# jamba's d_state (16), the smoke config's (4), and the JAX kernel's sweep
SUPPORTED_D_STATES = (4, 8, 16)
SOURCES = (Path(__file__).parent / "csrc" / "mamba_scan_fwd.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset: one per successful launch, so a run
# can show that its main path went through the kernel.
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build_library("mamba_scan_fwd", SOURCES)
    fn = lib.repro_mamba_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_mamba_scan_error_string.argtypes = [ctypes.c_int]
    lib.repro_mamba_scan_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_mamba_scan_error_string


def build() -> None:
    """Build (or load) the kernel's library now rather than at first use."""
    _entry()


def _check(u, dt, A, Bc, Cc, D, h0) -> None:
    named = (("u", u), ("dt", dt), ("A", A), ("Bc", Bc), ("Cc", Cc),
             ("D", D), ("h0", h0))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"mamba_scan_fwd takes CUDA tensors; {name} is "
                             f"on {t.device}")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("u, dt, A, Bc, Cc, D, h0 must lie on one device")
    if u.dtype not in _DTYPE_CODES:
        raise ValueError(f"u dtype {u.dtype} not supported (float32, bfloat16)")
    if not u.dtype == dt.dtype == Bc.dtype == Cc.dtype:
        raise ValueError("u, dt, Bc, Cc must share one dtype")
    for name, t in (("A", A), ("D", D), ("h0", h0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if u.dim() != 3:
        raise ValueError(f"u must be 3-D (B, S, di), got {tuple(u.shape)}")
    B, S, di = u.shape
    if B < 1 or S < 1 or di < 1:
        raise ValueError(f"empty mamba_scan input {tuple(u.shape)}")
    if dt.shape != u.shape:
        raise ValueError(f"dt shape {tuple(dt.shape)} != u's {tuple(u.shape)}")
    for name, t in (("u", u), ("dt", dt)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if A.dim() != 2 or A.shape[0] != di or not A.is_contiguous():
        raise ValueError(f"A must be a contiguous ({di}, ds), got "
                         f"{tuple(A.shape)}")
    ds = A.shape[1]
    if ds not in SUPPORTED_D_STATES:
        raise ValueError(f"d_state {ds} not supported; the kernel is built "
                         f"for {SUPPORTED_D_STATES}")
    for name, t in (("Bc", Bc), ("Cc", Cc)):
        if t.shape != (B, S, ds):
            raise ValueError(f"{name} must be ({B}, {S}, {ds}), got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s state dim must be contiguous")
    if D.shape != (di,) or not D.is_contiguous():
        raise ValueError(f"D must be a contiguous ({di},), got {tuple(D.shape)}")
    if h0.shape != (B, di, ds) or not h0.is_contiguous():
        raise ValueError(f"h0 must be a contiguous ({B}, {di}, {ds}), got "
                         f"{tuple(h0.shape)}")


def mamba_scan_fwd(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: contiguous (B, S, di) fp32 or bf16; A: (di, ds) fp32; Bc, Cc:
    (B, S, ds) in u's dtype, any strides with a contiguous last dim; D:
    (di,) fp32; h0: (B, di, ds) fp32.  Returns (y (B, S, di) fp32, final
    state (B, di, ds) fp32)."""
    global LAUNCHES
    _check(u, dt, A, Bc, Cc, D, h0)
    B, S, di = u.shape
    ds = A.shape[1]
    y = torch.empty((B, S, di), dtype=torch.float32, device=u.device)
    hT = torch.empty_like(h0)
    strides = (ctypes.c_int64 * 4)(*Bc.stride()[:2], *Cc.stride()[:2])
    fn, err_string = _entry()
    err = fn(u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
             Cc.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
             hT.data_ptr(), _DTYPE_CODES[u.dtype], B, S, di, ds, strides,
             u.device.index, torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_fwd launch failed: "
                           f"{err_string(err).decode()} ({err})")
    LAUNCHES += 1
    return y, hT
