"""Mamba selective scan forward — the hand-written CUDA kernel for Hopper.

``mamba_scan_fwd`` is the twin of the Pallas TPU kernel
``repro.kernels.mamba_scan.kernel.mamba_scan_fwd``; the design and its
bound are set out in ``csrc/mamba_scan_fwd.cu``.  It takes CUDA tensors
only and raises on anything the kernel does not take; the CPU path is
``ref.mamba_scan_ref``, chosen by ``ops.mamba_scan``.  ``launch_config``
(pure Python) picks the exps on the polynomial, the block size and the
ring's stage length for a shape; ``exp2_poly`` is the
kernel's polynomial 2^x, step for step.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels._build import build_library

# jamba's d_state (16), the smoke config's (4), and the JAX kernel's sweep
SUPPORTED_D_STATES = (4, 8, 16)
SOURCES = (Path(__file__).parent / "csrc" / "mamba_scan_fwd.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# 2^f on [-1/2, 1/2] as 1 + f (c1 + f (c2 + f (c3 + f (c4 + f c5)))): the
# literals EXP2_C1..EXP2_C5 of csrc/mamba_scan_fwd.cu, in that order
EXP2_POLY = (6.931470037e-01, 2.402224243e-01, 5.550733581e-02,
             9.671512991e-03, 1.326472848e-03)
ROUND_MAGIC = 12582912.0  # 1.5 * 2^23: x + this rounds x to an integer

# The instantiated launches (d_state, KP, threads), as the dispatch of
# csrc/mamba_scan_fwd.cu lists them: KP of each channel's d_state exps run
# on the polynomial; a block is 128 threads, or 512 (all the warps an SM
# holds, kept in step).  d_state 4 and 8 have one launch each.
CANDIDATES = ((16, 1, 512), (16, 0, 512), (16, 0, 128), (8, 0, 128),
              (4, 0, 128))
TILES = (32, 16)      # steps of u and dt a ring stage holds (divide bc_tile)
SMEM_LIMIT = 232_448  # dynamic shared memory an H100 block may use
SMS = 132             # an H100 SXM's SMs

# Kernel launches since the last reset: one per successful launch, so a run
# can show that its main path went through the kernel.
LAUNCHES = 0


class LaunchConfig(NamedTuple):
    poly: int     # KP: each channel's exps on the polynomial
    threads: int  # threads a block
    tile: int     # steps of u and dt a stage of a warp's two-stage ring holds
    smem: int     # dynamic shared memory a block, bytes
    blocks: int   # blocks in the grid


def bc_tile(threads: int) -> int:
    """Steps of B and C a block stages at once (its barrier interval), as
    the .cu's ``bc_tile``: 128 in a 512-thread block, else 32."""
    return 128 if threads == 512 else 32


def smem_bytes(threads: int, itemsize: int, ds: int, tile: int) -> int:
    """A block's shared memory (the layout in ``csrc/mamba_scan_fwd.cu``):
    per warp, two stages of ``tile`` steps of its 32 channels of u and dt
    (``itemsize`` bytes each); two buffers of ``bc_tile`` steps of B and C
    in fp32."""
    return (threads // 32 * 2 * tile * 2 * 32 * itemsize
            + 2 * 2 * bc_tile(threads) * ds * 4)


def make_config(B: int, di: int, ds: int, dtype: torch.dtype, poly: int,
                threads: int, tile: int) -> LaunchConfig:
    """The launch with ``poly`` exps a channel on the polynomial, in blocks
    of ``threads``, with ring stages of ``tile`` steps; raises where the
    kernel does not take it."""
    if (ds, poly, threads) not in CANDIDATES:
        raise ValueError(f"(d_state, KP, threads) = {(ds, poly, threads)} "
                         f"is not instantiated; see CANDIDATES")
    if tile not in TILES:
        raise ValueError(f"tile {tile} not among {TILES}")
    smem = smem_bytes(threads, dtype.itemsize, ds, tile)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{smem} bytes of shared memory exceed {SMEM_LIMIT}")
    return LaunchConfig(poly, threads, tile, smem, B * -(-di // threads))


@functools.lru_cache(maxsize=256)
def launch_config(B: int, S: int, di: int, ds: int,
                  dtype: torch.dtype) -> LaunchConfig:
    """The kernel's launch for u of shape (B, S, di), d_state ``ds``, in
    ``dtype``, as ``sweep.py`` measured it fastest: ring stages of 32
    steps of bf16 or 16 of fp32 (four 128-thread blocks, or one of 512,
    fit an SM).  Blocks of 512 threads, at either dtype, where the grid of
    them fills nine tenths of the SMs in one wave and the scan is longer
    than a B/C tile; else 128.  In 512-thread blocks of bf16 one exp a
    channel runs on the polynomial (KP = 1, a little faster there; slower
    at fp32); every other launch keeps all exps on the special-function
    unit."""
    if ds not in SUPPORTED_D_STATES:
        raise ValueError(f"d_state {ds} not supported; the kernel is built "
                         f"for {SUPPORTED_D_STATES}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"u dtype {dtype} not supported (float32, bfloat16)")
    if min(B, S, di) < 1:
        raise ValueError(f"empty mamba_scan input {(B, S, di)}")
    tile = 32 if dtype == torch.bfloat16 else 16
    wide = ds == 16 and S > 128 and 0.9 * SMS <= B * -(-di // 512) <= SMS
    poly = int(wide and dtype == torch.bfloat16)
    return make_config(B, di, ds, dtype, poly, 512 if wide else 128, tile)


def copy_bytes(u: torch.Tensor, dt: torch.Tensor) -> int:
    """The widest copy chunk (16, 8, 4 or 2 bytes) that every step's row of
    u and dt starts on: the largest power of two up to 16 dividing both
    data pointers and di's bytes."""
    bits = u.data_ptr() | dt.data_ptr() | u.shape[-1] * u.element_size()
    return 16 if bits % 16 == 0 else bits & -bits


def exp2_poly(x: torch.Tensor) -> torch.Tensor:
    """2^x of fp32 ``x`` by the kernel's polynomial: on a CUDA tensor the
    kernel's own ``exp2_poly`` (one launch of a small elementwise kernel,
    not counted in ``LAUNCHES``); on the CPU the same steps in fp32: x
    clamped to [-127, 128], n = rint(x) by adding ``ROUND_MAGIC``, f = x -
    n, the polynomial in f by fp32 FMAs (each an exact fp64 product and
    sum, rounded once to fp32), and n added to the exponent field."""
    if x.is_cuda:
        x = x.float().contiguous()
        y = torch.empty_like(x)
        dev = x.get_device()
        err = _entry()[2](x.data_ptr(), y.data_ptr(), x.numel(), dev,
                          torch._C._cuda_getCurrentRawStream(dev))
        if err != 0:
            raise RuntimeError(f"exp2_poly launch failed: "
                               f"{_entry()[1](err).decode()} ({err})")
        return y
    x = x.float().clamp(-127.0, 128.0)
    j = x + ROUND_MAGIC
    f = x - (j - ROUND_MAGIC)
    f64 = f.double()
    p = torch.full_like(f, EXP2_POLY[-1])
    for c in (*EXP2_POLY[-2::-1], 1.0):
        p = (p.double() * f64 + c).float()
    n = (j - ROUND_MAGIC).to(torch.int32)
    return (p.view(torch.int32) + (n << 23)).view(torch.float32)


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build_library("mamba_scan_fwd", SOURCES)
    fn = lib.repro_mamba_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_mamba_scan_error_string.argtypes = [ctypes.c_int]
    lib.repro_mamba_scan_error_string.restype = ctypes.c_char_p
    poly = lib.repro_mamba_scan_exp2_poly
    poly.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p]
    poly.restype = ctypes.c_int
    return fn, lib.repro_mamba_scan_error_string, poly


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
    _check(u, dt, A, Bc, Cc, D, h0)
    B, S, di = u.shape
    ds = A.shape[1]
    return launch(u, dt, A, Bc, Cc, D, h0, launch_config(B, S, di, ds, u.dtype))


@functools.lru_cache(maxsize=256)
def _config_words(cfg: LaunchConfig, chunk: int):
    """The C entry point's launch configuration, as it reads it."""
    return (ctypes.c_int * 4)(cfg.poly, cfg.threads, cfg.tile, chunk)


def launch(u, dt, A, Bc, Cc, D, h0, cfg: LaunchConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mamba_scan_fwd`` with the launch configuration given
    (``mamba_scan_fwd`` takes ``launch_config``'s; a sweep may pass
    another); inputs as checked by ``mamba_scan_fwd``."""
    global LAUNCHES
    B, S, di = u.shape
    y = torch.empty((B, S, di), dtype=torch.float32, device=u.device)
    hT = torch.empty_like(h0)
    strides = (ctypes.c_int64 * 4)(*Bc.stride()[:2], *Cc.stride()[:2])
    chunk = copy_bytes(u, dt)
    fn, err_string, _ = _entry()
    dev = u.get_device()
    err = fn(u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
             Cc.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
             hT.data_ptr(), _DTYPE_CODES[u.dtype], B, S, di, A.shape[1],
             strides, _config_words(cfg, chunk), dev,
             torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"mamba_scan_fwd launch failed: "
                           f"{err_string(err).decode()} ({err})")
    LAUNCHES += 1
    return y, hT
