"""WKV6 forward — the hand-written CUDA kernel for Hopper.

``wkv6_fwd`` is the twin of the Pallas TPU kernel
``repro.kernels.wkv6.kernel.wkv6_fwd``; the design and its bound are set
out in ``csrc/wkv6_fwd.cu``.  It takes CUDA tensors only and raises on
anything the kernel does not take; the CPU path is ``ref.wkv6_ref``, chosen
by ``ops.wkv6``.  ``launch_config`` (pure Python) picks the kernel's
micro-tile, column split, tile length and ring depth for a shape.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels._build import build_library

# the rwkv6 configs' head size, and the JAX kernel's test sweep
SUPPORTED_HEAD_DIMS = (16, 32, 64)
SOURCES = (Path(__file__).parent / "csrc" / "wkv6_fwd.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# (rows R, columns C) of the state a thread keeps in registers, in order of
# preference; each is instantiated in csrc/wkv6_fwd.cu
MICRO_TILES = ((8, 4), (4, 4), (4, 2))
MIN_BLOCKS = 128   # split a head's columns until the grid has this many blocks
MIN_THREADS = 128  # compute threads a block the preferred micro-tile must reach
HELPERS = 128      # a block's helper threads (tile ring, a_t, y), as in the .cu
TILE = 32          # steps a tile (fewer when S is shorter)
STAGES = 4         # ring depth: two tiles in flight while one is computed
SMEM_LIMIT = 232_448  # dynamic shared memory an H100 block may use

# Kernel launches since the last reset: one per successful launch, so a run
# can show that its main path went through the kernel.
LAUNCHES = 0


class LaunchConfig(NamedTuple):
    rows: int     # micro-tile rows R
    cols: int     # micro-tile columns C
    nj: int       # column groups a head's hd value columns are split over
    tile: int     # steps staged a tile
    stages: int   # tiles in the ring
    threads: int  # threads a block: compute threads in whole warps + HELPERS
    smem: int     # dynamic shared memory a block, bytes
    blocks: int   # blocks in the grid


def smem_bytes(hd: int, itemsize: int, rows: int, nj: int, tile: int,
               stages: int) -> int:
    """A block's shared memory (the layout in ``csrc/wkv6_fwd.cu``): the
    ring of r, k, v (``itemsize``) and w tiles, and two tiles each of y
    partials and of a_t."""
    return (stages * tile * hd * (3 * itemsize + 4)
            + 2 * tile * (hd // rows) * (hd // nj) * 4 + 2 * tile * 4)


def make_config(B: int, H: int, hd: int, dtype: torch.dtype,
                micro_tile: Tuple[int, int], nj: int, tile: int,
                stages: int) -> LaunchConfig:
    """The launch of ``micro_tile`` (R, C) over ``nj`` column groups, with
    tiles of ``tile`` steps in a ring of ``stages``; raises where the kernel
    does not take it."""
    R, C = micro_tile
    if micro_tile not in MICRO_TILES:
        raise ValueError(f"micro-tile {micro_tile} not among {MICRO_TILES}")
    if nj not in (1, 2, 4, 8, 16) or 4 * nj > hd or (hd // nj) % C:
        raise ValueError(f"nj {nj} does not split head_dim {hd} for {micro_tile}")
    if tile < 1 or stages not in (3, 4):
        raise ValueError(f"tile {tile}, stages {stages}")
    smem = smem_bytes(hd, dtype.itemsize, R, nj, tile, stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{smem} bytes of shared memory exceed {SMEM_LIMIT}")
    compute = (hd // R) * (hd // nj // C)
    return LaunchConfig(R, C, nj, tile, stages, -(-compute // 32) * 32 + HELPERS,
                        smem, B * H * nj)


@functools.lru_cache(maxsize=256)
def launch_config(B: int, H: int, S: int, hd: int,
                  dtype: torch.dtype) -> LaunchConfig:
    """The kernel's launch for r/k/v of shape (B, H, S, hd) in ``dtype``.

    A head's value columns are split over NJ blocks (a power of two, at
    most hd/4) until the grid has ``MIN_BLOCKS``; then the first micro-tile
    of ``MICRO_TILES`` that gives a block ``MIN_THREADS`` compute threads,
    else the one that gives the most; tiles of ``TILE`` steps (S if
    shorter) in a ring ``STAGES`` deep, or one stage less where that does
    not fit the block's shared memory (fp32 r/k/v at hd 64)."""
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported; the kernel is built "
                         f"for {SUPPORTED_HEAD_DIMS}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"r dtype {dtype} not supported (float32, bfloat16)")
    if min(B, H, S) < 1:
        raise ValueError(f"empty wkv6 input {(B, H, S, hd)}")
    nj = 1
    while B * H * nj < MIN_BLOCKS and nj < hd // 4:
        nj *= 2
    cb = hd // nj

    def threads(rc):  # compute threads
        return (hd // rc[0]) * (cb // rc[1])

    fits = [rc for rc in MICRO_TILES if cb % rc[1] == 0]
    rc = next((rc for rc in fits if threads(rc) >= MIN_THREADS),
              max(fits, key=threads))
    tile = min(TILE, S)
    stages = STAGES
    if smem_bytes(hd, dtype.itemsize, rc[0], nj, tile, stages) > SMEM_LIMIT:
        stages -= 1
    return make_config(B, H, hd, dtype, rc, nj, tile, stages)


def copy_bytes(r, k, v, w) -> int:
    """The widest cp.async chunk (16, 8, 4 or 2 bytes) that every row of r,
    k, v (one dtype) and w (fp32), all of one shape, starts on: the largest
    power of two up to 16 dividing the data pointers and the byte strides
    of the outer dims longer than 1 (a row, hd contiguous elements, is 32
    bytes or more).  Written out for four tensors: it runs at every decode
    step."""
    rs, ks, vs, ws = r.stride(), k.stride(), v.stride(), w.stride()
    bits = r.data_ptr() | k.data_ptr() | v.data_ptr() | w.data_ptr()
    for d in range(3):
        if r.shape[d] > 1:
            bits |= (rs[d] | ks[d] | vs[d]) * r.element_size() | ws[d] * 4
    return 16 if bits % 16 == 0 else bits & -bits


@functools.lru_cache(maxsize=256)
def _config_words(cfg: LaunchConfig, chunk: int):
    """The C entry point's launch configuration, as it reads it."""
    return (ctypes.c_int * 7)(cfg.rows, cfg.cols, cfg.nj, cfg.tile, cfg.stages,
                              chunk, cfg.smem)


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build_library("wkv6_fwd", SOURCES)
    fn = lib.repro_wkv6_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_wkv6_error_string.argtypes = [ctypes.c_int]
    lib.repro_wkv6_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_wkv6_error_string


def build() -> None:
    """Build (or load) the kernel's library now rather than at first use."""
    _entry()


def _check(r, k, v, w, u, s0) -> None:
    """Raise ValueError on what the kernel does not take.  The usual call
    passes every test at once; the loops only name the offender."""
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0))
    if not (r.is_cuda and k.is_cuda and v.is_cuda and w.is_cuda and u.is_cuda
            and s0.is_cuda):
        for name, t in named:
            if not t.is_cuda:
                raise ValueError(f"wkv6_fwd takes CUDA tensors; {name} is on "
                                 f"{t.device}")
    dev = r.get_device()
    if not (k.get_device() == v.get_device() == w.get_device() == u.get_device()
            == s0.get_device() == dev):
        raise ValueError("r, k, v, w, u, s0 must lie on one device")
    if r.dtype not in _DTYPE_CODES:
        raise ValueError(f"r dtype {r.dtype} not supported (float32, bfloat16)")
    if not r.dtype == k.dtype == v.dtype:
        raise ValueError("r, k, v must share one dtype")
    if not w.dtype == u.dtype == s0.dtype == torch.float32:
        for name, t in (("w", w), ("u", u), ("s0", s0)):
            if t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32, got {t.dtype}")
    shape = r.shape
    if len(shape) != 4:
        raise ValueError(f"r must be 4-D (B, H, S, hd), got {tuple(shape)}")
    if not k.shape == v.shape == w.shape == shape:
        for name, t in (("k", k), ("v", v), ("w", w)):
            if t.shape != shape:
                raise ValueError(f"{name} shape {tuple(t.shape)} != r's "
                                 f"{tuple(shape)}")
    if not r.stride(-1) == k.stride(-1) == v.stride(-1) == w.stride(-1) == 1:
        for name, t in named[:4]:
            if t.stride(-1) != 1:
                raise ValueError(f"{name}'s head_dim must be contiguous")
    B, H, S, hd = shape
    if u.shape != (H, hd) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous ({H}, {hd}), got "
                         f"{tuple(u.shape)}")
    if s0.shape != (B, H, hd, hd) or not s0.is_contiguous():
        raise ValueError(f"s0 must be a contiguous ({B}, {H}, {hd}, {hd}), "
                         f"got {tuple(s0.shape)}")


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, H, S, hd) fp32 or bf16; w: (B, H, S, hd) fp32; u: (H, hd)
    fp32; s0: (B, H, hd, hd) fp32, rows the key dim.  r, k, v, w may have any
    strides with a contiguous last dim.  Returns (y (B, H, S, hd) fp32 in
    r's memory layout, final state (B, H, hd, hd) fp32).  The kernel would
    also take sT aliasing s0; this wrapper allocates it."""
    _check(r, k, v, w, u, s0)
    B, H, S, hd = r.shape
    return launch(r, k, v, w, u, s0, launch_config(B, H, S, hd, r.dtype))


def launch(r, k, v, w, u, s0, cfg: LaunchConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv6_fwd`` with the launch configuration given (``wkv6_fwd`` takes
    ``launch_config``'s; a sweep may pass another); inputs as checked by
    ``wkv6_fwd``."""
    global LAUNCHES
    B, H, S, hd = r.shape
    y = torch.empty_like(r, dtype=torch.float32)
    sT = torch.empty_like(s0)
    strides = (ctypes.c_int64 * 15)(*r.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *w.stride()[:3],
                                    *y.stride()[:3])
    fn, err_string = _entry()
    dev = r.get_device()
    # the current stream's handle as PyTorch's generated kernels fetch it,
    # without building a Stream object: a decode step launches K3 24 times
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
             _DTYPE_CODES[r.dtype], B, H, S, hd, strides,
             _config_words(cfg, copy_bytes(r, k, v, w)), dev, stream)
    if err != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: "
                           f"{err_string(err).decode()} ({err})")
    LAUNCHES += 1
    return y, sT
