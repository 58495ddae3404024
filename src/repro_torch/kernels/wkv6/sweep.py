"""Time the WKV6 kernel's launch candidates on the card.

    PYTHONPATH=src python -m repro_torch.kernels.wkv6.sweep

At the shapes the rwkv6-1.6b path gives the kernel (prefill B=4 and B=1,
S=2048, bf16 and fp32; a decode step of 8 slots), launches every
micro-tile of ``MICRO_TILES`` with tiles of 32, 24, 16 and 8 steps in a
ring of 4 or 3 stages (and, at B=1, every column split), checks y
and sT against the plain version with ``chip_smoke.py``'s tolerance, and
prints each launch's time between CUDA events over 20 calls (as
``chip_smoke.py`` times it), marking ``launch_config``'s own pick.  For the
pick it also prints the device time alone, from a CUDA graph of 20
launches replayed: at a decode step the host's launch path, not the
kernel, sets the first number.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

from repro_torch.kernels.wkv6 import kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref

SHAPES = [  # name, B, H, S, hd, r/k/v dtype
    ("main-bf16", 4, 32, 2048, 64, torch.bfloat16),
    ("main-fp32", 4, 32, 2048, 64, torch.float32),
    ("prefill-B1", 1, 32, 2048, 64, torch.bfloat16),
    ("decode-S1", 8, 32, 1, 64, torch.bfloat16),
]


def device_ms(fn, iters: int = 20, repeats: int = 3) -> float:
    """Median over ``repeats`` of the mean device time of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Median device time of one call, from a CUDA graph of ``iters`` calls
    replayed ``repeats`` times (no host work between launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def inputs(gen, B, H, S, hd, dtype):
    """Drawn as chip_smoke.py's check_wkv6 draws them: (B, S, H, hd) memory
    viewed as (B, H, S, hd)."""
    def draw(scale=1.0):
        return (torch.randn(B, S, H, hd, generator=gen, device="cuda") * scale
                ).transpose(1, 2)
    r, k, v = draw().to(dtype), draw().to(dtype), draw().to(dtype)
    w = torch.exp(-torch.exp(draw(0.5)))
    u = torch.randn(H, hd, generator=gen, device="cuda") * 0.1
    s0 = torch.randn(B, H, hd, hd, generator=gen, device="cuda") * 0.1
    return r, k, v, w, u, s0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep.py: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[sweep] {card}", flush=True)
    kernel.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, B, H, S, hd, dtype in SHAPES:
        args = inputs(gen, B, H, S, hd, dtype)
        ey, es = wkv6_ref(*args)
        atol = 2e-5 * (ey.abs().max().item() + 1.0)
        pick = kernel.launch_config(B, H, S, hd, dtype)
        splits = (1, 2, 4, 8) if B * H < kernel.MIN_BLOCKS else (pick.nj,)
        tiles = sorted({min(t, S) for t in (32, 24, 16, 8)}, reverse=True)
        for nj in splits:
            for rc in kernel.MICRO_TILES:
                for tile in tiles:
                    for stages in (4, 3):
                        try:
                            cfg = kernel.make_config(B, H, hd, dtype, rc, nj, tile, stages)
                        except ValueError:
                            continue
                        y, sT = kernel.launch(*args, cfg)
                        torch.cuda.synchronize()
                        err = max((y - ey).abs().max().item(),
                                  (sT - es).abs().max().item())
                        ok = all(torch.allclose(a, b, rtol=1e-4, atol=atol)
                                 for a, b in ((y, ey), (sT, es)))
                        ms = device_ms(lambda: kernel.launch(*args, cfg))
                        mark = ""
                        if cfg == pick:
                            mark = (f"  <- launch_config; graph replay "
                                    f"{graph_ms(lambda: kernel.wkv6_fwd(*args)):.4f} ms")
                        print(f"[sweep] {name:10s} {rc[0]}x{rc[1]} nj={nj} tile={tile} "
                              f"stages={stages} threads={cfg.threads} smem={cfg.smem} "
                              f"blocks={cfg.blocks}: ms={ms:.4f} max_err={err:.3e} "
                              f"{'ok' if ok else 'WRONG'}{mark}", flush=True)
        del args, ey, es


if __name__ == "__main__":
    main()
