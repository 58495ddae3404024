"""Time the Mamba selective-scan kernel's launch candidates on the card.

    PYTHONPATH=src python -m repro_torch.kernels.mamba_scan.sweep

At the shapes the jamba-1.5-large-398b path gives the kernel (prefill B=4
and B=1, S=2048, bf16 and fp32; a decode step of 8 slots; d_inner 16384,
d_state 16, B and C the strided column slices of the model's projection),
launches every d_state-16 candidate of ``CANDIDATES`` with ring stages of
each of ``TILES`` steps, checks y and hT against the plain version with
``chip_smoke.py``'s tolerance (rtol = atol = 1e-4), and prints each
launch's time between CUDA events over 20 calls (as ``chip_smoke.py``
times it), marking ``launch_config``'s own pick.  For the pick it also
prints the device time alone, from a CUDA graph of 20 launches replayed:
at a decode step the host's launch path, not the kernel, sets the first
number.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import kernel
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.kernels.wkv6.sweep import device_ms, graph_ms

DI, DS, DT_RANK = 16384, 16, 512  # jamba-1.5-large's d_inner, d_state, dt_rank
SHAPES = [  # name, B, S, u/dt/B/C dtype
    ("main-bf16", 4, 2048, torch.bfloat16),
    ("main-fp32", 4, 2048, torch.float32),
    ("prefill-B1", 1, 2048, torch.bfloat16),
    ("decode-S1", 8, 1, torch.bfloat16),
]


def inputs(gen, B, S, dtype):
    """Drawn as chip_smoke.py's check_mamba_scan draws them."""
    u = torch.randn(B, S, DI, generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(B, S, DI, generator=gen, device="cuda") - 2).to(dtype)
    A = -torch.exp(torch.randn(DI, DS, generator=gen, device="cuda") * 0.3)
    xdbl = torch.randn(B, S, DT_RANK + 2 * DS, generator=gen, device="cuda").to(dtype)
    Bc, Cc = xdbl[..., DT_RANK:DT_RANK + DS], xdbl[..., DT_RANK + DS:]
    D = torch.ones(DI, device="cuda")
    h0 = torch.randn(B, DI, DS, generator=gen, device="cuda") * 0.1
    return u, dt, A, Bc, Cc, D, h0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep.py: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[sweep] {card}", flush=True)
    kernel.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, B, S, dtype in SHAPES:
        args = inputs(gen, B, S, dtype)
        ey, eh = mamba_scan_ref(*args)
        pick = kernel.launch_config(B, S, DI, DS, dtype)
        for ds, poly, threads in kernel.CANDIDATES:
            if ds != DS:
                continue
            for tile in kernel.TILES:
                try:
                    cfg = kernel.make_config(B, DI, DS, dtype, poly, threads, tile)
                except ValueError:
                    continue
                y, hT = kernel.launch(*args, cfg)
                torch.cuda.synchronize()
                err = max((y - ey).abs().max().item(), (hT - eh).abs().max().item())
                ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                         for a, b in ((y, ey), (hT, eh)))
                ms = device_ms(lambda: kernel.launch(*args, cfg))
                mark = ""
                if cfg == pick:
                    mark = (f"  <- launch_config; graph replay "
                            f"{graph_ms(lambda: kernel.mamba_scan_fwd(*args)):.4f} ms")
                print(f"[sweep] {name:10s} KP={poly} threads={threads} "
                      f"tile={tile} smem={cfg.smem} blocks={cfg.blocks}: "
                      f"ms={ms:.4f} max_err={err:.3e} {'ok' if ok else 'WRONG'}{mark}",
                      flush=True)
        del args, ey, eh


if __name__ == "__main__":
    main()
