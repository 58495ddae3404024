"""Where the time goes on the card: one prefill and a few decode steps of
the port, each under ``torch.profiler``.

Example (full width, on the card)::

    PYTHONPATH=src python -m repro_torch.launch.profile --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch jamba-1.5-large-398b

For each phase it prints the host wall time, the device-busy time (the sum
of kernel times; one stream, so they do not overlap), the busy share, and
the kernels that took the most device time.  The phases are measured
after one warm-up call each.  An arch that does not fit one card runs its
one-card cut (``configs.one_card_arch``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import one_card_arch
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import ModelSettings


def profile_phase(name: str, fn: Callable[[], None], top: int) -> dict:
    fn()  # warm-up: cuBLAS handles, allocator, kernel build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"phase": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "top": [{"kernel": e.key[:90], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in kernels[:top]]}


# The shapes chip_smoke.py drives: prefill at B=4, S=2048 and the serve
# phase's 8 slots over a 256-token cache, all in bf16.
DTYPE = "bfloat16"
BATCH, SEQ = 4, 2048
SLOTS, MAX_SEQ, DECODE_STEPS = 8, 256, 8
TOP, SEED = 8, 0


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    args = ap.parse_args(argv)

    arch, cuts = one_card_arch(args.arch)
    print(json.dumps({"arch": arch.name, "n_layers": arch.n_layers,
                      "cuts": list(cuts)}))
    st = ModelSettings(param_dtype=DTYPE, compute_dtype=DTYPE,
                       attn_impl="kernel", use_kernel_ssm=True)
    model = build_model(arch, st, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, arch.vocab, (BATCH, SEQ), generator=gen, device="cuda")
    step_tokens = torch.randint(0, arch.vocab, (SLOTS, 1), generator=gen,
                                device="cuda")
    cache = model.init_cache(SLOTS, MAX_SEQ)

    def decode():
        for pos in range(DECODE_STEPS):
            logits, _ = model.decode_step(cache, step_tokens, pos)
            torch.argmax(logits, dim=-1).cpu()  # the server's per-step sync

    reports = [profile_phase(f"prefill B={BATCH} S={SEQ}",
                             lambda: model.prefill(tokens), TOP),
               profile_phase(f"decode {DECODE_STEPS} steps x {SLOTS} slots",
                             decode, TOP)]
    for r in reports:
        print(json.dumps(r))
    return reports


if __name__ == "__main__":
    main()
