#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version, then drives the port's two serving
entry points at the full width of qwen2-0.5b (random weights from a seed):
``Model.prefill`` with the flash-attention kernel in every layer, and
``DecodeServer`` answering 16 requests.  Any failure raises and exits
non-zero.  The last lines are the card (``nvidia-smi``), one JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# NVIDIA H100 SXM data-sheet peaks (dense): FLOP/s by input type, bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(text: str) -> str:
    """'<dtype> hd<N>: <regs> regs, <spill> B spilled' for each kernel
    instantiation in ``nvcc -Xptxas -v`` output."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"fa_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", line)
        if "Compiling entry function" in line and m:
            name = f"{'fp32' if m.group(1) == 'f' else 'bf16'} hd{m.group(2)}"
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} regs, {spill} B spilled")
            name = None
    return "; ".join(out)


def time_ms(fn, iters: int, warmup: int = 2, repeats: int = 3) -> float:
    """Device time of one call: the mean over ``iters`` calls between CUDA
    events, taken ``repeats`` times; the median of those, so that a batch
    run while the card's clocks still ramp up does not count."""
    import torch
    for _ in range(warmup):
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


def attention_bound_ms(B, H, KV, S, hd, causal, dtype_name):
    """Least time for the work: each input read once, the output written
    once, and 4*hd FLOPs per (query, key) pair that the mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * B * H * hd * pairs
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * B * H * S * hd + 2 * B * KV * S * hd) * itemsize
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        sys.exit("chip_smoke.py: src/repro_torch not found beside this script; "
                 "run it from a checkout of the repository")
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: CUDA is not available; it runs on an NVIDIA GPU")

    from repro_torch.configs import get_arch
    from repro_torch.kernels._build import library_path
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.runtime.serve_loop import DecodeServer, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t_start = time.perf_counter()

    # ---- phase 1: card and build -------------------------------------------
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    fa_kernel.build()
    log(f"[build] flash_attention_fwd built/loaded in {time.perf_counter() - t0:.2f} s")
    ptxas = library_path("flash_attention_fwd", fa_kernel.SOURCES).with_suffix(".log")
    if ptxas.exists():
        log(f"[build]   ptxas per instantiation: {ptxas_summary(ptxas.read_text())}")

    # ---- phase 2: kernel vs plain on the card ------------------------------
    arch = get_arch("qwen2-0.5b")
    H, KV, hd = arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    B_MAIN, S_MAIN = 4, 2048
    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    cases = [  # name, B, H, KV, S, hd, causal, dtype
        ("main-bf16", B_MAIN, H, KV, S_MAIN, hd, True, "bfloat16"),
        ("main-fp32", B_MAIN, H, KV, S_MAIN, hd, True, "float32"),
        ("hd128", 2, 8, 2, 1024, 128, True, "float32"),
        ("hd192", 1, 8, 1, 512, 192, True, "bfloat16"),
        ("hd160", 1, 4, 2, 130, 160, True, "bfloat16"),
        ("hd24", 1, 4, 2, 100, 24, False, "float32"),
        ("hd16", 2, 4, 2, 64, 16, True, "float32"),
        ("ragged-S200", 2, H, KV, 200, hd, True, "float32"),
        ("noncausal", 2, H, KV, 512, hd, False, "bfloat16"),
        ("G1", 2, 4, 4, 333, hd, True, "float32"),
    ]
    results = {}
    for name, B, Hc, KVc, S, d, causal, dt_name in cases:
        dt = getattr(torch, dt_name)
        main = name.startswith("main")

        def draw(heads):
            # the main-path cases take the strided (B, heads, S, hd) views of
            # (B, S, heads, hd) memory that prefill hands the kernel
            if main:
                t = torch.randn(B, S, heads, d, generator=gen, device=dev)
                return t.to(dt).transpose(1, 2)
            return torch.randn(B, heads, S, d, generator=gen, device=dev).to(dt)

        q, k, v = draw(Hc), draw(KVc), draw(KVc)
        out = fa_kernel.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), atol=tol[dt_name],
                                   rtol=tol[dt_name], msg=lambda m: f"{name}: {m}")
        kernel_ms = time_ms(lambda: fa_kernel.flash_attention_fwd(q, k, v, causal=causal),
                            iters=20 if main else 10)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=causal),
                           iters=5 if main else 10)
        # yardstick only: one PyTorch call for the same function (SDPA on
        # k/v repeated per q head beforehand); the port never calls it
        kr = k.repeat_interleave(Hc // KVc, dim=1)
        vr = v.repeat_interleave(Hc // KVc, dim=1)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=causal), iters=20 if main else 10)
        bound_ms, bound_by = attention_bound_ms(B, Hc, KVc, S, d, causal, dt_name)
        results[name] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        log(f"[kernel] {name:12s} q=({B},{Hc},{S},{d}){' strided' if main else ''} "
            f"kv={KVc} causal={causal} "
            f"{dt_name}: max_err={err:.3e} (tol {tol[dt_name]}) "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
        del q, k, v, kr, vr, out, ref

    # ---- phase 3: prefill, full width, bf16, through the kernel ------------
    bf16 = ModelSettings(param_dtype="bfloat16", compute_dtype="bfloat16",
                         attn_impl="kernel")
    model = build_model(arch, bf16, device="cuda", seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, arch.vocab, (B_MAIN, S_MAIN), generator=gen, device=dev)
    fa_kernel.LAUNCHES = 0
    logits, cache = model.prefill(tokens)
    torch.cuda.synchronize()
    prefill_launches = fa_kernel.LAUNCHES
    if prefill_launches != arch.n_layers:
        raise AssertionError(f"prefill launched the kernel {prefill_launches} "
                             f"times, expected {arch.n_layers}")
    if logits.shape != (B_MAIN, arch.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits bad: {tuple(logits.shape)}")
    if tuple(cache["l0"]["k"].shape) != (arch.n_layers, B_MAIN, S_MAIN, KV, hd):
        raise AssertionError(f"prefill cache shape {tuple(cache['l0']['k'].shape)}")
    del logits, cache

    def prefill_times(n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.prefill(tokens)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return out

    before = fa_kernel.LAUNCHES
    kernel_runs = prefill_times(5)
    if fa_kernel.LAUNCHES - before != 5 * arch.n_layers:
        raise AssertionError("LAUNCHES did not grow by n_layers per prefill")
    model.settings = ModelSettings(param_dtype="bfloat16", compute_dtype="bfloat16",
                                   attn_impl="masked")
    plain_runs = prefill_times(3)
    model.settings = bf16
    prefill_ms = statistics.median(kernel_runs)
    log(f"[prefill] qwen2-0.5b full width ({n_params} params) bf16 B={B_MAIN} "
        f"S={S_MAIN}: launches/prefill={prefill_launches} "
        f"prefill_ms median={prefill_ms:.2f} runs={[round(t, 2) for t in kernel_runs]} "
        f"tok/s={B_MAIN * S_MAIN / prefill_ms * 1e3:.0f}; attn_impl=masked "
        f"median={statistics.median(plain_runs):.2f} ms "
        f"runs={[round(t, 2) for t in plain_runs]}")

    fp32 = ModelSettings(param_dtype="float32", compute_dtype="float32",
                         attn_impl="kernel")
    model32 = build_model(arch, fp32, device="cuda", seed=SEED)
    toks256 = torch.randint(0, arch.vocab, (2, 256), generator=gen, device=dev)
    lk, _ = model32.prefill(toks256)
    model32.settings = ModelSettings(param_dtype="float32", compute_dtype="float32",
                                     attn_impl="masked")
    lm, _ = model32.prefill(toks256)
    model32.settings = fp32
    torch.testing.assert_close(lk, lm, atol=1e-3, rtol=1e-3)
    log(f"[prefill] fp32 S=256 kernel vs masked logits: max_abs_diff="
        f"{(lk - lm).abs().max().item():.3e} (atol=rtol=1e-3)")

    # ---- phase 4: prefill <-> decode consistency, full width, fp32 ---------
    prompt = torch.randint(0, arch.vocab, (2, 32), generator=gen, device=dev)
    pre_logits, _ = model32.prefill(prompt)
    dcache = model32.init_cache(2, 33)
    for t in range(32):
        dec_logits, dcache = model32.decode_step(dcache, prompt[:, t:t + 1], t)
    torch.testing.assert_close(dec_logits, pre_logits, atol=2e-3, rtol=2e-3)
    log(f"[consistency] fp32 prefill(32) vs 32 decode steps: max_abs_diff="
        f"{(dec_logits - pre_logits).abs().max().item():.3e} (atol=rtol=2e-3)")
    del model32, dcache

    # ---- phase 5: serve, full width, bf16 ----------------------------------
    server = DecodeServer(model, "cuda", batch_slots=8, max_seq=256)
    rng = np.random.default_rng(SEED)
    for i in range(16):
        server.submit(Request(uid=i, prompt=rng.integers(0, arch.vocab, 4).astype(np.int32),
                              max_new=32))
    fa_kernel.LAUNCHES = 0
    outs = server.run(max_steps=255)
    torch.cuda.synchronize()
    serve_launches = fa_kernel.LAUNCHES
    if not (len(outs) == 16 and all(r.done and len(r.generated) == 32
                                    for r in server.all_requests)):
        raise AssertionError("not every served request finished")
    lat = server.latency_summary()
    log(f"[serve] 16 requests, 8 slots, max_seq 256, max_new 32, greedy, bf16: "
        f"tokens={server.stats['tokens']} steps={server.stats['steps']} "
        f"wall_s={server.stats['wall']:.3f} tok/s={server.throughput():.1f} "
        f"ttft_p50_ms={lat['ttft_p50_s'] * 1e3:.2f} ttft_p99_ms={lat['ttft_p99_s'] * 1e3:.2f} "
        f"tpot_p50_ms={lat['tpot_p50_s'] * 1e3:.2f} tpot_p99_ms={lat['tpot_p99_s'] * 1e3:.2f} "
        f"kernel launches={serve_launches} (decode attention is plain PyTorch)")

    # ---- phases 6-7: kernels line, result ----------------------------------
    main = results["main-bf16"]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": prefill_launches, **main}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
