"""Serving launcher: batched decode with continuous batching, on the card.

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --smoke --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import get_arch, get_smoke_arch
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import ModelSettings
from repro_torch.obs.metrics import MetricsLogger
from repro_torch.runtime.serve_loop import DecodeServer, Request


def main(argv: Optional[Sequence[str]] = None) -> DecodeServer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--metrics-path", default=None,
                    help="streamed JSONL metrics (repro_torch.obs.metrics)")
    args = ap.parse_args(argv)

    arch = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    st = ModelSettings(param_dtype=args.dtype, compute_dtype=args.dtype)
    model = build_model(arch, st, device=args.device, seed=0)
    metrics = MetricsLogger(path=args.metrics_path, echo=False, run="serve",
                            arch=args.arch)
    server = DecodeServer(model, args.device, batch_slots=args.batch_slots,
                          max_seq=args.max_seq, temperature=args.temperature,
                          metrics=metrics)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, arch.vocab, size=(4,)).astype(np.int32)
        server.submit(Request(uid=i, prompt=prompt, max_new=args.max_new))
    outputs = server.run(max_steps=args.max_seq - 1)
    for uid, toks in sorted(outputs.items()):
        print(f"req {uid}: {len(toks)} tokens: {toks[:12]}...")
    print(f"throughput: {server.throughput():.1f} tok/s "
          f"({server.stats['tokens']} tokens, {server.stats['steps']} steps)")
    lat = server.latency_summary()
    if lat:
        print(f"ttft p50 {lat['ttft_p50_s'] * 1e3:.1f} ms "
              f"p99 {lat['ttft_p99_s'] * 1e3:.1f} ms, "
              f"tpot p50 {lat.get('tpot_p50_s', 0) * 1e3:.2f} ms "
              f"p99 {lat.get('tpot_p99_s', 0) * 1e3:.2f} ms")
    metrics.close()
    return server


if __name__ == "__main__":
    main()
