"""Serving launcher: batched decode with continuous batching, on the card.

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-medium --smoke --device cpu

Every arch the port registers is served: qwen2-0.5b, qwen3-1.7b,
stablelm-12b, nemotron-4-340b, chameleon-34b, deepseek-moe-16b,
moonshot-v1-16b-a3b, rwkv6-1.6b, jamba-1.5-large-398b and whisper-medium
(``--arch whisper-medium [--smoke]``: as in the reference's server, no
encoder runs and decode reads a zeroed cross-attention cache).  The model
runs
every ported kernel (flash attention in prefill, WKV6 in every RWKV6 step,
the selective scan in every Mamba step).  An arch that does not fit one
card (jamba, nemotron) runs its one-card cut (``configs.one_card_arch``),
which is printed.

The CLI serves on one member, on one device, as the reference's CLI serves
on a mesh of (data, model) = (devices, 1).  To serve over a mesh from
Python, start one process a member (``torch.distributed`` initialised
with the world's size and this rank), bind the mesh and hand it to the
server in place of the device::

    mesh = prims.Mesh({"data": 2, "model": 2})
    server = DecodeServer(model, mesh, batch_slots=8, max_seq=256)
    ... server.submit(...) on every rank alike ...
    outputs = server.run()

The server cuts the model for the member (``Model.shard``) and decodes
its rows of the slots; every rank's ``outputs`` are the same.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import one_card_arch
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

    arch, cuts = one_card_arch(args.arch, smoke=args.smoke)
    for cut in cuts:
        print(f"{arch.name} cut to one card: {cut}")
    # the kernels on the card; on CPU tensors they run their plain versions
    st = ModelSettings(param_dtype=args.dtype, compute_dtype=args.dtype,
                       attn_impl="kernel", use_kernel_ssm=True,
                       max_seq=args.max_seq)
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
