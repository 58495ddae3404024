"""Batched serving example, on the PyTorch port: prefill-free decode with
continuous batching.

    PYTHONPATH=src python examples/serve_decode_torch.py --arch rwkv6-1.6b [--device cpu]

The twin of ``examples/serve_decode.py``: serves the smoke config of any
arch the port registers with batched requests on a one-member mesh,
sampling at temperature 0.8 from a generator seeded 0, and reports
tokens/s.  Every decode step runs the WKV6 kernel in each RWKV6 layer and
the selective-scan kernel in each Mamba layer on the card (their plain
versions on CPU tensors); without a card it raises unless given
``--device cpu``.
"""
import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import get_smoke_arch, list_archs
from repro_torch.launch.mesh import one_process_mesh
from repro_torch.models import ModelSettings, build_model
from repro_torch.obs.metrics import MetricsLogger
from repro_torch.runtime.serve_loop import DecodeServer, Request


def build(name: str, device="cuda"):
    """(arch, model): ``name``'s smoke config, its weights drawn by the
    port's init from a ``torch.Generator`` seeded 0, on ``device``."""
    arch = get_smoke_arch(name)
    model = build_model(arch, ModelSettings(
        param_dtype="float32", compute_dtype="float32", remat="none",
        max_seq=128, attn_impl="kernel", use_kernel_ssm=True),
        device=device, seed=0)
    return arch, model


def serve(arch, model, mesh, requests: int, max_new: int, metrics,
          temperature: float = 0.8):
    """The example's server over ``mesh`` (or on a device: what
    ``DecodeServer`` takes): ``requests`` prompts of 4 tokens drawn from
    numpy's generator seeded 0, ``max_new`` tokens each; ``metrics`` a
    ``MetricsLogger`` or None.  Returns (the server, its outputs)."""
    server = DecodeServer(model, mesh, batch_slots=4, max_seq=128,
                          temperature=temperature, metrics=metrics)
    rng = np.random.default_rng(0)
    for i in range(requests):
        server.submit(Request(uid=i,
                              prompt=rng.integers(0, arch.vocab, 4).astype(np.int32),
                              max_new=max_new))
    return server, server.run(max_steps=120)


def main(argv: Optional[Sequence[str]] = None):
    """Returns (the server, its outputs)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--metrics-path", default=None,
                    help="streamed JSONL metrics (repro_torch.obs.metrics)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    arch, model = build(args.arch, args.device)
    metrics = MetricsLogger(path=args.metrics_path, echo=False, run="serve",
                            arch=args.arch)
    with one_process_mesh((1, 1), ("data", "model"), args.device) as mesh:
        server, outs = serve(arch, model, mesh, args.requests, args.max_new, metrics)
    done = sum(1 for t in outs.values() if len(t) >= args.max_new)
    lat = server.latency_summary()
    print(f"{done}/{args.requests} requests completed, "
          f"{server.throughput():.1f} tok/s")
    if lat:
        print(f"ttft p50 {lat['ttft_p50_s'] * 1e3:.1f} ms "
              f"p99 {lat['ttft_p99_s'] * 1e3:.1f} ms, "
              f"tpot p50 {lat.get('tpot_p50_s', 0) * 1e3:.2f} ms "
              f"p99 {lat.get('tpot_p99_s', 0) * 1e3:.2f} ms")
    metrics.close()
    return server, outs


if __name__ == "__main__":
    main()
