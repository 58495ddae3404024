"""Where the time goes on the card: one prefill and a few decode steps of
the port, each under ``torch.profiler`` — or, with ``--train``, one step of
the training path on each of its two ranks.

Example (full width, on the card)::

    PYTHONPATH=src python -m repro_torch.launch.profile --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch jamba-1.5-large-398b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch deepseek-moe-16b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch whisper-medium
    PYTHONPATH=src python -m repro_torch.launch.profile --train

For each phase it prints the host wall time, the device-busy time (the sum
of kernel times; one stream, so they do not overlap), the busy share, and
the kernels that took the most device time.  The phases are measured
after one warm-up call each.  An arch that does not fit one card runs its
one-card cut (``configs.one_card_arch``).  The encoder-decoder
(whisper-medium) prefills its 448-token text context over frame
embeddings drawn from the seed, and decodes, as its server does, against
a zeroed cross-attention cache.  ``--train`` runs
``launch.train.ONE_CARD_RUN`` (full-width qwen2-0.5b, fp32, two ranks
sharing the card over gloo, int8 slow tier; ``chip_smoke.py``'s training
phase) and profiles each rank's second step.  The ranks' processes share
the card by time-slicing, so a kernel's interval may include the other
rank's work: their busy times overlap, and their sum bounds the card's
busy time from above only.
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
from repro_torch.configs.one_card import WHISPER_TEXT_CONTEXT
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
    return {"phase": name, **_kernel_report(prof, wall_ms, top)}


def _kernel_report(prof, wall_ms: float, top: int) -> dict:
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "top": [{"kernel": e.key[:90], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in kernels[:top]]}


def _train_rank(rank: int, world: int, init_method: str) -> dict:
    """One training rank: its second step (step 1) under the profiler, from
    the end of step 0 to the end of step 1; then, after the run, one more
    step taken apart on the host clock (forward + backward, then sync +
    update, each ended by a synchronize and a barrier)."""
    import torch.distributed as dist
    from repro_torch.core import prims
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.grad_sync import sync_and_update
    from repro_torch.utils.trees import tree_from_paths, tree_paths
    args = train_cli.resolve_args(
        train_cli.build_parser().parse_args(train_cli.ONE_CARD_RUN))
    window = {}

    def on_step(step, params, opt, metrics):
        torch.cuda.synchronize()
        if step == 0:
            window["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.perf_counter()
        elif step == 1:
            wall_ms = (time.perf_counter() - window["t0"]) * 1e3
            window["prof"].__exit__(None, None, None)
            window["report"] = {"phase": f"train step 1, rank {rank}",
                                "step_s": metrics["dt"],
                                **_kernel_report(window["prof"], wall_ms, TOP)}

    trainer, out = train_cli.run_rank(args, rank, world, init_method,
                                      on_step=on_step, keep_group=True)
    try:
        model, mesh = trainer.model, trainer.mesh
        batch = {k: torch.from_numpy(v).to(model.device) for k, v in
                 trainer.local_batch(out["step"]).items()}
        params = out["params"]

        def mark():
            torch.cuda.synchronize()
            dist.barrier()
            return time.perf_counter()

        t0 = mark()
        flat = tree_paths(params)
        loss = model.loss(params, batch)
        grads = tree_from_paths(dict(zip(flat, torch.autograd.grad(loss, list(flat.values())))))
        t1 = mark()
        with prims.bind(mesh):
            sync_and_update(params, grads, out["opt"], trainer.plan, trainer.ss,
                            1e-6, AdamWConfig())
        t2 = mark()
        window["report"]["split_s"] = {"forward_backward": t1 - t0,
                                       "sync_update": t2 - t1}
    finally:
        dist.destroy_process_group()
    return window["report"]


def profile_train() -> list:
    from repro_torch.launch import train as train_cli
    world = train_cli.mesh_ranks(train_cli.parse_mesh(
        train_cli.ONE_CARD_RUN[train_cli.ONE_CARD_RUN.index("--mesh") + 1]))
    reports = train_cli.run_ranks(_train_rank, world)
    wall = max(r["wall_ms"] for r in reports)
    busy = sum(r["device_busy_ms"] for r in reports)
    reports.append({"phase": "train step 1, card (all ranks)", "wall_ms": wall,
                    "device_busy_ms": busy, "busy_share": busy / wall})
    return reports


# The shapes chip_smoke.py drives: prefill at B=4, S=2048 (whisper's at its
# text context, which also sizes its learned positions) and the serve phase's 8 slots over a 256-token cache,
# all in bf16.
DTYPE = "bfloat16"
BATCH, SEQ = 4, 2048
SLOTS, MAX_SEQ, DECODE_STEPS = 8, 256, 8
TOP, SEED = 8, 0


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--train", action="store_true",
                    help="profile chip_smoke.py's training phase instead")
    args = ap.parse_args(argv)
    if args.train:
        reports = profile_train()
        for r in reports:
            print(json.dumps(r))
        return reports
    if not args.arch:
        ap.error("--arch is required without --train")

    arch, cuts = one_card_arch(args.arch)
    print(json.dumps({"arch": arch.name, "n_layers": arch.n_layers,
                      "cuts": list(cuts)}))
    seq = WHISPER_TEXT_CONTEXT if arch.is_encdec else SEQ
    st = ModelSettings(param_dtype=DTYPE, compute_dtype=DTYPE,
                       attn_impl="kernel", use_kernel_ssm=True, max_seq=seq)
    model = build_model(arch, st, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, arch.vocab, (BATCH, seq), generator=gen, device="cuda")
    frames = (torch.randn(BATCH, arch.encoder.n_frames, arch.d_model,
                          generator=gen, device="cuda") if arch.is_encdec else None)
    step_tokens = torch.randint(0, arch.vocab, (SLOTS, 1), generator=gen,
                                device="cuda")
    cache = model.init_cache(SLOTS, MAX_SEQ)

    def decode():
        for pos in range(DECODE_STEPS):
            logits, _ = model.decode_step(cache, step_tokens, pos)
            torch.argmax(logits, dim=-1).cpu()  # the server's per-step sync

    reports = [profile_phase(f"prefill B={BATCH} S={seq}",
                             lambda: model.prefill(tokens, frames), TOP),
               profile_phase(f"decode {DECODE_STEPS} steps x {SLOTS} slots",
                             decode, TOP)]
    for r in reports:
        print(json.dumps(r))
    return reports


if __name__ == "__main__":
    main()
