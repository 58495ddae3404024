"""End-to-end training launcher — the port of ``repro.launch.train``.

The same flags and ``--mesh`` rules as the JAX CLI, the same settings
(fp32, no remat, ``loss_chunk = min(128, seq)``), the flash-attention
kernel (K1) in every layer's forward and, with ``--codec int8``, the
quantize kernel (K2) on every slow-tier leg.  One process per mesh rank:
run it under ``torchrun`` (which sets ``WORLD_SIZE``), or let it spawn the
ranks itself.  ``--device cuda`` (the default) raises without a card.
With ``--ckpt-dir`` and ``--ckpt-every`` member 0 checkpoints every that
many steps (and on SIGTERM), and a second run with the same ``--ckpt-dir``
resumes from the newest one, on this mesh or another.  A ``--mesh`` with
a model axis above 1 splits every decoder family's layers over it (tensor
parallelism), and ``--mode gspmd`` runs the FSDP x TP step, for every
decoder family too (a MoE layer routes the global batch as one group).
The encoder-decoder (whisper-medium) trains in the DFabric step, with or
without a model axis; its frame embeddings come from the data pipeline.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --mesh 2,2,2,1 --steps 6 --batch 8 --seq 32 \\
        --device cpu --backend gloo
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --mode gspmd --mesh 2,2,2 --steps 4 --batch 8 --seq 32 \\
        --device cpu   # FSDP over data x TP over model, 8 ranks
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --smoke --mode gspmd --mesh 1,2,2 --steps 4 --batch 4 --seq 32 \\
        --device cpu   # any decoder family: RWKV6, Jamba, MoE
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --mesh 2,1,1 --codec int8 --steps 3 --batch 4 --seq 2048 \\
        --backend gloo   # two ranks sharing one card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch whisper-medium --smoke --mesh 2,1,2 --steps 4 --batch 4 \\
        --seq 32 --device cpu   # the encoder-decoder; frames from the data
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, ShapeConfig, get_arch, get_smoke_arch
from repro_torch.core import prims
from repro_torch.launch.mesh import default_backend, mesh_ranks, parse_mesh, rank_device
from repro_torch.models.registry import build_model, resolve_device
from repro_torch.models.transformer import ModelSettings
from repro_torch.runtime.train_loop import Trainer, TrainerConfig


#: one full-width training run on one card: qwen2-0.5b in fp32, two ranks
#: sharing the card over gloo (mesh (pod, data, model) = (2, 1, 1)), the
#: int8 slow tier, 3 steps of B=2 S=2048 a rank — what ``chip_smoke.py``
#: checks and ``launch/profile.py --train`` profiles
ONE_CARD_RUN = ["--arch", "qwen2-0.5b", "--mesh", "2,1,1", "--codec", "int8",
                "--steps", "3", "--batch", "4", "--seq", "2048",
                "--backend", "gloo", "--device", "cuda"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mode", default="dfabric", choices=["dfabric", "gspmd"])
    ap.add_argument("--codec", default=None)
    ap.add_argument("--no-pipeline", action="store_true",
                    help="disable the overlapped slow-leg chunk pipeline "
                         "(sequential schedules, for A/B runs)")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="comma shape, e.g. 2,2,2 for (pod,data,model) or "
                         "2,2,2,1 for (pod,host,data,model); one rank each")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--metrics-path", default=None,
                    help="streamed JSONL metrics (obs.metrics): one record "
                         "per step as it happens, unlike the post-hoc "
                         "--metrics-out dump")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend (default: nccl on "
                         "cuda, gloo on cpu)")
    return ap


def resolve_args(args: argparse.Namespace) -> argparse.Namespace:
    """Fill the defaults that depend on the device; raise for a card that
    is missing or a backend the device cannot use."""
    resolve_device(args.device)
    if args.backend is None:
        args.backend = default_backend(args.device)
    if args.backend == "nccl" and args.device == "cpu":
        raise ValueError("nccl needs --device cuda")
    cards = torch.cuda.device_count() if args.device == "cuda" else 1
    args.sizes = parse_mesh(args.mesh, default_data=cards)
    return args


def run_rank(args: argparse.Namespace, rank: int, world: int,
             init_method: str, on_step: Optional[Callable] = None,
             before_train: Optional[Callable] = None,
             keep_group: bool = False):
    """One rank of a training run: join the process group, build the mesh,
    the model (weights from seed 0, as every rank draws them alike) and the
    ``Trainer``, restore the newest checkpoint if there is one, and train.
    ``before_train(trainer, params, opt)`` and ``on_step`` are hooks for
    callers that check the run; with ``keep_group`` the process group stays
    up for the caller to use and destroy.  Returns (trainer, the result of
    ``Trainer.train``)."""
    dev = rank_device(args.device, args.backend, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(args.backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        mesh = prims.Mesh(args.sizes)
        arch = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
        shape = (SHAPES[args.shape] if args.shape
                 else ShapeConfig("custom", args.seq, args.batch, "train"))
        st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                           remat="none", loss_chunk=min(128, shape.seq_len),
                           max_seq=shape.seq_len, attn_impl="kernel")
        model = build_model(arch, st, device=dev, seed=0)
        cfg = TrainerConfig(steps=args.steps, lr=args.lr,
                            warmup=max(args.steps // 10, 1), mode=args.mode,
                            zero1=not args.no_zero1, codec=args.codec,
                            pipeline=not args.no_pipeline,
                            microbatches=args.microbatches,
                            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                            metrics_path=(f"{args.metrics_path}.rank{rank}"
                                          if args.metrics_path and world > 1
                                          else args.metrics_path))
        trainer = Trainer(model, mesh, shape, cfg)
        trainer.install_preemption_handler()
        # a second run with the same --ckpt-dir resumes from its newest step
        params, opt, start = trainer.try_restore() or trainer.init_state()
        if before_train is not None:
            before_train(trainer, params, opt)
        out = trainer.train(params, opt, start, on_step=on_step)
        if rank == 0:
            print(f"finished at step {out['step']}; "
                  f"final loss {out['metrics'][-1]['loss']:.4f}; "
                  f"straggler events: {len(out['straggler_events'])}",
                  flush=True)
            if args.metrics_out:
                os.makedirs(os.path.dirname(args.metrics_out) or ".",
                            exist_ok=True)
                with open(args.metrics_out, "w") as f:
                    json.dump(out["metrics"], f, indent=1)
        return trainer, out
    finally:
        if not keep_group:
            dist.destroy_process_group()


def _rank_entry(rank, world, init_method, queue, target, args) -> None:
    try:
        queue.put((rank, target(rank, world, init_method, *args), None))
    except BaseException:  # handed to the parent, which raises
        queue.put((rank, None, traceback.format_exc()))
        raise


def run_ranks(target: Callable, world: int, *args, timeout: float = 3600):
    """``target(rank, world, init_method, *args)`` in ``world`` spawned
    processes that join one process group through a tmp-file store; returns
    their return values in rank order, and raises if any rank fails.
    ``target`` is a module-level function (it is pickled by name)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        queue = ctx.Queue()
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, world, init_method, queue, target, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, errors = [None] * world, []
        try:
            for _ in range(world):  # drained before the joins
                rank, out, err = queue.get(timeout=timeout)
                results[rank] = out
                if err:
                    errors.append(f"rank {rank}:\n{err}")
                    break
        finally:
            for p in procs:
                p.join(timeout=5 if errors else 60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("a training rank failed:\n" + "\n".join(errors))
    return results


def _cli_rank(rank: int, world: int, init_method: str, args) -> None:
    run_rank(args, rank, world, init_method)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = resolve_args(build_parser().parse_args(argv))
    world = mesh_ranks(args.sizes)
    if "WORLD_SIZE" in os.environ:  # under torchrun
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"--mesh {args.sizes} needs {world} ranks, "
                             f"WORLD_SIZE is {os.environ['WORLD_SIZE']}")
        run_rank(args, int(os.environ["RANK"]), world, "env://")
    elif world == 1:
        with tempfile.TemporaryDirectory() as tmp:
            run_rank(args, 0, 1, f"file://{os.path.join(tmp, 'store')}")
    else:
        run_ranks(_cli_rank, world, args)


if __name__ == "__main__":
    main()
