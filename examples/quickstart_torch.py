"""Quickstart, on the PyTorch port: train a tiny LM with the DFabric
gradient-sync stack on one card.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The twin of ``examples/quickstart.py``: the qwen2 smoke config for 60 steps
on a one-member mesh (the DFabric collectives degenerate gracefully),
printing a decreasing loss.  Attention runs the flash-attention kernel on
the card (its plain version on CPU tensors); without a card it raises
unless given ``--device cpu``.
"""
import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_smoke_arch
from repro_torch.launch.mesh import one_process_mesh
from repro_torch.models import ModelSettings, build_model
from repro_torch.runtime.train_loop import Trainer, TrainerConfig


class Shape:
    global_batch, seq_len = 8, 64
    name, kind = "quickstart", "train"


def build(device="cuda"):
    """(model, TrainerConfig): the qwen2 smoke model, its weights drawn by
    the port's init from a ``torch.Generator`` seeded with the config's
    seed, on ``device``."""
    cfg = TrainerConfig(steps=60, lr=5e-3, warmup=6, log_every=10,
                        mode="dfabric", zero1=True)
    arch = get_smoke_arch("qwen2-0.5b")
    model = build_model(arch, ModelSettings(
        param_dtype="float32", compute_dtype="float32", remat="none",
        loss_chunk=32, max_seq=64, attn_impl="kernel"),
        device=device, seed=cfg.seed)
    return model, cfg


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    model, cfg = build(args.device)
    with one_process_mesh((1, 1, 1), ("pod", "data", "model"), args.device) as mesh:
        out = Trainer(model, mesh, Shape(), cfg).train()
    first, last = out["metrics"][0]["loss"], out["metrics"][-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {out['step']} steps")
    assert last < first
    return out


if __name__ == "__main__":
    main()
