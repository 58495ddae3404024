"""End-to-end training run, on the PyTorch port: train a 67.1M-param LM for
a few hundred steps with the full production stack — DFabric ZeRO-1 gradient
sync, checkpointing every 50 steps, straggler watchdog, preemption handler.

    PYTHONPATH=src python examples/ddp_train_torch.py [--steps 300] [--device cpu]

The twin of ``examples/ddp_train.py``: a 12-layer, d=512 dense transformer
with its 32k vocab, 67.1M parameters as ``count_params`` prints them, on
a one-member mesh.  Attention runs the flash-attention kernel on the card
(its plain version on CPU tensors); without a card it raises unless given
``--device cpu``, where a step takes tens of seconds: pass --steps 2 for a
quick look.  A second run with the same ``--ckpt-dir`` resumes from its
newest checkpoint.
"""
import argparse
import os
import tempfile
from typing import Optional, Sequence

from repro_torch.configs import ArchConfig
from repro_torch.launch.mesh import one_process_mesh
from repro_torch.models import ModelSettings, build_model, count_params
from repro_torch.runtime.train_loop import Trainer, TrainerConfig

ARCH_100M = ArchConfig(
    name="ddp-100m", family="dense", n_layers=12, d_model=512, n_heads=8,
    n_kv_heads=8, d_ff=2048, vocab=32768, head_dim=64, activation="silu",
    glu=True, norm="rmsnorm", tie_embeddings=True,
    source="examples/ddp_train.py")


class Shape:
    global_batch, seq_len = 8, 256
    name, kind = "ddp100m", "train"


def build(device="cuda", seed: int = 0):
    """The example's model, its weights drawn by the port's init from a
    ``torch.Generator`` seeded with ``seed`` (the trainer's default seed),
    on ``device``."""
    return build_model(ARCH_100M, ModelSettings(
        param_dtype="float32", compute_dtype="float32", remat="none",
        loss_chunk=64, max_seq=256, attn_impl="kernel"), device=device, seed=seed)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ddp_ckpt"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    model = build(args.device)
    print(f"params: {count_params(model)/1e6:.1f}M")
    cfg = TrainerConfig(steps=args.steps, lr=3e-4, warmup=20, log_every=10,
                        mode="dfabric", zero1=True,
                        ckpt_dir=args.ckpt_dir, ckpt_every=50)
    with one_process_mesh((1, 1, 1), ("pod", "data", "model"), args.device) as mesh:
        trainer = Trainer(model, mesh, Shape(), cfg)
        trainer.install_preemption_handler()
        out = trainer.train()
    print(f"\ndone at step {out['step']}: "
          f"loss {out['metrics'][0]['loss']:.3f} -> "
          f"{out['metrics'][-1]['loss']:.3f}; "
          f"ckpt latest = step {trainer.ckpt.latest_step() if trainer.ckpt else None}; "
          f"straggler events = {len(out['straggler_events'])}")
    return trainer, out


if __name__ == "__main__":
    main()
