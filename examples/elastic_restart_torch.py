"""Fault-tolerance walkthrough, on the PyTorch port: crash a run mid-flight,
restart, verify the trajectory matches an uninterrupted run (deterministic
recovery), then restore the same checkpoint onto a different mesh (elastic
rescaling).

    PYTHONPATH=src python examples/elastic_restart_torch.py [--device cpu]

The twin of ``examples/elastic_restart.py``.  Each run builds its model
anew from the runs' seed (the port's ``Trainer`` trains the model's own
leaves in place).  Attention runs the flash-attention kernel on the card
(its plain version on CPU tensors); without a card it raises unless given
``--device cpu``.
"""
import argparse
import shutil
import tempfile
from typing import Optional, Sequence

from repro_torch.configs import get_smoke_arch
from repro_torch.launch.mesh import one_process_mesh
from repro_torch.models import ModelSettings, build_model
from repro_torch.runtime.train_loop import SimulatedFailure, Trainer, TrainerConfig

SEED = 9  # the runs' seed: the weights' and the data's


class Shape:
    global_batch, seq_len = 8, 32
    name, kind = "elastic", "train"


def build(device="cuda"):
    """The qwen3 smoke model, its weights drawn by the port's init from a
    ``torch.Generator`` seeded with ``SEED``, on ``device``."""
    return build_model(get_smoke_arch("qwen3-1.7b"), ModelSettings(
        param_dtype="float32", compute_dtype="float32", remat="none",
        loss_chunk=16, max_seq=64, attn_impl="kernel"), device=device, seed=SEED)


def main(argv: Optional[Sequence[str]] = None):
    """Returns (the reference run's result, the restarted run's, what the
    restore onto the second mesh gave)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    model = build(args.device)  # raises without the card asked for
    tmp = tempfile.mkdtemp(prefix="repro_torch_elastic_")

    def cfg(fail_at=None):
        return TrainerConfig(steps=16, lr=5e-3, warmup=2, log_every=0,
                             ckpt_every=4, ckpt_dir=tmp, seed=SEED,
                             mode="dfabric", fail_at_step=fail_at)

    with one_process_mesh((1, 1, 1), ("pod", "data", "model"), args.device) as mesh:
        print("reference run (no failures)...")
        ref = Trainer(model, mesh, Shape(), cfg()).train()
        shutil.rmtree(tmp)

        print("run with injected failure at step 10...")
        try:
            Trainer(build(args.device), mesh, Shape(), cfg(fail_at=10)).train()
        except SimulatedFailure as e:
            print(f"  crashed as planned: {e}")

        print("restarting from the last checkpoint...")
        out = Trainer(build(args.device), mesh, Shape(), cfg()).train()
    d = abs(out["metrics"][-1]["loss"] - ref["metrics"][-1]["loss"])
    print(f"  final loss {out['metrics'][-1]['loss']:.5f} vs reference "
          f"{ref['metrics'][-1]['loss']:.5f} (|delta|={d:.2e})")
    assert d < 1e-3, "restart must reproduce the uninterrupted trajectory"

    print("elastic restore onto a new mesh object (rescale path)...")
    with one_process_mesh((1, 1, 1), ("pod", "data", "model"), args.device) as mesh2:
        t2 = Trainer(build(args.device), mesh2, Shape(), cfg())
        restored = t2.try_restore()
    assert restored is not None and restored[2] == 16
    print("  restored step", restored[2], "OK")
    shutil.rmtree(tmp, ignore_errors=True)
    print("elastic restart demo complete")
    return ref, out, restored


if __name__ == "__main__":
    main()
