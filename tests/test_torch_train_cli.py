"""The port's training CLI (``python -m repro_torch.launch.train``): the
3-tier run on 8 gloo CPU ranks that it spawns itself, runs with a model
axis and in the GSPMD step, its mesh rules (the JAX CLI's), and what it
refuses."""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")


from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_trains_3tier_on_cpu(tmp_path):
    out = tmp_path / "metrics.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--smoke", "--mesh", "2,2,2,1", "--steps", "6",
         "--batch", "8", "--seq", "32", "--device", "cpu", "--backend",
         "gloo", "--metrics-out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "finished at step 6" in proc.stdout
    losses = [m["loss"] for m in json.loads(out.read_text())]
    assert len(losses) == 6 and losses[-1] < losses[0]


def test_cli_resumes_from_its_checkpoint_dir(tmp_path):
    """``--ckpt-dir``/``--ckpt-every``: a second run with the same dir
    restores the first run's newest step and trains on from there."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen2-0.5b", "--smoke", "--mesh", "2,1,1", "--batch", "8",
            "--seq", "32", "--device", "cpu", "--backend", "gloo",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2"]
    runs = []
    for steps in ("4", "6"):
        out = tmp_path / f"metrics{steps}.json"
        proc = subprocess.run(base + ["--steps", steps, "--metrics-out", str(out)],
                              env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs.append((proc.stdout, [m["step"] for m in json.loads(out.read_text())]))
    assert runs[0][1] == [0, 1, 2, 3] and "restored" not in runs[0][0]
    assert "restored step 4" in runs[1][0] and "finished at step 6" in runs[1][0]
    assert runs[1][1] == [4, 5]
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "LATEST", "step_00000002", "step_00000004", "step_00000006"]


@pytest.mark.parametrize("spec", ["2,2,2,1", "2,4,1", "2,1,1", "4,2", "8", None])
def test_mesh_rules_match_jax_cli(spec):
    """``repro.launch.train``'s rules: 4 dims (pod, host, data, model), 3
    (pod, data, model), fewer the trailing ones; none (1, cards, 1)."""
    sizes = launch_mesh.parse_mesh(spec, default_data=8)
    if spec is None:
        assert sizes == {"pod": 1, "data": 8, "model": 1}
        return
    dims = tuple(int(x) for x in spec.split(","))
    want = {4: ("pod", "host", "data", "model"),
            3: ("pod", "data", "model")}.get(len(dims),
                                             ("pod", "data", "model")[-len(dims):])
    assert sizes == dict(zip(want, dims))


def test_cli_refusals():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "qwen2-0.5b", "--smoke"])
    with pytest.raises(ValueError, match="nccl"):
        train_cli.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                        "--backend", "nccl"])
    with pytest.raises(ValueError, match="cards"):
        launch_mesh.rank_device("cuda", "nccl", 0, 2)


@pytest.mark.parametrize("mode,arch,mesh", [
    ("dfabric", "qwen2-0.5b", "1,1,2"), ("gspmd", "qwen3-1.7b", "1,2,2"),
    ("dfabric", "rwkv6-1.6b", "1,1,2"), ("gspmd", "jamba-1.5-large-398b", "1,2,2")])
def test_cli_trains_tp_and_gspmd_on_cpu(tmp_path, mode, arch, mesh):
    """A model axis of 2 (tensor parallelism) in the DFabric step, and the
    GSPMD step (FSDP over data x TP over model), for a dense, an RWKV6 and
    a hybrid model (jamba's smoke with its experts): the loss falls."""
    out = tmp_path / "metrics.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--mode", mode, "--mesh", mesh, "--steps", "4",
         "--batch", "4", "--seq", "32", "--lr", "8e-3", "--device", "cpu",
         "--metrics-out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    losses = [m["loss"] for m in json.loads(out.read_text())]
    assert len(losses) == 4 and losses[-1] < losses[0]


@pytest.mark.parametrize("cfg,sizes,arch,settings", [
    # MoE dispatch groups over the GSPMD step's whole batch
    (dict(mode="gspmd"), {"pod": 2, "data": 1, "model": 1}, "deepseek-moe-16b",
     dict(moe_groups=2)),
    # a sequence split of RWKV6 layers
    (dict(), {"pod": 1, "data": 2, "model": 2}, "rwkv6-1.6b", dict(seq_axis="model")),
    # with checkpoints (the directory: tmp_path's)
    (dict(mode="gspmd", ckpt_every=2, ckpt_dir="ckpt"),
     {"pod": 1, "data": 2, "model": 2}, "jamba-1.5-large-398b", dict(moe_groups=2)),
])
def test_trainer_refuses_what_is_not_ported(tmp_path, cfg, sizes, arch, settings):
    """(The name is the refusals', which these settings were.)  MoE
    dispatch groups under the GSPMD step and a sequence split of RWKV6
    layers train: the ``Trainer`` of deepseek's smoke on (2, 1, 1), of
    rwkv6's with ``seq_axis`` on (1, 2, 2) and of jamba's with its experts
    on (1, 2, 2), checkpointed at step 2, gives finite losses, the same on
    every member (tests/test_torch_seq_parallel.py and
    tests/test_torch_seq_parallel_families.py hold them to the JAX
    ``Trainer``)."""
    from torch_harness import rank_tp_trainer, spawn_ranks
    if "ckpt_dir" in cfg:
        cfg = dict(cfg, ckpt_dir=str(tmp_path / cfg["ckpt_dir"]))
    run = dict(arch=arch, sizes=sizes, cfg=cfg, settings=settings,
               train=dict(steps=2))
    recs = [r[0] for r in spawn_ranks(math.prod(sizes.values()), rank_tp_trainer,
                                      dict(weights={}, runs=[run]))]
    losses = recs[0]["losses"]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert all(r["losses"] == losses for r in recs)
    if "ckpt_dir" in cfg:
        from repro_torch.checkpoint import CheckpointManager
        assert CheckpointManager(cfg["ckpt_dir"], read_only=True).latest_step() == 2
