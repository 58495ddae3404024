"""Training steps with the codecs beyond the slow int8 leg, on 8 gloo
ranks, held against the JAX package on the same smoke qwen2-0.5b weights
and data (a file of its own, so that it runs on a test worker of its own):

  * the port's ``Trainer`` on the three-tier (2, 2, 2, 1) mesh with
    ``codec="topk"`` (the top-k slow leg with error feedback), against the
    JAX ``Trainer``;
  * ``make_sync_plan(..., mid_codec="int8")`` on ``three_tier_fabric(2, 2,
    2)`` (mesh (pod, host, data) = (2, 2, 2)) with the int8 slow codec and ``make_dfabric_train_step`` (the
    reference's own API for the mid-tier codec: its ``Trainer`` passes no
    ``mid_codec``), against the same JAX functions.  The port's plan equals
    the JAX plan (``SyncPlan.to_json``), and it codes the host tier.

Both are held to ``test_torch_trainer.py``'s int8 tolerances (loss curve
rtol 1e-3, 99% of the final parameters to atol 2e-5 and every one to 2 x
lr x steps; the sync state to 1e-4 of its range, the EF to 1e-2, in 99% of
the elements).  Why they hold for top-k: the gradients differ between the
frameworks by rounding, so an element near the k-th magnitude can be kept
by one and left by the other; the top-k test counts such elements (an EF
element that is zero in one package and not in the other) and holds them
to 1% of the EF state.  The mid int8 legs round like the slow int8 leg
(ROADMAP queue 3, item 6).
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (check_trainer_run,  # noqa: E402
                           jax_step_runs, jax_trainer_runs, rank_sync_plan_steps,
                           rank_trainer, smoke_weights, spawn_ranks)

SIZES = {"pod": 2, "host": 2, "data": 2, "model": 1}
TRAINER_RUNS = {"2x2x2x1-topk": (SIZES, dict(zero1=True, codec="topk"))}
# no model axis: with one, the reference runs the sync in a nested
# model-manual shard_map without the threaded ranks, where its coded
# reduce-scatter's ``lax.axis_index("host")`` does not lower on this jax
STEP_RUNS = {"2x2x2-mid-int8": ({"pod": 2, "host": 2, "data": 2},
                                dict(codec="int8", mid_codec="int8",
                                     strategy="hier_striped", fabric="3tier"))}


@pytest.fixture(scope="module")
def weights():
    return smoke_weights(seed=9)


@pytest.fixture(scope="module")
def topk(weights):
    (name, (sizes, cfg)), = TRAINER_RUNS.items()
    jax_out = jax_trainer_runs(TRAINER_RUNS, weights)
    port = spawn_ranks(8, rank_trainer, {"weights": weights, "sizes": sizes,
                                         "cfg": cfg})
    return jax_out, port


@pytest.fixture(scope="module")
def mid(weights):
    (name, (sizes, cfg)), = STEP_RUNS.items()
    jax_out = jax_step_runs(STEP_RUNS, weights)
    port = spawn_ranks(8, rank_sync_plan_steps, {"weights": weights,
                                                 "sizes": sizes, "cfg": cfg})
    return jax_out, port


def _ef_states(per_rank):
    return {n: e["ef"] for n, e in per_rank[0][2].items() if "ef" in e}


def test_topk_trainer_matches_jax(topk):
    jax_out, port = topk
    (name, (sizes, cfg)), = TRAINER_RUNS.items()
    check_trainer_run(name, sizes, cfg, jax_out, port)
    efs = _ef_states(port)
    assert efs and all(np.abs(e).max() > 0 for e in efs.values())


def test_topk_index_sets_agree(topk):
    """The elements each member left out of its top-k sets (zero EF where
    it sent the element): the port's and the reference's agree but for
    near-ties at the k-th magnitude, at most 1% of the EF state.  Pod 0's
    members only: the EF spec names no pod axis, so the JAX global EF
    holds pod 0's residuals (ROADMAP queue 3, item 8)."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core.topology import topology_from_mesh_sizes
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.optim import grad_sync
    from repro_torch.runtime.train_loop import make_sync_plan
    jax_out, port = topk
    (name, (sizes, cfg)), = TRAINER_RUNS.items()
    model = build_model(get_smoke_arch("qwen2-0.5b"),
                        ModelSettings(param_dtype="float32", compute_dtype="float32"),
                        device="meta")
    plan, ss = make_sync_plan(model, sizes, topology_from_mesh_sizes(sizes),
                              codec="topk")
    specs = grad_sync.sync_state_specs(plan, model.param_shapes(), ss)["sections"]
    differ = total = 0
    for _, _, state, coords in port:
        if dict(coords)["pod"]:
            continue
        for sec, entry in state.items():
            want = grad_sync.local_block(jax_out[f"{name}/s/{sec}/ef"],
                                         specs[sec]["ef"], dict(coords), sizes)
            differ += int(((want == 0) != (entry["ef"] == 0)).sum())
            total += want.size
    print(f"top-k: {differ} of {total} EF elements kept by one package only")
    assert differ <= 1e-2 * total, (differ, total)


def test_mid_codec_plan_matches_jax(mid):
    from repro_torch.core.schedule import Psum, ReduceScatter
    jax_out, port = mid
    (name, _), = STEP_RUNS.items()
    plans = {p for _, p in port}
    assert plans == {str(jax_out[f"{name}/plan"])}
    coded = [l for sec in json.loads(plans.pop()) for l in sec["schedule"]["legs"]
             if l.get("codec") == "int8" and l["kind"] in (Psum.kind, ReduceScatter.kind)]
    assert coded and all(l["axis"] == "host" for l in coded)


def test_mid_codec_steps_match_jax(mid):
    jax_out, port = mid
    (name, (sizes, cfg)), = STEP_RUNS.items()
    per_rank = [r for r, _ in port]
    check_trainer_run(name, sizes, cfg, jax_out, per_rank)
    efs = _ef_states(per_rank)
    assert efs and all(np.abs(e).max() > 0 for e in efs.values())


def test_cli_trains_3tier_topk_on_cpu(tmp_path):
    """``--codec topk`` through the training CLI, which spawns its 8 gloo
    ranks itself: the loss falls over 6 steps."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "metrics.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--smoke", "--mesh", "2,2,2,1", "--codec", "topk",
         "--steps", "6", "--batch", "8", "--seq", "32", "--device", "cpu",
         "--backend", "gloo", "--metrics-out", str(out)],
        env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    losses = [m["loss"] for m in json.loads(out.read_text())]
    assert len(losses) == 6 and losses[-1] < losses[0]
