"""The port's fault tolerance (``Trainer`` checkpoint/restart, preemption,
failure injection, elastic restore) on gloo ranks, held against an
uninterrupted port run and against the JAX ``Trainer`` on fake devices:
the same smoke qwen2-0.5b weights, data and plan.

Tolerances.  Against JAX, those of ``tests/test_torch_trainer.py`` (its
docstring says why): losses rtol 1e-4 (1e-3 with int8), parameters atol
2e-5 (int8: 99 % of elements, all within 2 x lr x steps; ``attn/bk``
within 2 x lr x steps).  Against the port's own uninterrupted run, a
restart without a codec is bit-equal (the data is step-indexed and every
op and gloo reduction runs in the same order).  With the int8 codec the
checkpoint keeps one pod member's error feedback, as the JAX format does
(``grad_sync.assemble``; ROADMAP.md queue 3), so an int8 restart is held
to the JAX restart, which drops the same residuals.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (check_params_close, jax_fault_runs,  # noqa: E402
                           rank_fault_runs, smoke_weights, spawn_ranks)

TWO = {"pod": 2, "data": 1, "model": 1}
CK = dict(ckpt_every=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run on the (2, 1, 1) mesh: the port's in two spawns (the
    restart in fresh processes, as after a crash), the JAX package's in
    one subprocess."""
    tmp = tmp_path_factory.mktemp("ft")
    d = {k: str(tmp / k) for k in ("ref", "ft", "pre", "race", "i8", "jref",
                                   "jft", "ji8", "ji8-port")}
    weights = smoke_weights(seed=7)
    jax_out = jax_fault_runs([
        dict(name="ref", sizes=TWO, fresh=True, cfg=dict(steps=6, ckpt_dir=d["jref"], **CK)),
        dict(name="crash", sizes=TWO, fresh=True,
             cfg=dict(steps=6, ckpt_dir=d["jft"], fail_at_step=4, **CK)),
        dict(name="restart", sizes=TWO, fresh=False, cfg=dict(steps=6, ckpt_dir=d["jft"], **CK)),
        dict(name="i8-crash", sizes=TWO, fresh=True, copy_to=d["ji8-port"],
             cfg=dict(steps=4, ckpt_dir=d["ji8"], fail_at_step=2, codec="int8", **CK)),
        dict(name="i8-restart", sizes=TWO, fresh=False,
             cfg=dict(steps=4, ckpt_dir=d["ji8"], codec="int8", **CK)),
    ], weights)
    first = spawn_ranks(2, rank_fault_runs, {"weights": weights, "sizes": TWO, "runs": [
        dict(cfg=dict(steps=6, ckpt_dir=d["ref"], **CK)),
        dict(cfg=dict(steps=6, ckpt_dir=d["ft"], fail_at_step=4, **CK)),
        dict(cfg=dict(steps=50, ckpt_every=100, ckpt_dir=d["pre"]), preempt_rank=1),
        # the failure right after a slow save, then a restart in-process
        dict(cfg=dict(steps=4, ckpt_dir=d["race"], fail_at_step=2, **CK), slow_save=0.1),
        dict(cfg=dict(steps=4, ckpt_dir=d["race"], **CK)),
        dict(cfg=dict(steps=4, ckpt_dir=d["i8"], fail_at_step=2, codec="int8", **CK)),
    ]})
    second = spawn_ranks(2, rank_fault_runs, {"weights": weights, "sizes": TWO, "runs": [
        dict(cfg=dict(steps=6, ckpt_dir=d["ft"], **CK)),
        dict(cfg=dict(steps=4, ckpt_dir=d["i8"], codec="int8", **CK)),
        # the JAX package's checkpoint, restored by the port
        dict(cfg=dict(steps=4, ckpt_dir=d["ji8-port"], codec="int8", **CK)),
    ]})
    names = ["ref", "crash", "preempt", "race-crash", "race-restart", "i8-crash"]
    port = {n: [r[i] for r in first] for i, n in enumerate(names)}
    for i, n in enumerate(["restart", "i8-restart", "i8-from-jax"]):
        port[n] = [r[i] for r in second]
    return port, jax_out, d


def test_crash_restart_matches_uninterrupted(runs):
    """Injected failure at step 4 + restart in new ranks == uninterrupted
    run, bit for bit (no codec)."""
    port, _, _ = runs
    ref, crash, out = port["ref"], port["crash"], port["restart"]
    for rank in range(2):
        assert crash[rank]["error"] == "SimulatedFailure"
        assert crash[rank]["steps"] == [0, 1, 2, 3] and crash[rank]["latest"] == 4
        assert out[rank]["restored"] and out[rank]["steps"] == [4, 5]
        assert out[rank]["end"] == 6
        assert out[rank]["losses"] == ref[rank]["losses"][4:]
    for k, v in ref[0]["params"].items():
        np.testing.assert_array_equal(out[0]["params"][k], v, err_msg=k)
    for name, e in ref[1]["state"].items():
        for k, v in e.items():
            np.testing.assert_array_equal(out[1]["state"][name][k], v)


def test_crash_restart_matches_jax(runs):
    """The port's restart against the JAX Trainer's on the same weights
    (the JAX run drains its write before restarting)."""
    port, jax_out, _ = runs
    np.testing.assert_array_equal(jax_out["restart/steps"], [4, 5])
    np.testing.assert_allclose(port["restart"][0]["losses"],
                               jax_out["restart/loss"], rtol=1e-4)
    np.testing.assert_allclose(port["ref"][0]["losses"], jax_out["ref/loss"],
                               rtol=1e-4)
    jp = {k[len("restart/p/"):]: v for k, v in jax_out.items()
          if k.startswith("restart/p/")}
    check_params_close(port["restart"][0]["params"], jp, int8=False, steps=6)


def test_preemption_checkpoints_and_exits(runs):
    """One member flagged preempted: every member stops after the running
    step, and member 0 writes the emergency checkpoint of step 1."""
    for rec in runs[0]["preempt"]:
        assert rec["error"] is None and rec["end"] == 1 and rec["steps"] == [0]
        assert rec["latest"] == 1  # each member reads it back
    assert [r["step"] for r in runs[0]["preempt"][0]["ckpt_log"]] == [1]


def test_failure_right_after_a_slow_save_leaves_it_complete(runs):
    """The failure is injected right after an async save whose writes are
    slowed; the trainer drains the write before the exception leaves it,
    so the restart in the same processes restores the complete step."""
    port, _, _ = runs
    for rank in range(2):
        crash, out = port["race-crash"][rank], port["race-restart"][rank]
        assert crash["error"] == "SimulatedFailure" and crash["latest"] == 2
        assert out["restored"] and out["steps"] == [2, 3] and out["end"] == 4
    writes = port["race-crash"][0]["stats"]
    assert writes[0]["step"] == 2 and writes[0]["write_s"] > 0
    assert port["race-crash"][1]["stats"] == []  # member 1 writes nothing


def _read(path, step):
    from repro_torch.checkpoint import CheckpointManager
    return CheckpointManager(path, read_only=True).restore(step)


def test_int8_checkpoint_holds_pod0_ef_as_jax(runs):
    """The int8 EF has no pod entry in its spec, but each pod member's
    residual differs: the checkpoint holds pod 0's (the copy JAX's
    ``device_get`` saves, that of the device with replica_id 0), and
    equals the JAX checkpoint's to the EF tolerance of
    ``test_torch_trainer.py``."""
    from repro_torch.utils.trees import tree_paths
    port, _, d = runs
    mine, theirs = _read(d["i8"], 2), _read(d["ji8-port"], 2)
    assert set(tree_paths(mine)) == set(tree_paths(theirs))
    check_params_close(tree_paths(mine["params"]), tree_paths(theirs["params"]),
                       int8=True, steps=2)
    crash = {r["coords"]: r["state"] for r in port["i8-crash"]}
    pod0 = crash[(("data", 0), ("model", 0), ("pod", 0))]
    pod1 = crash[(("data", 0), ("model", 0), ("pod", 1))]
    assert np.asarray(mine["opt"]["step"]).dtype == np.int32
    n_ef = 0
    for name, e in mine["opt"]["sections"].items():
        for k, got in e.items():
            want = theirs["opt"]["sections"][name][k]
            rel = 1e-2 if k == "ef" else 1e-4
            close = np.abs(got - want) <= rel * np.abs(want).max() + 1e-12
            assert close.mean() >= 0.99, (name, k, close.mean())
        if "ef" in e:
            n_ef += 1
            np.testing.assert_array_equal(e["ef"], pod0[name]["ef"])
            # and the JAX checkpoint's is pod 0's too, not pod 1's
            want = theirs["opt"]["sections"][name]["ef"]
            close = np.abs(pod1[name]["ef"] - want) <= 1e-2 * np.abs(want).max()
            assert close.mean() < 0.5, (name, close.mean())
    assert n_ef == len(mine["opt"]["sections"]) > 0


def test_int8_restart_matches_jax(runs):
    """An int8 restart, from the port's checkpoint and from the JAX
    package's, against the JAX restart."""
    port, jax_out, _ = runs
    np.testing.assert_array_equal(jax_out["i8-restart/steps"], [2, 3])
    jp = {k[len("i8-restart/p/"):]: v for k, v in jax_out.items()
          if k.startswith("i8-restart/p/")}
    for name in ("i8-restart", "i8-from-jax"):
        rec = port[name][0]
        assert rec["restored"] and rec["steps"] == [2, 3]
        np.testing.assert_allclose(rec["losses"], jax_out["i8-restart/loss"],
                                   rtol=1e-3)
        check_params_close(rec["params"], jp, int8=True, steps=4)


def test_elastic_restore_different_mesh(tmp_path):
    """Save ZeRO-sharded state on 4 ranks (pod 2, data 2), restore on 2
    (data 2): the saved moments are the saving members' blocks put
    together, and are re-sliced to the new mesh's blocks."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core.topology import topology_from_mesh_sizes
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.optim import grad_sync
    from repro_torch.runtime.train_loop import make_sync_plan
    weights = smoke_weights(seed=7)
    cfg = dict(steps=4, ckpt_dir=str(tmp_path), **CK)
    big = {"pod": 2, "data": 2, "model": 1}
    small = {"pod": 1, "data": 2, "model": 1}
    saved = spawn_ranks(4, rank_fault_runs, {"weights": weights, "sizes": big,
                                             "runs": [dict(cfg=cfg)]})
    out = spawn_ranks(2, rank_fault_runs, {"weights": weights, "sizes": small,
                                           "runs": [dict(cfg=cfg)]})
    on_disk = _read(str(tmp_path), 4)
    model = build_model(get_smoke_arch("qwen2-0.5b"),
                        ModelSettings(param_dtype="float32", compute_dtype="float32"),
                        device="meta")
    # the saved global arrays hold every saving member's block (the
    # sharded moments were gathered to member 0)
    plan, ss = make_sync_plan(model, big, topology_from_mesh_sizes(big))
    specs = grad_sync.sync_state_specs(plan, model.param_shapes(), ss)
    n_sharded = 0
    for rec in saved:
        rec = rec[0]
        for name, e in specs["sections"].items():
            for k, spec in e.items():
                g = on_disk["opt"]["sections"][name][k]
                blk = grad_sync.local_block(g, spec, dict(rec["coords"]), big)
                n_sharded += blk.shape != g.shape
                np.testing.assert_array_equal(rec["state"][name][k], blk)
    assert n_sharded > 0
    plan, ss = make_sync_plan(model, small, topology_from_mesh_sizes(small))
    specs = grad_sync.sync_state_specs(plan, model.param_shapes(), ss)
    for rec in out:
        rec = rec[0]
        assert rec["restored"] and rec["end"] == 4 and rec["steps"] == []
        for name, e in specs["sections"].items():
            for k, spec in e.items():
                want = grad_sync.local_block(on_disk["opt"]["sections"][name][k],
                                             spec, dict(rec["coords"]), small)
                np.testing.assert_array_equal(rec["state"][name][k], want)
    for k, v in saved[0][0]["params"].items():
        assert np.isfinite(out[0][0]["params"][k]).all()
        np.testing.assert_array_equal(out[0][0]["params"][k], v)


def test_multi_rank_elastic_restart_battery():
    """A pod member dies mid-run on 8 ranks; the job restarts on the
    shrunk mesh (4 ranks) and replays the reference loss curve, held to
    the JAX battery's tolerance against the port's and the JAX package's
    runs; the serve-side half runs through the copied ``serve_sim``."""
    from conftest import run_multi_device
    here = os.path.dirname(os.path.abspath(__file__))
    out = run_multi_device(os.path.join(here, "batteries",
                                        "torch_faults_battery.py"), timeout=900)
    assert "ALL OK" in out
