"""Elastic-restart battery of the PyTorch port — ``faults_battery.py``'s
scenario on gloo ranks: a pod member dies mid-run on 8 ranks (mesh pod 2,
host 2, data 2), the job restarts on the SHRUNK mesh (pod 1: 4 ranks),
restores the last checkpoint (the ZeRO-sharded state re-sliced to the new
mesh's blocks) and replays the loss curve.  The replayed losses are held,
at the JAX battery's tolerance, to the port's uninterrupted run and to the
JAX ``Trainer`` running the same scenario on fake devices.  The serve-side
half then kills most of the rack pool mid-fleet and asserts that replanned
schedules claw back goodput, through the port's copies of ``serve_sim``
and ``sim``."""
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # tests/: torch_harness, conftest

import numpy as np  # noqa: E402

from repro_torch.core.mempool import MemPoolSpec  # noqa: E402
from repro_torch.core.topology import (FabricSpec, HardwareSpec, Tier,  # noqa: E402
                                       cxl_shortcut_path)
from repro_torch.serve_sim import (FleetConfig, WorkloadConfig,  # noqa: E402
                                   generate_sessions, simulate_fleet)
from repro_torch.sim.fabric_sim import lane_down  # noqa: E402
from torch_harness import (jax_fault_runs, rank_fault_runs,  # noqa: E402
                           smoke_weights, spawn_ranks)

STEPS, FAIL_AT = 8, 4
FULL = {"pod": 2, "host": 2, "data": 2, "model": 1}
SHRUNK = {"pod": 1, "host": 2, "data": 2, "model": 1}
TOL = dict(rtol=5e-3, atol=1e-4)  # faults_battery.py's


def cfg(ckpt_dir, **kw):
    return dict(steps=STEPS, ckpt_every=2, ckpt_dir=ckpt_dir, **kw)


def main():
    tmp = tempfile.mkdtemp()
    d = {k: os.path.join(tmp, k) for k in ("ref", "ft", "jref", "jft")}
    weights = smoke_weights(seed=7)
    jax_out = jax_fault_runs([
        dict(name="ref", sizes=FULL, fresh=True, cfg=cfg(d["jref"])),
        dict(name="crash", sizes=FULL, fresh=True, cfg=cfg(d["jft"], fail_at_step=FAIL_AT)),
        dict(name="restart", sizes=SHRUNK, fresh=False, cfg=cfg(d["jft"])),
    ], weights)

    # uninterrupted reference, then a pod member dies at step 4 (the
    # checkpoint lands just before the failure) — 8 ranks
    ref, crash = zip(*spawn_ranks(8, rank_fault_runs, {
        "weights": weights, "sizes": FULL,
        "runs": [dict(cfg=cfg(d["ref"])), dict(cfg=cfg(d["ft"], fail_at_step=FAIL_AT))]},
        timeout=600))
    assert all(r["error"] == "SimulatedFailure" and r["latest"] == FAIL_AT for r in crash)
    ref_loss = dict(zip(ref[0]["steps"], ref[0]["losses"]))
    assert len(ref_loss) == STEPS

    # restart on the SHRUNK mesh: restore + replay to completion — 4 ranks
    out = [r[0] for r in spawn_ranks(4, rank_fault_runs, {
        "weights": weights, "sizes": SHRUNK, "runs": [dict(cfg=cfg(d["ft"]))]},
        timeout=600)]
    assert all(r["restored"] and r["end"] == STEPS for r in out)
    res_loss = dict(zip(out[0]["steps"], out[0]["losses"]))
    assert min(res_loss) == FAIL_AT, sorted(res_loss)  # resumed from step 4
    assert sorted(res_loss) == list(range(FAIL_AT, STEPS))
    jax_res = dict(zip(jax_out["restart/steps"].tolist(), jax_out["restart/loss"]))
    jax_ref = dict(zip(jax_out["ref/steps"].tolist(), jax_out["ref/loss"]))
    assert sorted(jax_res) == sorted(res_loss), sorted(jax_res)
    for s, loss in sorted(res_loss.items()):
        np.testing.assert_allclose(loss, ref_loss[s], err_msg=f"step {s}", **TOL)
        np.testing.assert_allclose(loss, jax_res[s], err_msg=f"step {s} vs JAX", **TOL)
    for s, loss in ref_loss.items():
        np.testing.assert_allclose(loss, jax_ref[s], err_msg=f"ref step {s} vs JAX", **TOL)
    print(f"elastic restart: {len(res_loss)} replayed steps on the shrunk mesh "
          f"match the reference and the JAX restart (last loss "
          f"{out[0]['losses'][-1]:.4f}, JAX {jax_res[STEPS - 1]:.4f})")

    # serve-side: mid-fleet lane death degrades goodput; replanned
    # schedules (prefill path_split onto the CXL shortcut) recover part of it
    hw = HardwareSpec()
    fab = FabricSpec(tiers=(
        Tier("ici", "data", 4, hw.ici_bw, hw.ici_latency),
        Tier("cxl", "host", 2, hw.cxl_bw, hw.cxl_latency),
        Tier("dcn", "pod", 4, hw.dcn_bw, hw.dcn_latency, lanes=2.0),
    ), hw=hw, mem=MemPoolSpec.build(local_bw=100e9, local_channels=2,
                                    device_bw=25e9, devices=4,
                                    device_latency=2e-6),
    ).with_paths(cxl_shortcut_path(lanes=2.0))

    serve_cfg = dict(slots=8, pool_lanes=4.0, bytes_per_token=16384.0,
                     decode_sync_bytes=65536.0, kv_bytes_per_token=1024.0,
                     step_compute_s=10e-6, kv_read_bw=20e9)
    sessions = generate_sessions(WorkloadConfig(sessions=12, rate=200.0, seed=7))

    healthy = simulate_fleet(fab, sessions, FleetConfig(**serve_cfg))
    faults = [lane_down(healthy.sim.makespan * 0.05, lanes=3.0)]
    deg = simulate_fleet(fab, sessions, FleetConfig(**serve_cfg), failures=faults)
    assert deg.goodput_tok_s < healthy.goodput_tok_s, \
        (deg.goodput_tok_s, healthy.goodput_tok_s)
    rep = simulate_fleet(
        fab, sessions,
        FleetConfig(prefill_path_split=(("cxl", 0.75),), **serve_cfg),
        failures=faults)
    assert rep.goodput_tok_s > deg.goodput_tok_s, \
        (rep.goodput_tok_s, deg.goodput_tok_s)
    print(f"serve: goodput {healthy.goodput_tok_s:.0f} -> "
          f"{deg.goodput_tok_s:.0f} tok/s on lane death, replanned recovers "
          f"to {rep.goodput_tok_s:.0f} tok/s")

    print("ALL OK")


# spawned ranks re-import this module: run only as the main script
if __name__ == "__main__":
    main()
