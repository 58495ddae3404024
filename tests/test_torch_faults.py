"""The port's copies of the fabric simulator, the fleet simulator and the
audit stack (``repro_torch.{sim,serve_sim,obs}``) run through every case
of ``tests/test_faults.py`` — mid-run lane, expander and tenant deaths,
``FabricSpec.degrade``, the planner's elastic ``replan`` and ``PlanDiff``,
the ``degraded`` audit class — with outputs equal to the JAX package's
originals run on the same inputs, and the battery's serve-side scenario
with the same goodputs."""
import importlib
import json
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

def pkg(name: str):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")
    ns = types.SimpleNamespace(
        cm=m("core.cost_model"), mem=m("core.mempool"), nic=m("core.nicpool"),
        planner=m("core.planner"), sched=m("core.schedule"),
        topo=m("core.topology"), sim=m("sim.fabric_sim"), audit=m("obs.audit"),
        capture=m("obs.capture"), trace=m("obs.trace"), serve=m("serve_sim"))
    # a gradient leaf as each planner takes it
    ns.leaf = ((lambda shape: jax.ShapeDtypeStruct(shape, np.float32))
               if name == "repro" else
               (lambda shape: ns.planner.ShapeDtype(shape, "float32")))
    return ns


def _fab(P):
    return P.topo.three_tier_fabric(num_pods=2, hosts_per_pod=2, chips_per_host=2)


def _sched(P, fab, numel=1 << 18, chunks=2):
    return P.sched.build_schedule(fab, P.sched.SyncConfig(
        "hier_striped", chunks=chunks, pipeline=False), (numel,), 0)


def _events(res):
    return [(e.tenant, repr(e.leg), e.start, e.finish, e.lanes, e.round, e.chunk)
            for e in res.events]


# ---------------------------------------------------------------------------
# the cases of tests/test_faults.py, each returning what it observed
# ---------------------------------------------------------------------------


def case_lane_down(P):
    fab = _fab(P)
    s = _sched(P, fab)
    tenants = lambda: [P.sim.Tenant("cn0", s, rounds=2), P.sim.Tenant("cn1", s, rounds=2)]
    healthy = P.sim.simulate(fab, tenants(), pool=P.nic.NicPool(lanes=fab.pool_lanes))
    t_fail = healthy.makespan / 4
    lost = fab.pool_lanes - 0.5
    deg = P.sim.simulate(fab, tenants(), pool=P.nic.NicPool(lanes=fab.pool_lanes),
                         failures=[P.sim.lane_down(t_fail, lanes=lost)])
    assert deg.makespan > healthy.makespan * 1.05
    assert deg.failed_tenants == ()
    assert deg.pool.capacity_steps == [(0.0, fab.pool_lanes),
                                       (t_fail, fab.pool_lanes - lost)]
    assert deg.pool.degraded_since() == t_fail
    return dict(healthy=healthy.makespan, deg=deg.makespan, events=_events(deg),
                steps=deg.pool.capacity_steps,
                trace=json.dumps(P.trace.to_chrome_trace(deg), sort_keys=True))


def case_tenant_down(P):
    fab = _fab(P)
    s = _sched(P, fab)
    mk = lambda: [P.sim.Tenant("a", s, rounds=4),
                  P.sim.Tenant("b", s, rounds=1, after="a")]
    ref = P.sim.simulate(fab, mk(), pool=P.nic.NicPool(lanes=fab.pool_lanes))
    t_kill = ref.finish["a"] * 0.25
    res = P.sim.simulate(fab, mk(), pool=P.nic.NicPool(lanes=fab.pool_lanes),
                         failures=[P.sim.tenant_down(t_kill, "a")])
    assert res.failed_tenants == ("a",)
    assert res.finish["a"] == pytest.approx(t_kill)
    assert all(e.finish <= t_kill + 1e-12 for e in res.tenant_events("a"))
    assert res.finish["b"] < ref.finish["b"] and res.tenant_events("b")
    return dict(finish=res.finish, failed=res.failed_tenants, events=_events(res))


def case_device_down(P):
    mem = P.mem.MemPoolSpec.build(local_bw=100e9, local_channels=2,
                                  device_bw=1.5e9, devices=4, device_latency=2e-6)
    fab = P.topo.as_fabric(P.topo.paper_prototype_topology()).with_mem(mem)
    cfg = P.sched.SyncConfig("hier_striped", chunks=4, pipeline=False)
    sched = P.sched.build_schedule(fab, cfg, (1 << 20,)).with_staging("pool")
    cm = P.cm.CostModel(fab)
    healthy = P.sim.simulate(fab, [P.sim.Tenant("t0", sched, rounds=2)], cost=cm)
    deg = P.sim.simulate(fab, [P.sim.Tenant("t0", sched, rounds=2)], cost=cm,
                         failures=[P.sim.device_down(healthy.makespan / 2, "cxl3")])
    assert deg.makespan > healthy.makespan * 1.01
    assert deg.mem is not None and deg.mem.degraded_since() is not None
    assert [d.name for d in deg.mem.spec.devices].count("cxl3") == 0
    return dict(healthy=healthy.makespan, deg=deg.makespan, events=_events(deg),
                mem_steps=deg.mem.capacity_steps)


def case_failure_validation(P):
    fab = _fab(P)
    s = _sched(P, fab)
    mk = lambda: [P.sim.Tenant("t", s)]
    msgs = []
    for failure, match in [
            (P.sim.lane_down(0.0, path="nvlink"), "unknown lane group"),
            (P.sim.device_down(0.0, "cxl0"), "no co-simulated memory pool"),
            (P.sim.tenant_down(0.0, "ghost"), "unknown tenant"),
            (P.sim.FailureEvent(0.0, "asteroid"), "unknown failure kind")]:
        with pytest.raises(ValueError, match=match) as exc:
            P.sim.simulate(fab, mk(), failures=[failure])
        msgs.append(str(exc.value))
    return dict(msgs=msgs)


def case_degrade_pool_lanes(P):
    fab = _fab(P)
    deg = fab.degrade(pool_lanes=3.0)
    assert deg.pool_lanes == pytest.approx(fab.pool_lanes - 3.0)
    assert deg.depth == fab.depth
    with pytest.raises(ValueError):
        fab.degrade(pool_lanes=fab.pool_lanes)
    return dict(deg=repr(deg))


def case_degrade_tier_members_and_mem(P):
    mem = P.mem.MemPoolSpec.build(local_bw=100e9, device_bw=10e9, devices=2)
    fab = _fab(P).with_mem(mem)
    deg = fab.degrade(tier_members={"dcn": 1}, mem_devices=["cxl1"])
    assert deg.slowest.size == fab.slowest.size - 1
    assert [d.name for d in deg.mem.devices] == ["dram0", "dram1", "cxl0"]
    for kw, err in [(dict(tier_members={"warp": 1}), KeyError),
                    (dict(tier_members={"dcn": fab.slowest.size}), ValueError),
                    (dict(mem_devices=["cxl9"]), KeyError)]:
        with pytest.raises(err):
            fab.degrade(**kw)
    with pytest.raises(ValueError):
        _fab(P).degrade(mem_devices=["cxl0"])
    return dict(deg=repr(deg))


def case_replan_diff(P):
    fab = _fab(P).with_paths(P.topo.cxl_shortcut_path(lanes=2.0))
    shapes = {"w": P.leaf((1 << 20,))}
    planner = P.planner.Planner(fab, max_chunks=4)
    plan = planner.plan(shapes)
    new_plan, diff = planner.replan(fab.degrade(pool_lanes=3.5), shapes,
                                    old_plan=plan, reason="lane_down")
    assert diff.changed and diff.reason == "lane_down"
    assert any(d.knob == "path_split" for d in diff.deltas)
    assert "lane_down" in diff.describe()
    assert all(d.section and "->" in d.describe() for d in diff.deltas)
    assert new_plan.est_total_s > 0
    _, fresh = planner.replan(fab.degrade(pool_lanes=3.5), shapes)
    assert fresh.changed and set(fresh.added) == {s.name for s in new_plan.sections}
    assert fresh.deltas == () and fresh.removed == ()
    keep = P.planner.Planner(fab, max_chunks=4, keep_report=True)
    keep.plan(shapes)
    return dict(diff=diff.describe(), fresh=fresh.describe(),
                plan=new_plan.to_json(), report=keep.report.to_json())


def case_for_fabric(P):
    fab = _fab(P)
    planner = P.planner.Planner(fab, max_chunks=4)
    deg = fab.degrade(tier_members={"ici": 1})
    assert planner.for_fabric(deg).fast_sizes != planner.fast_sizes
    pinned = P.planner.Planner(fab, fast_axis_sizes=(2, 2), max_chunks=4)
    assert pinned.for_fabric(deg).fast_sizes == (2, 2)
    return dict(fast=planner.for_fabric(deg).fast_sizes)


def case_degraded_audit(P):
    fab = _fab(P)
    s = _sched(P, fab)
    with P.capture.capture() as observations:
        healthy = P.sim.simulate(fab, [P.sim.Tenant("cn0", s, rounds=2),
                                       P.sim.Tenant("cn1", s, rounds=2)],
                                 pool=P.nic.NicPool(lanes=fab.pool_lanes))
        P.sim.simulate(fab, [P.sim.Tenant("cn0", s, rounds=2),
                             P.sim.Tenant("cn1", s, rounds=2)],
                       pool=P.nic.NicPool(lanes=fab.pool_lanes),
                       failures=[P.sim.lane_down(healthy.makespan / 4,
                                                 lanes=fab.pool_lanes - 0.5)])
    assert len(observations) == 2
    rep = P.audit.audit_observation(observations[1])
    assert rep.ok, rep.describe()
    assert any(r.cls == "degraded" for r in rep.rows), rep.describe()
    return dict(report=rep.describe(), csv=rep.to_csv())


def case_serve_lane_death(P):
    """``faults_battery.py``'s serve-side scenario."""
    hw = P.topo.HardwareSpec()
    T = P.topo.Tier
    fab = P.topo.FabricSpec(tiers=(
        T("ici", "data", 4, hw.ici_bw, hw.ici_latency),
        T("cxl", "host", 2, hw.cxl_bw, hw.cxl_latency),
        T("dcn", "pod", 4, hw.dcn_bw, hw.dcn_latency, lanes=2.0),
    ), hw=hw, mem=P.mem.MemPoolSpec.build(local_bw=100e9, local_channels=2,
                                          device_bw=25e9, devices=4,
                                          device_latency=2e-6),
    ).with_paths(P.topo.cxl_shortcut_path(lanes=2.0))
    cfg = dict(slots=8, pool_lanes=4.0, bytes_per_token=16384.0,
               decode_sync_bytes=65536.0, kv_bytes_per_token=1024.0,
               step_compute_s=10e-6, kv_read_bw=20e9)
    S = P.serve
    sessions = S.generate_sessions(S.WorkloadConfig(sessions=12, rate=200.0, seed=7))
    healthy = S.simulate_fleet(fab, sessions, S.FleetConfig(**cfg))
    faults = [P.sim.lane_down(healthy.sim.makespan * 0.05, lanes=3.0)]
    deg = S.simulate_fleet(fab, sessions, S.FleetConfig(**cfg), failures=faults)
    rep = S.simulate_fleet(fab, sessions, S.FleetConfig(
        prefill_path_split=(("cxl", 0.75),), **cfg), failures=faults)
    assert deg.goodput_tok_s < healthy.goodput_tok_s < float("inf")
    assert rep.goodput_tok_s > deg.goodput_tok_s
    return dict(goodput=(healthy.goodput_tok_s, deg.goodput_tok_s,
                         rep.goodput_tok_s),
                makespan=(healthy.sim.makespan, deg.sim.makespan, rep.sim.makespan))


CASES = {f.__name__[len("case_"):]: f for f in (
    case_lane_down, case_tenant_down, case_device_down, case_failure_validation,
    case_degrade_pool_lanes, case_degrade_tier_members_and_mem, case_replan_diff,
    case_for_fabric, case_degraded_audit, case_serve_lane_death)}


@pytest.mark.parametrize("case", list(CASES))
def test_fault_case_matches_reference(case):
    """The port's copies pass the case, and observe what the originals do
    (floats compared exactly: the copies run the same arithmetic)."""
    got, want = (CASES[case](pkg(name)) for name in ("repro_torch", "repro"))
    assert got == want
