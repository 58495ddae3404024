"""Session -> Tenant expansion and the fleet scheduler.

This is where the repo's two halves finally meet: each
:class:`~repro.serve_sim.workload.Session` becomes TWO
:class:`~repro.sim.fabric_sim.Tenant` programs replayed through the
shared pools —

  * ``s0017p`` (prefill): one burst collective over the prompt's sync
    payload — a pipelined all-gather walk (dense) or an all-to-all
    dispatch (MoE) built by the REAL schedule builders, preceded by the
    prompt's compute;
  * ``s0017d`` (decode): ``output_tokens`` rounds of (step compute, one
    small sequential latency-dominated collective).  The decode wire
    payload carries the step's activation sync PLUS the KV-cache append
    bytes, staged ``local`` or ``pool`` per session (the planner prices
    both; a KV working set that outgrows the local budget is forced to
    the pool), and ``kv_read_bw`` lets each step's compute draw KV reads
    from the LOCAL memory channels (the C1 contention surface).

Phases and admission are expressed with ``Tenant.after`` chains, so the
event loop SIMULATES queueing instead of estimating it: a session's
decode runs ``after`` its prefill, and a queued session's prefill runs
``after`` the previous occupant of its batch slot.  The scheduler plans
only slot ASSIGNMENT (greedy earliest-estimated-free, from each
session's solo price); whether the slot is actually free is the
simulator's verdict.

SLO tiers map onto the arbiters: with ``priority_lanes`` each tenant's
flows carry its class's priority through the NicPool/MemPool weighted
max-min (interactive outranks batch); without it every flow weighs 1.0
— the equal-weight baseline ``benchmarks/fig_fleet.py`` compares
against.

The solo contract (the fleet's parity anchor): ONE session on an idle
fabric finishes in exactly ``prefill compute + prefill price +
rounds * (step compute + decode price)`` — :func:`solo_estimate_s`, the
same number ``deadline = slack * solo`` is derived from — because every
phase inherits the sim/cost parity of its schedule.

A copy of ``repro.serve_sim.fleet`` for the port (the port imports nothing of
``repro``): only its imports differ.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import CostModel, ScheduleEstimate
from repro_torch.core.schedule import (CommSchedule, SyncConfig, build_all_to_all,
                                 build_schedule)
from repro_torch.core.topology import FabricSpec, as_fabric
from repro_torch.core.nicpool import NicPool
from repro_torch.serve_sim.workload import Session
from repro_torch.sim.fabric_sim import (FailureEvent, SimResult, Tenant,
                                  simulate)
from repro_torch.utils.stats import percentile

_ELEM = 4  # float32 wire elements


def _round_up(n: int, k: int) -> int:
    k = max(k, 1)
    return ((max(n, 1) + k - 1) // k) * k


@dataclass(frozen=True)
class FleetConfig:
    """The fleet scheduler's knobs (per-chip bytes, like every payload
    in the cost model).

    ``slots`` is the continuous-batching capacity: at most ``slots``
    sessions hold the engine at once, the rest queue on ``after``
    chains.  ``bytes_per_token`` sizes the prefill sync payload;
    ``decode_sync_bytes`` + ``kv_bytes_per_token`` size each decode
    step's wire leg (activation sync plus the KV append).
    ``kv_local_budget_bytes`` is the per-slot local-DRAM budget: a
    session whose whole KV footprint fits may stage locally (cheaper
    when priced so), one that doesn't is forced to the pool devices.
    ``kv_read_bw`` > 0 makes each decode step's compute draw that much
    bandwidth from the LOCAL channels while it runs (0 = pure-time
    compute).  ``priority_lanes`` maps SLO priorities onto the arbiters;
    False runs the equal-weight baseline.

    ``pool_lanes`` fixes the NIC-pool capacity the fleet contends on;
    ``None`` uses the fabric's own rack pool (``FabricSpec.pool_lanes``).
    This matters: ``simulate``'s default pool SCALES with the tenant
    count (every tenant contributes its lanes — right for the θ-CN rack
    figures, wrong for serving, where the rack's NICs are fixed no
    matter how many sessions arrive).

    ``prefill_path_split`` routes that fraction of every prefill's slow
    sub-flows over the named alternative routes (``SyncConfig
    .path_split`` semantics; the fabric must declare them).  The elastic
    knob for a degraded fleet: after a mid-run lane death shrinks the
    Ethernet pool, replanned schedules shift prefill burst traffic onto
    the surviving routes."""

    slots: int = 8
    bytes_per_token: float = 4096.0
    decode_sync_bytes: float = 16384.0
    kv_bytes_per_token: float = 1024.0
    kv_local_budget_bytes: float = 1e6
    kv_read_bw: float = 0.0
    step_compute_s: float = 20e-6
    prefill_compute_s_per_token: float = 0.25e-6
    chunks: int = 4
    pipeline: bool = True
    priority_lanes: bool = True
    pool_lanes: Optional[float] = None
    prefill_path_split: Optional[Tuple[Tuple[str, float], ...]] = None

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1: {self.slots}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1: {self.chunks}")


@dataclass(frozen=True)
class SessionPlan:
    """One session's compiled plan: its two tenants, their prices, the
    solo estimate the deadline is derived from, and which slot it was
    assigned (``queued_after`` names the slot's previous decode tenant,
    None when the slot was planned free)."""

    session: Session
    prefill: Tenant
    decode: Tenant
    prefill_est: ScheduleEstimate
    decode_est: ScheduleEstimate
    solo_s: float
    deadline_s: float
    slot: int
    queued_after: Optional[str]

    @property
    def staging(self) -> Optional[str]:
        return self.decode.schedule.staging \
            if self.decode.schedule is not None else None


@dataclass(frozen=True)
class SessionMetrics:
    """Per-request serving metrics, all in seconds on the sim clock.
    ``ttft_s`` is first-token time (arrival -> the first decode round's
    last leg); ``tpot_s`` the mean per-output-token time after prefill;
    ``met`` whether the FULL response beat the class deadline."""

    uid: int
    name: str
    slo: str
    kind: str
    arrival: float
    prefill_done: float
    finish: float
    ttft_s: float
    tpot_s: float
    latency_s: float
    deadline_s: float
    met: bool
    output_tokens: int
    staging: Optional[str]


@dataclass(frozen=True)
class FleetResult:
    """A fleet run: the raw :class:`SimResult` plus per-session metrics
    and the aggregate serving numbers the figures plot."""

    sim: SimResult
    plans: Tuple[SessionPlan, ...]
    sessions: Tuple[SessionMetrics, ...]

    @property
    def makespan(self) -> float:
        return self.sim.makespan

    @property
    def goodput_tok_s(self) -> float:
        """Output tokens of DEADLINE-MET sessions per second of
        makespan — the serving goodput the paper's scaling claims are
        about (late tokens don't count)."""
        if self.makespan <= 0:
            return 0.0
        return sum(m.output_tokens for m in self.sessions if m.met) \
            / self.makespan

    @property
    def met_frac(self) -> float:
        return sum(1 for m in self.sessions if m.met) \
            / max(len(self.sessions), 1)

    def of_class(self, slo: str) -> Tuple[SessionMetrics, ...]:
        return tuple(m for m in self.sessions if m.slo == slo)

    def latency_pct(self, q: float, slo: Optional[str] = None) -> float:
        ms = self.of_class(slo) if slo else self.sessions
        return percentile([m.latency_s for m in ms], q)

    def ttft_pct(self, q: float, slo: Optional[str] = None) -> float:
        ms = self.of_class(slo) if slo else self.sessions
        return percentile([m.ttft_s for m in ms], q)

    def describe(self) -> str:
        classes = sorted({m.slo for m in self.sessions})
        lines = [f"FleetResult: {len(self.sessions)} sessions, makespan "
                 f"{self.makespan * 1e3:.2f} ms, goodput "
                 f"{self.goodput_tok_s:.0f} tok/s, "
                 f"met {100 * self.met_frac:.0f}%"]
        for c in classes:
            ms = self.of_class(c)
            lines.append(
                f"  {c}: n={len(ms)} "
                f"ttft p50 {self.ttft_pct(50, c) * 1e3:.2f} ms "
                f"p99 {self.ttft_pct(99, c) * 1e3:.2f} ms | "
                f"latency p50 {self.latency_pct(50, c) * 1e3:.2f} ms "
                f"p99 {self.latency_pct(99, c) * 1e3:.2f} ms | "
                f"met {sum(1 for m in ms if m.met)}/{len(ms)}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Schedule construction (per-session payloads through the real builders)
# ---------------------------------------------------------------------------


def _moe_members(fab: FabricSpec) -> int:
    n = 1
    for t in fab.tiers:
        if t.size > 1:
            n *= t.size
    return n


def prefill_schedule(fab: FabricSpec, s: Session,
                     cfg: FleetConfig) -> CommSchedule:
    """The prompt's burst collective: dense sessions run the pipelined
    hierarchical all-gather walk, MoE sessions the all-to-all dispatch.
    Payloads are rounded up to the builder's divisibility grain so the
    planned chunk count survives (the parity contract needs the
    schedule the estimate priced, not a clamped cousin)."""
    numel = int(math.ceil(s.prompt_tokens * cfg.bytes_per_token / _ELEM))
    if s.kind == "moe":
        n_total = _moe_members(fab)
        row = _round_up(int(math.ceil(numel / n_total)), cfg.chunks)
        sc = SyncConfig(strategy="hier_striped", chunks=cfg.chunks,
                        pipeline=False,
                        path_split=cfg.prefill_path_split)
        return build_all_to_all(fab, sc, (n_total, row))
    sc = SyncConfig(strategy="hier_striped", chunks=cfg.chunks,
                    pipeline=cfg.pipeline,
                    path_split=cfg.prefill_path_split)
    n = _round_up(numel, max(fab.n_fast, 1) * cfg.chunks)
    return build_schedule(fab, sc, (n,))


def decode_schedule(fab: FabricSpec, s: Session, cfg: FleetConfig,
                    cm: CostModel) -> CommSchedule:
    """One decode step's wire leg: activation sync plus the KV append,
    sequential (chunks=1 — at these sizes latency dominates and a
    pipeline would only add per-chunk floors).  KV staging is chosen PER
    SESSION: a KV footprint within the local budget prices ``local`` vs
    ``pool`` and keeps the cheaper (tie -> local, the lower-latency
    placement); one that outgrows the budget is forced to ``pool``."""
    payload = cfg.decode_sync_bytes + cfg.kv_bytes_per_token
    numel = _round_up(int(math.ceil(payload / _ELEM)), max(fab.n_fast, 1))
    sc = SyncConfig(strategy="hier_striped", chunks=1, pipeline=False)
    sched = build_schedule(fab, sc, (numel,))
    if fab.mem is None:
        return sched
    kv_total = (s.prompt_tokens + s.output_tokens) * cfg.kv_bytes_per_token
    if kv_total > cfg.kv_local_budget_bytes:
        return sched.with_staging("pool")
    local = cm.from_schedule(sched.with_staging("local"), mem=True).total_s
    pool = cm.from_schedule(sched.with_staging("pool"), mem=True).total_s
    return sched.with_staging("local" if local <= pool else "pool")


def _step_compute_s(fab: FabricSpec, cfg: FleetConfig) -> float:
    """Effective per-step compute: when the step draws KV reads from the
    local channels, a demand above what they deliver stretches the phase
    (``mem_bytes / deliverable``) — the same floor the sim enforces."""
    if cfg.kv_read_bw <= 0 or fab.mem is None:
        return cfg.step_compute_s
    deliverable = fab.mem.deliverable_bw("local")
    if deliverable <= 0 or cfg.kv_read_bw <= deliverable:
        return cfg.step_compute_s
    return cfg.step_compute_s * cfg.kv_read_bw / deliverable


def solo_estimate_s(s: Session, cfg: FleetConfig, fab: FabricSpec,
                    prefill_est: ScheduleEstimate,
                    decode_est: ScheduleEstimate) -> float:
    """The session's SOLO price — what it costs alone on an idle fabric.
    This is the fleet's parity anchor (the sim must reproduce it for a
    lone session) and the base of the class deadline."""
    prefill = s.prompt_tokens * cfg.prefill_compute_s_per_token \
        + prefill_est.total_s
    decode = s.output_tokens * (_step_compute_s(fab, cfg)
                                + decode_est.total_s)
    return prefill + decode


# ---------------------------------------------------------------------------
# The fleet scheduler
# ---------------------------------------------------------------------------


def plan_fleet(fabric, sessions: Sequence[Session],
               cfg: Optional[FleetConfig] = None,
               cost: Optional[CostModel] = None) -> List[SessionPlan]:
    """Compile sessions into tenant programs and assign batch slots.

    Sessions are taken in arrival order; each goes to the slot with the
    earliest ESTIMATED free time (greedy, from solo prices).  The
    session's prefill always chains ``after`` the slot's previous decode
    tenant — if the estimate was optimistic the simulator still enforces
    the slot capacity, and if it was pessimistic the chain costs nothing
    (the predecessor has already drained).  Deadlines are
    ``arrival + slack * solo`` per the session's SLO class."""
    cfg = cfg or FleetConfig()
    fab = as_fabric(fabric)
    cm = cost or CostModel(fab)
    slot_free = [0.0] * cfg.slots
    slot_tail: List[Optional[str]] = [None] * cfg.slots
    plans: List[SessionPlan] = []
    for s in sorted(sessions, key=lambda x: (x.arrival, x.uid)):
        pre = prefill_schedule(fab, s, cfg)
        dec = decode_schedule(fab, s, cfg, cm)
        mem = fab.mem is not None
        pre_est = cm.from_schedule(pre, mem=True) if mem \
            else cm.from_schedule(pre)
        dec_est = cm.from_schedule(dec, mem=True) if mem \
            else cm.from_schedule(dec)
        solo = solo_estimate_s(s, cfg, fab, pre_est, dec_est)
        pr = s.slo.priority if cfg.priority_lanes else 1.0
        k = min(range(cfg.slots), key=lambda i: (slot_free[i], i))
        queued_after = slot_tail[k]
        prefill = Tenant(
            name=s.name + "p", schedule=pre, start=s.arrival,
            compute_s=s.prompt_tokens * cfg.prefill_compute_s_per_token,
            rounds=1, priority=pr, after=queued_after)
        decode = Tenant(
            name=s.name + "d", schedule=dec, start=s.arrival,
            compute_s=cfg.step_compute_s, rounds=s.output_tokens,
            priority=pr,
            compute_mem_bw=cfg.kv_read_bw if mem else 0.0,
            after=prefill.name)
        plans.append(SessionPlan(
            session=s, prefill=prefill, decode=decode,
            prefill_est=pre_est, decode_est=dec_est, solo_s=solo,
            deadline_s=s.arrival + s.slo.slack * solo, slot=k,
            queued_after=queued_after
            if slot_free[k] > s.arrival + 1e-12 else None))
        slot_free[k] = max(slot_free[k], s.arrival) + solo
        slot_tail[k] = decode.name
    return plans


def _session_metrics(plan: SessionPlan, sim: SimResult) -> SessionMetrics:
    s = plan.session
    prefill_done = sim.finish[plan.prefill.name]
    finish = sim.finish[plan.decode.name]
    round0 = [e.finish for e in sim.tenant_events(plan.decode.name)
              if e.round == 0]
    ttft = (max(round0) if round0 else finish) - s.arrival
    tpot = (finish - prefill_done) / max(s.output_tokens, 1)
    latency = finish - s.arrival
    return SessionMetrics(
        uid=s.uid, name=s.name, slo=s.slo.name, kind=s.kind,
        arrival=s.arrival, prefill_done=prefill_done, finish=finish,
        ttft_s=ttft, tpot_s=tpot, latency_s=latency,
        deadline_s=plan.deadline_s,
        met=finish <= plan.deadline_s + 1e-12,
        output_tokens=s.output_tokens, staging=plan.staging)


def simulate_fleet(fabric, sessions: Sequence[Session],
                   cfg: Optional[FleetConfig] = None,
                   cost: Optional[CostModel] = None,
                   failures: Sequence[FailureEvent] = ()) -> FleetResult:
    """Plan the fleet and replay it through the pools: ONE ``simulate``
    call carries every session's prefill and decode tenant, so
    admission, phase chaining, SLO priorities and KV staging all
    arbitrate against each other — and the run flows through
    ``repro.obs`` (capture/audit/trace) like any other simulate call.
    ``failures`` injects mid-run capacity losses (``lane_down``/
    ``device_down``) into that one call — the schedules are still the
    HEALTHY-fabric plans, so the result shows what the degradation costs
    an un-replanned fleet."""
    cfg = cfg or FleetConfig()
    fab = as_fabric(fabric)
    cm = cost or CostModel(fab)
    plans = plan_fleet(fab, sessions, cfg, cm)
    tenants: List[Tenant] = []
    for p in plans:
        tenants.append(p.prefill)
        tenants.append(p.decode)
    lanes = cfg.pool_lanes if cfg.pool_lanes is not None \
        else (fab.pool_lanes if fab.depth > 1 else 1.0)
    sim = simulate(fab, tenants, pool=NicPool(lanes=lanes), cost=cm,
                   failures=failures)
    metrics = tuple(_session_metrics(p, sim)
                    for p in sorted(plans, key=lambda p: p.session.uid))
    return FleetResult(sim=sim, plans=tuple(plans), sessions=metrics)
