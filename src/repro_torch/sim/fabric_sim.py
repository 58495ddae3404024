"""Discrete-event fabric simulator — CommSchedules replayed in TIME.

The analytic cost model answers "how long does one Section's collective
take, alone".  The paper's Fig. 13 claim is about *concurrency*: θ CNs
time-share the NIC pool, a burst grabbing the whole pool while peers
compute.  This simulator replays one or more :class:`CommSchedule` leg
lists from concurrent tenants against a :class:`~repro.core.nicpool.NicPool`
— and, when the fabric carries a memory model, against a co-simulated
:class:`~repro.core.mempool.MemPool` — and emits per-leg start/finish
timelines and a makespan.

Model (one tenant)
------------------
Each tenant owns a serial **fast engine** (its ICI/CXL tiers — private,
never contended across tenants) and submits its slow-tier legs as **pool
flows** to the shared NIC pool:

  * compute phases (``Tenant.compute_s``) and fast legs (ReduceScatter /
    Psum / AllGather on non-slowest tiers) run back-to-back on the fast
    engine, each charged exactly its
    :meth:`CostModel.from_schedule <repro.core.cost_model.CostModel.from_schedule>`
    leg time;
  * slow legs (any leg on the slowest tier) become pool flows whose
    service demand is ``leg_seconds * Tier.lanes`` lane-seconds — granted
    its nominal lanes the flow takes exactly its priced time, granted the
    whole pool it speeds up proportionally (latency is folded into the
    scaled charge; bandwidth dominates at burst sizes);
  * a **sequential** schedule walks its legs in order; a **pipelined**
    schedule becomes the two-stage chunk pipeline the cost model credits:
    per chunk, a fast stage of ``fast_total / chunks`` then its slow
    flow, with fast stages serialized on the engine and one tenant's
    flows FIFO-chained.  The resulting makespan reproduces
    ``max(slow, fast) + min(per-chunk slow, per-chunk fast)`` exactly,
    so a single tenant on an uncontended pool matches
    ``ScheduleEstimate.total`` (the sim/cost parity contract).

All-to-all schedules (``CommSchedule.kind == "all_to_all"``, the §6.2
shuffle / MoE-dispatch traffic) replay their fast ``AllToAll`` stages on
the private engine like any fast leg, but each slow ``SlowChunk``
sub-flow expands into **per-destination flows**: one
:class:`~repro.core.nicpool.LaneRequest` (and, under a memory model, one
:class:`~repro.core.mempool.MemRequest`) per remote slow-tier member —
the per-expert flows of the MoE dispatch.  The destinations split the
leg's priced work and caps evenly, so one uncontended tenant still
matches ``CostModel.from_schedule`` exactly, while θ-way shuffle
contention, lane pinning/stagger and staging placement are arbitrated by
the pools instead of assumed.

Memory co-simulation (the paper's §4.1 pillar)
----------------------------------------------
When a memory pool is modeled (``fabric.mem`` or an explicit ``mem=``),
every slow-tier flow ALSO submits a memory flow: its wire bytes hit the
pool ``traffic_factor`` times (the NIC-DMA write in plus the CN-consume
read out), aggregated over the slow-tier group, staged per the
schedule's planned placement (local DRAM channels vs the device
interleave).  The wire flow and the memory flow drain in parallel and
the leg completes only when BOTH have — i.e. with constant grants the
tenant's effective slow rate is ``min(granted lanes, granted memory
bandwidth)``, which is exactly what ``CostModel.from_schedule(mem=...)``
charges (``max(wire seconds, memory seconds)`` per leg), preserving the
sim/cost parity contract in the memory-aware mode.  Compute phases with
``Tenant.compute_mem_bw > 0`` draw their demand from the LOCAL channels
while they run, so a burst's DMA and a peer's compute contend for the
same memory — the C1 memory wall: the NIC pool stops scaling when local
memory saturates, and recovers as pooled devices are added.  With no
memory model the code path (and every result) is bitwise what it was
before the memory pool existed.

Concurrency is where the sim says more than the formula: flows from many
tenants share the pools under the arbiters' weighted max-min (fluid) or
pinned-lane (static executor, honoring ``CommSchedule.lane_offset``)
allocation, and the timeline shows who got which lanes when.

A copy of ``repro.sim.fabric_sim`` for the port (the port imports nothing of
``repro``): only its imports differ.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Optional, Sequence, Tuple, Union)

from repro_torch.core.cost_model import CostModel, ScheduleEstimate
from repro_torch.core.mempool import MemPool, MemRequest
from repro_torch.core.nicpool import LaneRequest, NicPool
from repro_torch.core.schedule import CommSchedule
from repro_torch.core.topology import FabricSpec, as_fabric

_EPS = 1e-12

COMPUTE = "compute"  # the pseudo-leg label of a compute phase


def leg_label(leg) -> str:
    """Short human-readable label of a schedule leg (or the COMPUTE
    pseudo-leg), in the idiom of ``CommSchedule.describe``."""
    if leg == COMPUTE:
        return COMPUTE
    kind = getattr(leg, "kind", "?")
    if kind == "slow_chunk":
        path = getattr(leg, "path", "eth")
        suffix = "" if path == "eth" else f"@{path}"
        if getattr(leg, "dest_sizes", None) is not None:
            suffix += "~"
        return f"slow[{leg.index}/{leg.chunks}{suffix}]"
    short = {"reduce_scatter": "rs", "psum": "psum", "all_gather": "ag",
             "all_to_all": "a2a"}.get(kind, kind)
    return f"{short}[{leg.axis}x{leg.size}]"


# ---------------------------------------------------------------------------
# Inputs / outputs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Tenant:
    """One concurrent replay of a schedule (a CN, a serving job, a
    Section stream).

    ``rounds`` repeats (compute phase, collective) back to back —
    ``compute_s`` of local work precedes each collective.  ``max_lanes``
    caps the pool grant of this tenant's slow flows: None = the
    schedule's nominal lanes (no bursting), ``pool.lanes`` = fully
    opportunistic (the Fig. 13 burst).  ``pin_lanes`` pins sub-flow *i*
    to lane ``i mod pool_lanes`` — the static-executor constraint the
    planner's ``lane_offset`` staggering exists for.  ``compute_mem_bw``
    is the memory bandwidth (B/s, the tenant's aggregate) a compute
    phase draws from the LOCAL channels of a modeled memory pool; 0
    keeps compute phases pure time (always so when memory is
    unmodeled).

    ``after`` names another tenant this one must WAIT for: the tenant
    becomes startable only once every task of the named tenant has
    completed (its effective start is ``max(start, predecessor
    finish)``).  This is how the serving fleet expresses phase and
    admission dependencies — a session's decode tenant runs ``after``
    its prefill tenant, and a queued session's prefill runs ``after``
    the previous occupant of its batch slot — so queueing delay is
    SIMULATED through the pools instead of estimated.  ``None`` (the
    default) keeps the pre-fleet semantics bit for bit."""

    name: str
    schedule: Optional[CommSchedule]
    start: float = 0.0
    compute_s: float = 0.0
    rounds: int = 1
    priority: float = 1.0
    max_lanes: Optional[float] = None
    pin_lanes: bool = False
    compute_mem_bw: float = 0.0
    after: Optional[str] = None


@dataclass(frozen=True)
class LegEvent:
    """One leg's (or compute phase's) busy interval.  ``lanes`` is the
    mean granted lane count (pool flows only, else 0).  Pipelined fast
    stages are attributed per chunk: each fast leg gets one event per
    chunk, its per-chunk share of the stage window."""

    tenant: str
    leg: object  # schedule leg, or the COMPUTE label
    start: float
    finish: float
    lanes: float = 0.0
    round: int = 0
    chunk: int = -1


@dataclass(frozen=True)
class FailureEvent:
    """One fault injected into the replay, applied at time ``t``:

      * ``"lane_down"`` — ``lanes`` lanes of lane group ``name`` die
        (:meth:`NicPool.shrink`); pinned flows on a dead lane follow
        ``policy`` ("rehome" moves them to a surviving lane, "fail"
        kills the owning tenant);
      * ``"device_down"`` — memory device ``name`` (a CXL expander)
        drops (:meth:`MemPool.drop_device`); surviving flows re-stripe;
      * ``"tenant_down"`` — tenant ``name`` (a CN) departs: its active
        flows are cancelled, its unfinished tasks abandoned at ``t``,
        and its ``after`` successors unblock (the slot frees).

    Use the :func:`lane_down` / :func:`device_down` /
    :func:`tenant_down` constructors; ``simulate(failures=[...])``
    consumes the stream in time order."""

    t: float
    kind: str  # "lane_down" | "device_down" | "tenant_down"
    name: str = "eth"  # lane group / memory device / tenant, per kind
    lanes: float = 1.0
    policy: str = "rehome"  # dead-lane pinned flows: "rehome" | "fail"


def lane_down(t: float, lanes: float = 1.0, path: str = "eth",
              policy: str = "rehome") -> FailureEvent:
    """``lanes`` lanes of lane group ``path`` die at ``t``."""
    return FailureEvent(float(t), "lane_down", path, float(lanes), policy)


def device_down(t: float, name: str) -> FailureEvent:
    """Memory device ``name`` (a CXL expander) dies at ``t``."""
    return FailureEvent(float(t), "device_down", name)


def tenant_down(t: float, name: str) -> FailureEvent:
    """Tenant ``name`` (a CN) departs at ``t``."""
    return FailureEvent(float(t), "tenant_down", name)


@dataclass(frozen=True)
class SimResult:
    makespan: float
    events: Tuple[LegEvent, ...]
    finish: Dict[str, float]  # per-tenant completion time
    pool: NicPool
    mem: Optional[MemPool] = None
    # one extra arbitrated lane group per declared PathSpec route
    # (name -> its NicPool); empty when the fabric declares no paths
    path_pools: Dict[str, NicPool] = field(default_factory=dict)
    # tenants killed mid-run by a failure (tenant_down, or a dead pinned
    # lane under policy="fail"); their `finish` is the time of death and
    # their remaining tasks never ran
    failed_tenants: Tuple[str, ...] = ()

    def tenant_events(self, name: str) -> Tuple[LegEvent, ...]:
        return tuple(e for e in self.events if e.tenant == name)

    def slow_events(self, name: Optional[str] = None) -> Tuple[LegEvent, ...]:
        return tuple(e for e in self.events if e.lanes > 0
                     and (name is None or e.tenant == name))

    @property
    def peak_pool_lanes(self) -> float:
        return self.pool.peak_lanes()

    @property
    def peak_mem_bw(self) -> float:
        """Peak total RECORDED memory-pool draw over the run — the
        paper's "memory pool demand" during a burst.  0 when memory was
        unmodeled, and also when the pool provably could not bind any
        flow (the ∞-bandwidth fast path skips co-simulation, leaving
        ``mem`` attached with an empty trace — see ``simulate``)."""
        return self.mem.peak_bw() if self.mem is not None else 0.0

    def describe(self, max_tenants: int = 32) -> str:
        """Human-readable timeline summary, mirroring
        ``CommSchedule.describe``: makespan and pool peaks, then each
        tenant's finish and per-leg [start, finish] intervals (µs).

        Fleet-scale hygiene: above ``max_tenants`` tenants (sorted by
        name) the per-leg detail is elided into ONE aggregate line —
        finish-time p50/p99/max over the elided tenants — so a
        1000-session serving sim stays a screenful instead of a
        megabyte.  ``max_tenants=0`` elides everything but the totals."""
        from repro_torch.utils.stats import percentile
        lines = [f"SimResult: makespan {self.makespan * 1e6:.2f} us, "
                 f"{len(self.events)} events, "
                 f"{len(self.finish)} tenants, "
                 f"peak lanes {self.peak_pool_lanes:.2f}, "
                 f"peak mem bw {self.peak_mem_bw / 1e9:.2f} GB/s"]
        names = sorted(self.finish)
        shown = names if len(names) <= max_tenants else names[:max_tenants]
        by_tenant: Dict[str, List[LegEvent]] = {n: [] for n in shown}
        if shown:
            for e in self.events:
                if e.tenant in by_tenant:
                    by_tenant[e.tenant].append(e)
        for name in shown:
            lines.append(f"  {name}: finish {self.finish[name] * 1e6:.2f} us")
            for e in by_tenant[name]:
                tags = []
                if e.round:
                    tags.append(f"r{e.round}")
                if e.lanes > 0:
                    tags.append(f"lanes={e.lanes:.2f}")
                tag = (" " + " ".join(tags)) if tags else ""
                lines.append(
                    f"    [{e.start * 1e6:>10.2f} -> {e.finish * 1e6:>10.2f}]"
                    f" us {leg_label(e.leg)}{tag}")
        rest = names[len(shown):]
        if rest:
            restset = set(rest)
            n_ev = sum(1 for e in self.events if e.tenant in restset)
            fins = [self.finish[n] for n in rest]
            lines.append(
                f"  ... {len(rest)} more tenants ({n_ev} events) elided: "
                f"finish p50 {percentile(fins, 50) * 1e6:.2f} us, "
                f"p99 {percentile(fins, 99) * 1e6:.2f} us, "
                f"max {max(fins) * 1e6:.2f} us")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Observers (repro.obs.capture): notified AFTER a simulate() run with the
# finished result — the hook cannot perturb the event loop, so capturing a
# trace is bitwise non-invasive by construction.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimObservation:
    """Everything :mod:`repro.obs` needs to export one run: the resolved
    fabric, the tenants as submitted, the cost model the replay charged
    legs with, and the finished result."""

    fabric: FabricSpec
    tenants: Tuple[Tenant, ...]
    cost: CostModel
    result: SimResult
    failures: Tuple[FailureEvent, ...] = ()


_observers: List[Callable[[SimObservation], None]] = []


def add_observer(fn: Callable[[SimObservation], None]) -> None:
    _observers.append(fn)


def remove_observer(fn: Callable[[SimObservation], None]) -> None:
    try:
        _observers.remove(fn)
    except ValueError:
        pass


# ---------------------------------------------------------------------------
# Tenant programs (task DAGs)
# ---------------------------------------------------------------------------


class _Task:
    __slots__ = ("kind", "dur", "work", "deps", "legs", "round", "chunk",
                 "lane", "state", "start", "finish", "flow_id",
                 "mem_bytes", "mem_cap", "staging", "mem_flow_id",
                 "wire_done", "mem_done", "nic_lanes", "lane_share", "path")

    def __init__(self, kind, *, dur=0.0, work=0.0, deps=(), legs=(),
                 rnd=0, chunk=-1, lane=None, mem_bytes=0.0, mem_cap=None,
                 staging=None, lane_share=1.0, path="eth"):
        self.kind = kind  # "local" | "pool"
        self.dur = dur
        self.work = work
        self.deps = list(deps)
        self.legs = list(legs)  # [(leg, seconds_weight)]
        self.round = rnd
        self.chunk = chunk
        self.lane = lane
        self.state = "waiting"  # waiting | running | done
        self.start = 0.0
        self.finish = 0.0
        self.flow_id = -1
        # memory co-simulation: a task completes only when its wire work
        # (NIC flow / engine timer) AND its memory flow have both drained
        self.mem_bytes = mem_bytes
        self.mem_cap = mem_cap
        self.staging = staging
        self.mem_flow_id = -1
        self.wire_done = False
        self.mem_done = mem_bytes <= 0.0
        self.nic_lanes = 0.0  # mean granted lanes of the completed flow
        # a per-destination sub-flow's fraction of its leg's lane budget
        # (1/ndest for all-to-all slow legs, 1.0 otherwise): nominal and
        # max_lanes caps are scaled by it at submit time so the ndest
        # flows together never exceed what the ONE leg was entitled to
        self.lane_share = lane_share
        # which lane group ("eth" = the main NicPool, else a declared
        # PathSpec's own pool) a pool task is arbitrated on
        self.path = path


def _is_pool_leg(leg, fab: FabricSpec) -> bool:
    """A leg crosses the NIC pool when it runs on the slowest tier —
    matched by tier NAME or mesh AXIS, like ``CostModel.from_schedule``'s
    ``tier_for`` (schedules built without ``tier_names`` carry the axis
    name in ``leg.tier``)."""
    if fab.depth <= 1:
        return False
    slow = fab.slowest
    return leg.tier == slow.name or leg.axis == slow.axis \
        or leg.tier == slow.axis


def _compile(tenant: Tenant, est: Optional[ScheduleEstimate],
             fab: FabricSpec, pool_lanes: float, mem_spec,
             path_pool_lanes: Optional[Dict[str, float]] = None
             ) -> List[_Task]:
    """Expand one tenant into its task DAG (see module docstring)."""
    nominal = fab.slowest.lanes if fab.depth > 1 else 1.0
    grp = max(fab.n_fast, 1)
    sched = tenant.schedule
    tasks: List[_Task] = []
    tail: List[int] = []  # tasks the next round waits on
    path_pool_lanes = path_pool_lanes or {}

    def route_of(leg) -> str:
        # a route the fabric does not declare rides (and queues on) the
        # Ethernet pool — the exact degradation pricing applies
        p = getattr(leg, "path", "eth")
        if p != "eth" and fab.path_named(p) is None:
            p = "eth"
        return p

    def nominal_of(path: str) -> float:
        if path != "eth":
            return fab.path_named(path).lanes
        return nominal

    def lane_of(chunk_index: int, path: str = "eth") -> Optional[int]:
        if not tenant.pin_lanes:
            return None
        cap = path_pool_lanes.get(path, pool_lanes)
        return chunk_index % max(int(math.ceil(cap)), 1)

    def mem_of(lc, path: str = "eth") -> dict:
        """Memory-flow kwargs of one slow leg: its wire bytes hit the
        pool ``traffic_factor`` times aggregated over the group, capped
        at the flow's own max draw (wire rate at its lane cap) — the
        exact twin of ``CostModel._mem_leg_seconds``.  Alternative-route
        flows cap at THEIR route's bw/lanes (``max_lanes`` bursts the
        Ethernet pool only — each path is its own lane group)."""
        if mem_spec is None:
            return {}
        if path != "eth":
            spec = fab.path_named(path)
            cap_lanes, wire_bw = spec.lanes, spec.bw
        else:
            cap_lanes = tenant.max_lanes if tenant.max_lanes is not None \
                else nominal
            wire_bw = fab.slowest.bw
        return dict(
            mem_bytes=mem_spec.traffic_factor * grp * lc.bytes_per_chip,
            mem_cap=mem_spec.traffic_factor * grp * wire_bw
            * max(cap_lanes, _EPS),
            staging=sched.staging if sched is not None else None)

    for r in range(max(tenant.rounds, 1)):
        head = list(tail)
        if tenant.compute_s > 0:
            cm_kw = {}
            if mem_spec is not None and tenant.compute_mem_bw > 0:
                # compute reads its working set from the LOCAL channels
                cm_kw = dict(
                    mem_bytes=tenant.compute_s * tenant.compute_mem_bw,
                    mem_cap=tenant.compute_mem_bw, staging="local")
            tasks.append(_Task("local", dur=tenant.compute_s, deps=head,
                               legs=[(COMPUTE, tenant.compute_s)], rnd=r,
                               **cm_kw))
            head = [len(tasks) - 1]
        if sched is None or est is None or not sched.legs:
            tail = head
            continue
        charges = est.leg_charges
        a2a = sched.kind == "all_to_all"
        slow = [lc for lc in charges if _is_pool_leg(lc.leg, fab)]
        if sched.pipelined and sched.chunks > 1 and slow:
            # the two-stage chunk pipeline the cost model credits
            # (slow in issue order; a pipelined schedule with no pool
            # legs — hand-built / degenerate — replays sequentially)
            fast = [lc for lc in charges
                    if not _is_pool_leg(lc.leg, fab)]
            C = len(slow)
            fast_total = sum(lc.seconds for lc in fast)
            prev_local = head
            # one FIFO chain PER ROUTE: routes drain concurrently, flows
            # within a route stay ordered (single-route schedules get
            # exactly the old single prev_flow chain)
            flow_tail: Dict[str, List[int]] = {}
            for j, slc in enumerate(slow):
                tasks.append(_Task(
                    "local", dur=fast_total / C, deps=prev_local,
                    legs=[(lc.leg, lc.seconds) for lc in fast], rnd=r,
                    chunk=slc.leg.index))
                prev_local = [len(tasks) - 1]
                p = route_of(slc.leg)
                tasks.append(_Task(
                    "pool", work=slc.seconds * nominal_of(p),
                    deps=prev_local + flow_tail.get(p, []),
                    legs=[(slc.leg, slc.seconds)], rnd=r,
                    chunk=slc.leg.index, lane=lane_of(slc.leg.index, p),
                    path=p, **mem_of(slc, p)))
                flow_tail[p] = [len(tasks) - 1]
            tail = prev_local + [i for ids in flow_tail.values()
                                 for i in ids]
        else:
            prev = head
            # within one contiguous slow group, sub-flows FIFO-chain PER
            # ROUTE (each route is its own lane group, so the chains
            # drain concurrently); whatever follows the group waits on
            # every route's tail.  Single-route schedules reproduce the
            # old single chain event-for-event.
            slow_entry: Optional[List[int]] = None
            path_tails: Dict[str, List[int]] = {}
            for lc in charges:
                if _is_pool_leg(lc.leg, fab):
                    if slow_entry is None:
                        slow_entry = list(prev)
                        path_tails = {}
                    p = route_of(lc.leg)
                    chunk = getattr(lc.leg, "index", 0)
                    # an all-to-all slow sub-flow is REALLY (n-1)
                    # point-to-point transfers, one per destination
                    # member (per-expert flows in the MoE dispatch):
                    # replay each as its own lane/memory flow so θ-way
                    # shuffle contention is arbitrated, not analytic.
                    # The destinations split the leg's work and caps
                    # evenly, so an uncontended leg still completes in
                    # exactly its priced time (sim/cost parity).
                    ndest = max(int(getattr(lc.leg, "size", 1)) - 1, 1) \
                        if a2a else 1
                    mk = mem_of(lc, p)
                    if mk and ndest > 1:
                        mk = dict(mk, mem_bytes=mk["mem_bytes"] / ndest,
                                  mem_cap=mk["mem_cap"] / ndest)
                    # a SKEWED sub-flow (dest_sizes) expands at its TRUE
                    # per-destination sizes: flow r's share of the
                    # incast-priced leg is dest_sizes[r] / max(dest_sizes)
                    # (the self row — no wire — drops as the smallest),
                    # so the hottest flow takes exactly the priced leg
                    # seconds, colder flows finish earlier, and the
                    # arbiter sees each flow's real lane-seconds under
                    # contention.  Uniform legs keep weights of 1 — the
                    # expansion is unchanged bit for bit.
                    ds = getattr(lc.leg, "dest_sizes", None) if a2a else None
                    if ds is not None and ndest > 1:
                        sel = sorted(ds, reverse=True)[:ndest]
                        wts = [b / max(sel[0], _EPS) for b in sel]
                    else:
                        wts = [1.0] * ndest
                    ids = []
                    for w in wts:
                        wmk = mk
                        if mk and w != 1.0:
                            wmk = dict(mk, mem_bytes=mk["mem_bytes"] * w)
                        tasks.append(_Task(
                            "pool",
                            work=lc.seconds * nominal_of(p) * w / ndest,
                            deps=slow_entry + path_tails.get(p, []),
                            legs=[(lc.leg, lc.seconds * w / ndest)],
                            rnd=r, chunk=chunk, lane=lane_of(chunk, p),
                            lane_share=1.0 / ndest, path=p, **wmk))
                        ids.append(len(tasks) - 1)
                    path_tails[p] = ids
                    prev = slow_entry + [i for t_ in path_tails.values()
                                         for i in t_]
                else:
                    slow_entry = None
                    tasks.append(_Task("local", dur=lc.seconds, deps=prev,
                                       legs=[(lc.leg, lc.seconds)], rnd=r))
                    prev = [len(tasks) - 1]
            tail = prev
    return tasks


# ---------------------------------------------------------------------------
# The event loop
# ---------------------------------------------------------------------------


def simulate(fabric: Union[FabricSpec, object], tenants: Sequence[Tenant],
             pool: Optional[NicPool] = None,
             cost: Optional[CostModel] = None,
             mem: Optional[MemPool] = None,
             path_pools: Optional[Dict[str, NicPool]] = None,
             failures: Sequence[FailureEvent] = ()) -> SimResult:
    """Replay ``tenants`` concurrently against ``pool`` (and ``mem``).

    ``failures`` injects :class:`FailureEvent` faults: each is applied at
    the first event boundary at or after its time — lane groups shrink
    (surviving flows re-waterfill, completed work conserved), memory
    devices drop (flows re-stripe), tenants depart (flows cancelled,
    ``after`` successors unblock).  The pools' ``capacity_steps`` record
    every step so observability can render the degraded intervals.

    ``pool`` defaults to ``NicPool.from_fabric(fabric, len(tenants))`` —
    every tenant contributes its nominal lanes (the rack pool).  Each
    declared ``PathSpec`` route gets its OWN lane group: ``path_pools``
    maps route name -> pool, defaulting to
    ``NicPool.for_path(fabric, name, len(tenants))`` per declared route —
    concurrent tenants contend on each route independently, and a
    tenant's ``max_lanes`` burst applies to the Ethernet pool only.
    ``mem`` defaults to ``fabric.mem.make_pool()`` when the fabric
    carries a memory model, else memory is unmodeled.  Fast legs are
    charged per :meth:`CostModel.from_schedule`; slow legs go through
    the arbiters (wire AND memory — see the module docstring).  Returns
    per-leg events, per-tenant finish times, and the makespan."""
    fab = as_fabric(fabric)
    cm = cost or CostModel(fab)
    pool = pool or NicPool.from_fabric(fab, tenants=len(tenants))
    path_pools = dict(path_pools or {})
    for p in fab.paths:
        if p.name not in path_pools:
            path_pools[p.name] = NicPool.for_path(fab, p.name,
                                                  tenants=len(tenants))
    for pname, pl in [("eth", pool)] + list(path_pools.items()):
        if pl.active or pl.segments:
            # a reused pool would merge allocation traces across runs and
            # silently corrupt peak_lanes / busy_lane_seconds
            raise ValueError(
                f"pool {pname!r} already has flows or a recorded trace; "
                "pass fresh pools per simulate() run")
    if mem is None and fab.mem is not None:
        mem = fab.mem.make_pool()
    if mem is not None and (mem.active or mem.segments):
        raise ValueError("mem pool already has flows or a recorded trace; "
                         "pass a fresh MemPool per simulate() run")
    mem_spec = mem.spec if mem is not None else None

    ppl = {name: pl.lanes for name, pl in path_pools.items()}
    progs: List[List[_Task]] = []
    for tn in tenants:
        est = cm.from_schedule(tn.schedule) if tn.schedule is not None else None
        progs.append(_compile(tn, est, fab, pool.lanes, mem_spec,
                              path_pool_lanes=ppl))

    faults = sorted((failures or ()), key=lambda f: f.t)
    has_dev_faults = any(f.kind == "device_down" for f in faults)
    if mem is not None and not has_dev_faults:
        # ∞-bandwidth fast path: when EVERY device is faster than the sum
        # of all flow caps and no placement carries a latency tail, the
        # memory pool can never bind any flow — drop the memory flows
        # entirely so the event stream (and every completion time) is
        # BITWISE the no-memory run's (interior mem events would otherwise
        # perturb the NIC flows' piecewise fp arithmetic by an ulp).
        # A pending device_down disables the shortcut: the post-failure
        # pool may well bind, so memory must stay co-simulated.
        mtasks = [task for prog in progs for task in prog if not task.mem_done]
        total_cap = sum(task.mem_cap for task in mtasks)
        tails = max((mem_spec.staging_latency(task.staging)
                     for task in mtasks), default=0.0)
        if mtasks and tails <= 0.0 \
                and min(d.bw for d in mem_spec.devices) >= total_cap:
            for task in mtasks:
                task.mem_done = True
            mtasks = []
        if not mtasks:
            # the pool stays on the SimResult (memory WAS modeled, it
            # just cannot bind) with an empty trace; only the event-loop
            # participation is skipped
            result_mem, mem, mem_spec = mem, None, None
    else:
        result_mem = None
    if mem is not None:
        result_mem = mem

    names = [tn.name for tn in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    idx_of = {tn.name: i for i, tn in enumerate(tenants)}
    for tn in tenants:
        if tn.after is None:
            continue
        if tn.after not in idx_of:
            raise ValueError(
                f"tenant {tn.name!r} waits after unknown tenant "
                f"{tn.after!r}")
        seen = {tn.name}
        cur: Optional[str] = tn.after
        while cur is not None:
            if cur in seen:
                raise ValueError(
                    f"after-chain cycle through tenant {cur!r}")
            seen.add(cur)
            cur = tenants[idx_of[cur]].after

    # open tasks per tenant: lets the start pass skip finished tenants
    # and gates `after` successors (0 = the predecessor has fully drained)
    remaining = [len(p) for p in progs]
    # per-tenant WAITING task indices in program order: the start pass
    # walks only these instead of rescanning the whole program — at
    # fleet scale (hundreds of decode tenants x hundreds of rounds) the
    # full rescan is O(total tasks) per event and dominates the run
    waiting: List[List[int]] = [list(range(len(p))) for p in progs]

    engine_task: List[Optional[int]] = [None] * len(tenants)  # running local
    pools = {"eth": pool, **path_pools}  # lane group name -> arbiter
    for f in faults:
        if f.kind == "lane_down":
            if f.name not in pools:
                raise ValueError(f"lane_down on unknown lane group "
                                 f"{f.name!r}: have {sorted(pools)}")
        elif f.kind == "device_down":
            if mem is None:
                raise ValueError(
                    "device_down on a run with no co-simulated memory pool")
            if all(d.name != f.name for d in mem.spec.devices):
                raise ValueError(
                    f"device_down on unknown device {f.name!r}: have "
                    f"{[d.name for d in mem.spec.devices]}")
        elif f.kind == "tenant_down":
            if f.name not in idx_of:
                raise ValueError(
                    f"tenant_down on unknown tenant {f.name!r}")
        else:
            raise ValueError(f"unknown failure kind {f.kind!r}")
    # flow ids are per-pool counters, so key by (lane group, flow id)
    flows: Dict[Tuple[str, int], Tuple[int, int]] = {}
    mem_flows: Dict[int, Tuple[int, int]] = {}  # mem flow id -> (tenant, task)
    events: List[LegEvent] = []
    finish = {tn.name: 0.0 for tn in tenants}

    def deps_done(ti: int, task: _Task) -> bool:
        return all(progs[ti][d].state == "done" for d in task.deps)

    def emit_local(tn: Tenant, task: _Task) -> None:
        total = sum(w for _, w in task.legs)
        t0 = task.start
        span = task.finish - task.start
        for leg, w in task.legs:
            frac = (w / total) if total > 0 else 1.0 / max(len(task.legs), 1)
            t1 = min(t0 + span * frac, task.finish)
            events.append(LegEvent(tn.name, leg, t0, t1, 0.0, task.round,
                                   task.chunk))
            t0 = t1

    def submit_mem(ti: int, idx: int, task: _Task, now: float) -> None:
        if mem is None or task.mem_done:
            return
        tn = tenants[ti]
        task.mem_flow_id = mem.submit(MemRequest(
            tenant=tn.name, nbytes=task.mem_bytes, arrive=now,
            cap_bw=task.mem_cap, priority=tn.priority,
            staging=task.staging, tag=task.legs[0][0]), now)
        mem_flows[task.mem_flow_id] = (ti, idx)

    def complete_pool_task(ti: int, idx: int, now: float) -> None:
        task = progs[ti][idx]
        task.state = "done"
        task.finish = now
        remaining[ti] -= 1
        events.append(LegEvent(tenants[ti].name, task.legs[0][0],
                               task.start, now, task.nic_lanes,
                               task.round, task.chunk))
        finish[tenants[ti].name] = max(finish[tenants[ti].name], now)

    def complete_local_task(ti: int, idx: int, now: float) -> None:
        task = progs[ti][idx]
        task.state = "done"
        task.finish = now
        remaining[ti] -= 1
        emit_local(tenants[ti], task)
        finish[tenants[ti].name] = max(finish[tenants[ti].name], now)
        engine_task[ti] = None

    failed_tenants: List[str] = []

    def kill_tenant(ti: int, now: float) -> None:
        """Abandon a departed tenant at ``now``: cancel its active pool
        and memory flows (no grants recorded), truncate its running
        intervals in the event stream, and zero its open-task count so
        ``after`` successors unblock (the slot frees)."""
        name = tenants[ti].name
        if name in failed_tenants:
            return
        failed_tenants.append(name)
        for key in [k for k, v in flows.items() if v[0] == ti]:
            pools[key[0]].cancel(key[1])
            del flows[key]
        if mem is not None:
            for mfid in [k for k, v in mem_flows.items() if v[0] == ti]:
                mem.cancel(mfid)
                del mem_flows[mfid]
        for task in progs[ti]:
            if task.state == "running":
                # truncated interval: shows WHERE the tenant died
                events.append(LegEvent(name, task.legs[0][0], task.start,
                                       now, 0.0, task.round, task.chunk))
            task.state = "done"
        remaining[ti] = 0
        waiting[ti] = []
        engine_task[ti] = None
        finish[name] = max(finish[name], now)

    t = min((tn.start for tn in tenants), default=0.0)
    fault_i = 0
    guard = 0
    total_tasks = sum(len(p) for p in progs)
    while True:
        guard += 1
        if guard > 400 * (total_tasks + 4):
            raise RuntimeError("fabric_sim event-loop guard tripped")
        # ---- start everything startable at time t --------------------------
        for ti, (tn, prog) in enumerate(zip(tenants, progs)):
            if remaining[ti] == 0 or t + _EPS < tn.start:
                continue
            if tn.after is not None and remaining[idx_of[tn.after]] > 0:
                continue  # predecessor still draining (fleet chaining)
            # one pass over the WAITING tasks, in program order: ready
            # pool flows submit (FIFO order within the tenant is enforced
            # by deps, so submission order is free); the serial fast
            # engine takes only the FIRST waiting local task — a blocked
            # first local blocks every later one (in-order engine)
            engine_free = engine_task[ti] is None
            local_seen = False
            still: List[int] = []
            for idx in waiting[ti]:
                task = prog[idx]
                if task.kind == "pool":
                    if not deps_done(ti, task):
                        still.append(idx)
                        continue
                    task.state = "running"
                    task.start = t
                    share = task.lane_share
                    if task.path != "eth":
                        # alternative route: its own lane group, nominal
                        # grant = the PathSpec lanes (max_lanes bursts
                        # the Ethernet pool only)
                        nom = fab.path_named(task.path).lanes
                        maxl = None
                    else:
                        nom = fab.slowest.lanes if fab.depth > 1 else 1.0
                        maxl = tn.max_lanes * share \
                            if tn.max_lanes is not None else None
                    lane = task.lane
                    if lane is not None:
                        # a lane index planned before a shrink may sit
                        # off the end of the degraded pool — re-home it
                        # at submit time like shrink() re-homes live ones
                        lane = int(lane) % max(
                            int(math.ceil(pools[task.path].lanes)), 1)
                    task.flow_id = pools[task.path].submit(LaneRequest(
                        tenant=tn.name, work=task.work, arrive=t,
                        lanes=nom * share, max_lanes=maxl,
                        priority=tn.priority,
                        lane=lane, tag=task.legs[0][0]), t)
                    flows[(task.path, task.flow_id)] = (ti, idx)
                    submit_mem(ti, idx, task, t)
                else:
                    if not local_seen and engine_free \
                            and deps_done(ti, task):
                        task.state = "running"
                        task.start = t
                        task.finish = t + task.dur
                        engine_task[ti] = idx
                        submit_mem(ti, idx, task, t)
                    else:
                        still.append(idx)
                    local_seen = True  # don't skip ahead past it
            waiting[ti] = still
        # ---- done? ---------------------------------------------------------
        if all(r == 0 for r in remaining):
            break
        # ---- next event ----------------------------------------------------
        t_next = math.inf
        for ti, prog in enumerate(progs):
            idx = engine_task[ti]
            if idx is not None and not prog[idx].wire_done:
                t_next = min(t_next, prog[idx].finish)
        for pl in pools.values():
            t_next = min(t_next, pl.earliest_finish(t))
        if mem is not None:
            t_next = min(t_next, mem.earliest_finish(t))
        for tn in tenants:  # tenants not yet started
            if tn.start > t + _EPS:
                t_next = min(t_next, tn.start)
        if fault_i < len(faults):
            # a pending failure is an event source of its own (it can
            # unblock `after` successors or change every grant)
            t_next = min(t_next, max(faults[fault_i].t, t))
        if not math.isfinite(t_next):
            stuck = [(tenants[ti].name, i, task.kind, task.state)
                     for ti, prog in enumerate(progs)
                     for i, task in enumerate(prog) if task.state != "done"]
            raise RuntimeError(f"fabric_sim deadlock at t={t}: {stuck}")
        # ---- advance -------------------------------------------------------
        for pname, pl in pools.items():
            for fid, grant in pl.advance(t, t_next):
                ti, idx = flows.pop((pname, fid))
                task = progs[ti][idx]
                task.wire_done = True
                task.nic_lanes = grant.mean_lanes
                if task.mem_done:
                    complete_pool_task(ti, idx, t_next)
        if mem is not None:
            for mfid, _grant in mem.advance(t, t_next):
                ti, idx = mem_flows.pop(mfid)
                task = progs[ti][idx]
                task.mem_done = True
                if not task.wire_done:
                    continue  # still on the wire / engine
                if task.kind == "pool":
                    complete_pool_task(ti, idx, t_next)
                else:
                    complete_local_task(ti, idx, t_next)
        for ti, prog in enumerate(progs):
            idx = engine_task[ti]
            if idx is not None and not prog[idx].wire_done \
                    and prog[idx].finish <= t_next + _EPS:
                task = prog[idx]
                task.wire_done = True
                if task.mem_done:
                    complete_local_task(ti, idx, min(task.finish, t_next))
                # else: the engine stays blocked until the memory flow
                # drains — compute stretched by memory contention
        # ---- apply failures due at this boundary ---------------------------
        while fault_i < len(faults) and faults[fault_i].t <= t_next + _EPS:
            f = faults[fault_i]
            fault_i += 1
            if f.kind == "lane_down":
                for fid in pools[f.name].shrink(f.lanes, t_next, f.policy):
                    ti, _idx = flows.pop((f.name, fid))
                    kill_tenant(ti, t_next)  # dead pinned lane, policy=fail
            elif f.kind == "device_down":
                mem.drop_device(f.name, t_next)
            else:  # tenant_down
                kill_tenant(idx_of[f.name], t_next)
        t = t_next

    events.sort(key=lambda e: (e.start, e.finish, e.tenant))
    makespan = max(finish.values(), default=0.0)
    result = SimResult(makespan, tuple(events), finish, pool, result_mem,
                       path_pools, tuple(failed_tenants))
    for fn in list(_observers):
        fn(SimObservation(fab, tuple(tenants), cm, result, tuple(faults)))
    return result
