"""NIC-pool arbiter — dynamic lane time-sharing over the slowest tier.

The paper's core §4.2 claim is that consolidating the CNs' NICs into a
CXL-attached *pool* lets one CN's communication burst use the WHOLE pool
while its peers compute.  Until this module, the pool was a static
``Tier.lanes`` multiplier: every consumer priced the slow leg at
``bw * lanes`` regardless of *when* concurrent flows hit the wire.  The
arbiter makes the knob real: flows request lanes over time and are granted
a time-varying share.

Model
-----
A :class:`NicPool` owns ``lanes`` units of slow-tier capacity (per-chip
NIC lanes, the same unit as ``Tier.lanes``; a θ-CN rack pool is
``θ * Tier.lanes``).  A flow is a :class:`LaneRequest` carrying its
service demand in **lane-seconds** (``work``): a flow granted ``g`` lanes
progresses at ``g`` lane-seconds per second, so a slow leg priced at
``t`` seconds on its nominal ``lanes`` carries ``work = t * lanes`` and
finishes in ``t`` exactly when granted its nominal share.

Two allocation modes coexist:

  * **fluid** (``lane=None``, the paper's LPPU data plane): all fluid
    flows share the pool by weighted max-min fairness (water-filling with
    per-flow caps) — work-conserving, so a lone burster with
    ``max_lanes = pool.lanes`` gets the whole pool (the θ× exclusive-burst
    speedup of Fig. 13);
  * **pinned** (``lane=k``, the static-executor constraint): the flow is
    pinned to lane ``k`` and shares only that lane — what an XLA program
    whose sub-flow → lane mapping is fixed at trace time actually gets.
    The planner staggers concurrent Sections' sub-flow phases
    (``CommSchedule.lane_offset``) precisely so pinned flows of different
    Sections land on different lanes at any instant.

The arbiter records an exact piecewise-constant allocation trace
(:attr:`NicPool.segments`) so simulators and tests can audit work
conservation and oversubscription; ``repro.sim.fabric_sim`` drives the
pool as a co-simulated resource via ``submit`` / ``earliest_finish`` /
``advance``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Requests / grants
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LaneRequest:
    """One flow's demand on the pool.

    ``work`` is the service demand in lane-seconds.  ``lanes`` is the
    nominal (planned steady-state) share — the ``Tier.lanes`` the cost
    model priced the leg at; ``max_lanes`` caps the opportunistic grant
    (None = nominal, i.e. the flow never bursts beyond its plan;
    ``pool.lanes`` = fully opportunistic).  ``lane`` pins the flow to one
    lane (static assignment); None = fluid arbitration.
    """

    tenant: str
    work: float
    arrive: float = 0.0
    lanes: float = 1.0
    max_lanes: Optional[float] = None
    priority: float = 1.0
    lane: Optional[int] = None
    tag: object = None

    @property
    def cap(self) -> float:
        c = self.lanes if self.max_lanes is None else self.max_lanes
        return max(float(c), _EPS)


@dataclass(frozen=True)
class LaneGrant:
    """The arbiter's answer: when the flow ran and what it averaged."""

    request: LaneRequest
    start: float
    finish: float

    @property
    def duration(self) -> float:
        return self.finish - self.start

    @property
    def mean_lanes(self) -> float:
        return self.request.work / max(self.duration, _EPS)


@dataclass(frozen=True)
class PoolSegment:
    """One piecewise-constant allocation interval: flow id -> granted lanes."""

    t0: float
    t1: float
    alloc: Dict[int, float]

    @property
    def total(self) -> float:
        return sum(self.alloc.values())


class _Flow:
    __slots__ = ("fid", "req", "remaining", "start")

    def __init__(self, fid: int, req: LaneRequest, now: float):
        self.fid = fid
        self.req = req
        self.remaining = float(req.work)
        self.start = now


# ---------------------------------------------------------------------------
# Weighted max-min water-filling
# ---------------------------------------------------------------------------


def waterfill(demands: Sequence[Tuple[float, float]], capacity: float
              ) -> List[float]:
    """Weighted max-min shares: ``demands`` is a list of (priority, cap)
    pairs; returns the granted amount per entry.  Work-conserving:
    ``sum(out) == min(capacity, sum(caps))`` (up to fp eps)."""
    n = len(demands)
    out = [0.0] * n
    active = list(range(n))
    rem = max(float(capacity), 0.0)
    while active and rem > _EPS:
        wsum = sum(demands[i][0] for i in active)
        if wsum <= _EPS:
            break
        fair = rem / wsum
        capped = [i for i in active if demands[i][1] <= demands[i][0] * fair + _EPS]
        if not capped:
            for i in active:
                out[i] = demands[i][0] * fair
            return out
        for i in capped:
            out[i] = demands[i][1]
            rem -= demands[i][1]
            active.remove(i)
    return out


# ---------------------------------------------------------------------------
# The arbiter
# ---------------------------------------------------------------------------


class NicPool:
    """Time-shared slow-tier lane pool (see module docstring).

    Event-driven interface for co-simulation:
      * :meth:`submit` a flow at time ``now``,
      * :meth:`earliest_finish` under the current allocation,
      * :meth:`advance` the clock, collecting completed grants.

    :meth:`run` is the standalone convenience loop for a static request
    list (the arbiter-battery entry point).
    """

    def __init__(self, lanes: float):
        if lanes <= 0:
            raise ValueError(f"pool needs positive lane capacity, got {lanes}")
        self.lanes = float(lanes)
        self._flows: Dict[int, _Flow] = {}
        self._next_id = 0
        self.segments: List[PoolSegment] = []
        self.grants: List[LaneGrant] = []
        # capacity trace: the initial capacity plus one step per shrink()
        self.capacity_steps: List[Tuple[float, float]] = [(0.0, self.lanes)]
        self.failed: List[LaneRequest] = []

    # ---- constructors ------------------------------------------------------
    @classmethod
    def from_fabric(cls, fabric, tenants: int = 1) -> "NicPool":
        """A pool aggregating ``tenants`` members' nominal slow-tier lanes
        (a θ-CN rack: each CN contributes its ``Tier.lanes``)."""
        from repro_torch.core.topology import as_fabric
        fab = as_fabric(fabric)
        per = fab.slowest.lanes if fab.depth > 1 else 1.0
        return cls(lanes=per * max(int(tenants), 1))

    @classmethod
    def for_path(cls, fabric, path: str, tenants: int = 1) -> "NicPool":
        """The SECOND lane group of a multi-path fabric: a pool arbitrating
        one alternative slow-leg route (``PathSpec.lanes`` per tenant — a
        route the fabric does not declare falls back to the Ethernet
        lanes, mirroring how pricing degrades undeclared routes)."""
        from repro_torch.core.topology import as_fabric
        fab = as_fabric(fabric)
        spec = fab.path_named(path)
        if spec is not None:
            per = spec.lanes
        else:
            per = fab.slowest.lanes if fab.depth > 1 else 1.0
        return cls(lanes=per * max(int(tenants), 1))

    # ---- planner hook ------------------------------------------------------
    def stagger(self, schedules: Sequence) -> List[int]:
        """Sub-flow phase offsets for concurrent Sections.

        Round-robin over the pool: the k-th schedule with ``C > 1`` slow
        sub-flows gets ``lane_offset = k mod C``, so concurrent Sections
        issue DIFFERENT sub-flow indices first and their pinned lanes
        interleave instead of colliding (``CommSchedule.with_lane_offset``
        rotates the issue order; chunk *i* rides lane ``i mod lanes``)."""
        offs: List[int] = []
        cursor = 0
        for s in schedules:
            chunks = 0 if s is None else len(s.slow_legs)
            if chunks <= 1:
                offs.append(0)
            else:
                offs.append(cursor % chunks)
                cursor += 1
        return offs

    def fair_share(self, n_active: int) -> float:
        """The steady-state grant when ``n_active`` uncapped equal-priority
        flows contend — the contention-aware cost model's lane count."""
        return self.lanes / max(int(n_active), 1)

    # ---- allocation --------------------------------------------------------
    def allocation(self) -> Dict[int, float]:
        """Current grant per active flow: pinned flows split their lane
        (capacity 1.0 each, weighted, capped); fluid flows water-fill the
        remaining pool capacity.  Work-conserving: pinned slack returns to
        the fluid pool."""
        alloc: Dict[int, float] = {}
        pinned: Dict[int, List[_Flow]] = {}
        fluid: List[_Flow] = []
        for f in self._flows.values():
            if f.req.lane is None:
                fluid.append(f)
            else:
                pinned.setdefault(int(f.req.lane), []).append(f)
        used = 0.0
        for lane, fl in pinned.items():
            # a lane holds at most 1.0 — and the LAST lane of a
            # fractional pool holds only the fraction (lanes=2.5: lane 2
            # has 0.5 capacity), so pinned grants never oversubscribe
            lane_cap = max(0.0, min(1.0, self.lanes - lane))
            shares = waterfill([(f.req.priority, min(f.req.cap, lane_cap))
                                for f in fl], lane_cap)
            for f, s in zip(fl, shares):
                alloc[f.fid] = s
                used += s
        if fluid:
            rem = max(self.lanes - used, 0.0)
            shares = waterfill([(f.req.priority, f.req.cap) for f in fluid],
                               rem)
            for f, s in zip(fluid, shares):
                alloc[f.fid] = s
        return alloc

    # ---- event interface ---------------------------------------------------
    def submit(self, req: LaneRequest, now: float) -> int:
        if req.work < 0:
            raise ValueError(f"negative work: {req}")
        if req.priority <= 0:
            # a zero-weight flow would be granted nothing forever and
            # surface later as an opaque pool deadlock
            raise ValueError(f"priority must be positive: {req}")
        if req.lane is not None and not (0 <= int(req.lane) < math.ceil(self.lanes)):
            raise ValueError(f"lane {req.lane} outside pool of {self.lanes}")
        fid = self._next_id
        self._next_id += 1
        self._flows[fid] = _Flow(fid, req, now)
        return fid

    def earliest_finish(self, now: float) -> float:
        """Next completion time under the current allocation (inf if the
        pool is idle or no active flow makes progress)."""
        alloc = self.allocation()
        best = math.inf
        for fid, f in self._flows.items():
            g = alloc.get(fid, 0.0)
            if f.remaining <= _EPS:
                best = min(best, now)
            elif g > _EPS:
                best = min(best, now + f.remaining / g)
        return best

    def advance(self, now: float, until: float) -> List[Tuple[int, LaneGrant]]:
        """Progress all flows from ``now`` to ``until`` at the current
        allocation; returns (flow id, grant) for flows that completed.
        The caller must not advance past :meth:`earliest_finish` plus fp
        slack — completions are detected, not interpolated."""
        if until < now - _EPS:
            raise ValueError(f"time moved backwards: {now} -> {until}")
        dt = max(until - now, 0.0)
        alloc = self.allocation()
        if self._flows and dt > 0:
            self.segments.append(PoolSegment(now, until, dict(alloc)))
        done: List[Tuple[int, LaneGrant]] = []
        for fid in list(self._flows):
            f = self._flows[fid]
            g = alloc.get(fid, 0.0)
            f.remaining -= g * dt
            slack = _EPS * (1.0 + f.req.work)
            # a residual above the slack whose drain time underflows the
            # clock's ulp at large `until` can never be drained by a
            # finite advance (earliest_finish returns `until` itself and
            # dt stays 0 forever — a Zeno livelock); judge it done
            if f.remaining > slack and g > _EPS \
                    and until + f.remaining / g <= until:
                f.remaining = 0.0
            if f.remaining <= slack:
                grant = LaneGrant(f.req, f.start, until)
                self.grants.append(grant)
                done.append((fid, grant))
                del self._flows[fid]
        return done

    @property
    def active(self) -> int:
        return len(self._flows)

    # ---- failure / re-grant semantics --------------------------------------
    def shrink(self, lanes: float, now: float = 0.0,
               policy: str = "rehome") -> List[int]:
        """Remove ``lanes`` lanes of capacity at ``now`` — the
        highest-indexed lanes die (a failed NIC drops off the top of the
        pool).  Re-grant semantics:

          * **fluid** flows simply re-waterfill against the reduced
            capacity at the next event boundary (:meth:`allocation`
            reads ``self.lanes`` fresh every call);
          * completed work is conserved — each survivor's ``remaining``
            is untouched and already-recorded segments keep their old
            grants;
          * **pinned** flows whose lane died follow ``policy``:
            ``"rehome"`` moves lane ``k`` to ``k mod ceil(new)``,
            ``"fail"`` drops the flow (its request is recorded in
            :attr:`failed`, its id returned so the caller can fail the
            owning tenant).

        The capacity step is appended to :attr:`capacity_steps` so
        ``obs.trace`` / ``obs.audit`` can render and classify the
        degraded interval.
        """
        if policy not in ("rehome", "fail"):
            raise ValueError(f"unknown dead-lane policy: {policy!r}")
        if lanes <= 0:
            raise ValueError(f"must shrink by a positive lane count: {lanes}")
        new = self.lanes - float(lanes)
        if new <= 0:
            raise ValueError(
                f"cannot shrink a {self.lanes}-lane pool by {lanes}: "
                "at least one lane must survive")
        self.lanes = new
        self.capacity_steps.append((float(now), new))
        ncap = max(int(math.ceil(new)), 1)
        dropped: List[int] = []
        for fid, f in list(self._flows.items()):
            lane = f.req.lane
            if lane is None or lane < new:
                continue  # fluid, or its lane still has capacity
            if policy == "rehome":
                f.req = replace(f.req, lane=int(lane) % ncap)
            else:
                self.failed.append(f.req)
                dropped.append(fid)
                del self._flows[fid]
        return dropped

    def cancel(self, fid: int) -> None:
        """Withdraw an active flow without recording a grant (its tenant
        departed mid-run).  Unknown / completed ids are ignored."""
        self._flows.pop(fid, None)

    def degraded_since(self) -> Optional[float]:
        """Time of the first capacity loss (None = never degraded)."""
        if len(self.capacity_steps) > 1:
            return self.capacity_steps[1][0]
        return None

    # ---- standalone loop ---------------------------------------------------
    def run(self, requests: Iterable[LaneRequest]) -> List[LaneGrant]:
        """Simulate a static request list to completion; returns grants in
        completion order.  FIFO-fair under equal priority: of two
        equal-demand equal-priority flows, the earlier arrival never
        finishes later (processor sharing preserves arrival-order
        progress)."""
        if self._flows:
            raise RuntimeError("pool has active flows; use a fresh pool")
        pending = sorted(requests, key=lambda r: r.arrive)
        t = pending[0].arrive if pending else 0.0
        order: List[LaneGrant] = []
        while pending or self._flows:
            if not self._flows and pending:
                t = max(t, pending[0].arrive)
            while pending and pending[0].arrive <= t + _EPS:
                self.submit(pending.pop(0), t)
            nxt_arrival = pending[0].arrive if pending else math.inf
            nxt_finish = self.earliest_finish(t)
            t_next = min(nxt_arrival, nxt_finish)
            if not math.isfinite(t_next):
                raise RuntimeError("pool deadlock: active flows, no progress")
            order.extend(g for _, g in self.advance(t, t_next))
            t = t_next
        return order

    # ---- audits ------------------------------------------------------------
    def peak_lanes(self) -> float:
        """Max total granted lanes over the recorded trace."""
        return max((s.total for s in self.segments), default=0.0)

    def busy_lane_seconds(self) -> float:
        return sum(s.total * (s.t1 - s.t0) for s in self.segments)

    def counter_series(self) -> List[Tuple[float, float]]:
        """The recorded allocation trace as piecewise-constant breakpoints
        ``(t, total granted lanes)`` — zeros emitted at gaps and after the
        last segment, consecutive equal values merged.  The series' max is
        exactly :meth:`peak_lanes` (the Perfetto counter-track form)."""
        pts: List[Tuple[float, float]] = []

        def emit(t: float, v: float) -> None:
            if pts and pts[-1][1] == v:
                return
            pts.append((t, v))

        prev: Optional[float] = None
        for seg in self.segments:
            if prev is not None and seg.t0 > prev:
                emit(prev, 0.0)
            emit(seg.t0, seg.total)
            prev = seg.t1
        if prev is not None:
            emit(prev, 0.0)
        return pts
