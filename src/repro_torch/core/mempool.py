"""Memory-pool arbiter — bandwidth-contended memory as a first-class resource.

The paper's §4.1 memory pool exists because the NIC pool is only as fast
as the memory behind it: once the CNs drive the consolidated NICs at
their aggregate rate, *local memory bandwidth* becomes the bottleneck
(the C1 "memory wall"), and DFabric fixes it by disaggregating host
memory behind the CXL switch and ADDING memory devices.  Until this
module, memory was invisible to the model: ``repro.core.staging_utils``
maps the pool onto JAX donation/offload idioms, and the cost model's
``mem_bw_limit`` was a single scalar clamp.  This module makes memory a
simulated, priced and planned resource, symmetric to
``repro.core.nicpool``:

  * a :class:`MemDevice` is one memory endpoint — a local DRAM channel
    or a CXL-attached expander — with a sustained bandwidth and an added
    access latency (the knobs the CXL device-interleaving literature
    catalogs);
  * a :class:`MemPoolSpec` is the static description a
    :class:`~repro.core.topology.FabricSpec` carries (``fabric.mem``):
    the device list, the interleaving policy, and the traffic factor
    that converts wire bytes into memory bytes (every received byte is
    DMA'd INTO the pool and read back OUT by the consumer);
  * a :class:`MemPool` is the runtime arbiter: :class:`MemRequest` flows
    (service demand in bytes) are granted time-varying bandwidth by
    weighted max-min fairness across the devices their placement stripes
    over, with per-flow caps and a fixed post-drain latency tail.

Interleaving model
------------------
A flow placed on ``k`` devices stripes its pages UNIFORMLY: it draws the
same per-device share ``s`` from each, so its rate is ``k * s`` and a
lone flow is bounded by ``k * min(device bw)`` — interleaving across a
slow expander drags the whole stripe down to the slowest member, which
is exactly why the planner gets a per-Section *staging* choice (local
DRAM channels only, vs the full interleave set).  The allocator is the
classic bottleneck-device progressive-filling max-min: freeze the flows
bound by their own cap or by the most-contended device, subtract, and
repeat.  It is deliberately NOT work-conserving across devices (the
uniform-stripe constraint pins a flow's per-device draw), which the
audits account for.

The arbiter records an exact piecewise-constant allocation trace
(:attr:`MemPool.segments`) so simulators and tests can audit peak draw
(the paper's ~2.9x compute-phase demand during a burst) and
oversubscription; ``repro.sim.fabric_sim`` co-simulates the pool with
the NIC pool: a slow-tier flow completes only when BOTH its wire work
and its memory work have drained, i.e. its effective rate is
``min(granted lanes, granted memory bandwidth)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_EPS = 1e-12

LOCAL = "local"  # staging placements
POOL = "pool"


# ---------------------------------------------------------------------------
# Devices / static spec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MemDevice:
    """One memory endpoint.

    ``bw`` is the sustained bandwidth (B/s) the device serves; ``latency``
    the added access latency charged once per flow staged on it (a CXL
    expander adds a switch hop; local DRAM is ~0 at this granularity).
    ``kind`` is "dram" (host-local channel) or "cxl" (pooled expander).
    """

    name: str
    bw: float
    latency: float = 0.0
    kind: str = "dram"

    def __post_init__(self):
        if self.bw <= 0:
            raise ValueError(f"device {self.name}: bandwidth must be positive")
        if self.kind not in ("dram", "cxl"):
            raise ValueError(f"device {self.name}: kind must be dram|cxl")


@dataclass(frozen=True)
class MemPoolSpec:
    """Static memory-pool description carried by ``FabricSpec.mem``.

    ``policy`` sets what the "pool" staging placement stripes over:
    ``interleave`` (all devices — the paper's configuration: local
    channels and added expanders serve the pool together) or
    ``expander_only`` (CXL devices only; local DRAM reserved for
    compute).  ``traffic_factor`` converts slow-tier WIRE bytes into
    memory bytes: the default 2.0 charges every wire byte once for the
    NIC-DMA write into the pool and once for the consumer's read out;
    all-reduce style flows that also reduce-in-place can charge 3.0
    (write + reduce-read + forward-read).
    """

    devices: Tuple[MemDevice, ...]
    policy: str = "interleave"
    traffic_factor: float = 2.0

    def __post_init__(self):
        if not self.devices:
            raise ValueError("MemPoolSpec needs at least one device")
        names = [d.name for d in self.devices]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate device names: {names}")
        if self.policy not in ("interleave", "expander_only"):
            raise ValueError(f"unknown policy: {self.policy}")
        if self.traffic_factor <= 0:
            raise ValueError("traffic_factor must be positive")

    # ---- constructors ------------------------------------------------------
    @classmethod
    def build(cls, local_bw: float, local_channels: int = 2,
              device_bw: float = 0.0, devices: int = 0,
              device_latency: float = 2e-6,
              policy: str = "interleave",
              traffic_factor: float = 2.0) -> "MemPoolSpec":
        """``local_bw`` total host-DRAM bandwidth split over
        ``local_channels`` equal channels, plus ``devices`` CXL expanders
        of ``device_bw`` each (the paper's N + M added memory devices)."""
        devs = [MemDevice(f"dram{i}", local_bw / max(local_channels, 1))
                for i in range(max(local_channels, 1))]
        devs += [MemDevice(f"cxl{i}", device_bw, device_latency, kind="cxl")
                 for i in range(devices)]
        return cls(tuple(devs), policy=policy, traffic_factor=traffic_factor)

    # ---- placements --------------------------------------------------------
    @property
    def local_devices(self) -> Tuple[MemDevice, ...]:
        return tuple(d for d in self.devices if d.kind == "dram")

    @property
    def pooled_devices(self) -> Tuple[MemDevice, ...]:
        return tuple(d for d in self.devices if d.kind == "cxl")

    def placement(self, staging: Optional[str]) -> Tuple[int, ...]:
        """Device indices a flow with this staging stripes over.  ``None``
        means "pool".  Degenerate placements fall back to all devices
        (a pool with no DRAM channels / no expanders still serves)."""
        stg = staging or POOL
        if stg == LOCAL:
            ids = tuple(i for i, d in enumerate(self.devices)
                        if d.kind == "dram")
        elif stg == POOL:
            if self.policy == "expander_only":
                ids = tuple(i for i, d in enumerate(self.devices)
                            if d.kind == "cxl")
            else:
                ids = tuple(range(len(self.devices)))
        else:
            raise ValueError(f"unknown staging: {staging!r}")
        return ids or tuple(range(len(self.devices)))

    def deliverable_bw(self, staging: Optional[str] = None) -> float:
        """Bandwidth ONE flow can draw through this staging: uniform
        striping over ``k`` devices is bounded by ``k * min(device bw)``
        (the slowest stripe member paces the page-interleave)."""
        ids = self.placement(staging)
        return len(ids) * min(self.devices[i].bw for i in ids)

    def staging_latency(self, staging: Optional[str] = None) -> float:
        """Added access latency of a staging placement (the slowest
        device in the stripe sets it), charged once per flow."""
        ids = self.placement(staging)
        return max(self.devices[i].latency for i in ids)

    @property
    def total_bw(self) -> float:
        return sum(d.bw for d in self.devices)

    @property
    def local_bw(self) -> float:
        return sum(d.bw for d in self.local_devices)

    def make_pool(self) -> "MemPool":
        return MemPool(self)

    def describe(self) -> str:
        parts = [f"{d.name}@{d.bw/1e9:.1f}GB/s" for d in self.devices]
        return f"mem[{self.policy},x{self.traffic_factor:g}]: " + \
            " + ".join(parts)


# ---------------------------------------------------------------------------
# Requests / grants
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MemRequest:
    """One flow's demand on the pool.

    ``nbytes`` is the service demand in memory bytes (wire bytes already
    multiplied by the spec's traffic factor).  ``cap_bw`` caps the draw
    rate (None = placement's deliverable bandwidth — the flow can never
    outrun its own stripe); ``staging`` picks the device placement.  The
    flow completes ``latency`` seconds after its last byte drains (the
    placement's access-latency tail; None = the spec's
    ``staging_latency``)."""

    tenant: str
    nbytes: float
    arrive: float = 0.0
    cap_bw: Optional[float] = None
    priority: float = 1.0
    staging: Optional[str] = None
    latency: Optional[float] = None
    tag: object = None


@dataclass(frozen=True)
class MemGrant:
    """The arbiter's answer: when the flow ran and what it averaged."""

    request: MemRequest
    start: float
    finish: float

    @property
    def duration(self) -> float:
        return self.finish - self.start

    @property
    def mean_bw(self) -> float:
        return self.request.nbytes / max(self.duration, _EPS)


@dataclass(frozen=True)
class MemSegment:
    """One piecewise-constant allocation interval: flow id -> granted B/s."""

    t0: float
    t1: float
    alloc: Dict[int, float]

    @property
    def total(self) -> float:
        return sum(self.alloc.values())


class _MemFlow:
    __slots__ = ("fid", "req", "remaining", "tail", "cap", "devices", "start")

    def __init__(self, fid: int, req: MemRequest, spec: MemPoolSpec,
                 now: float):
        self.fid = fid
        self.req = req
        self.remaining = float(req.nbytes)
        # bytes are huge numbers: a drained flow's fp residual can be
        # ~1e-10 B, whose drain time underflows below the clock's ulp —
        # so "drained" is judged against a RELATIVE slack everywhere
        # (earliest_finish, advance, completion), never a bare epsilon
        self.tail = float(req.latency if req.latency is not None
                          else spec.staging_latency(req.staging))
        deliver = spec.deliverable_bw(req.staging)
        self.cap = deliver if req.cap_bw is None else min(float(req.cap_bw),
                                                          deliver)
        self.devices = spec.placement(req.staging)
        self.start = now


# ---------------------------------------------------------------------------
# Multi-device weighted max-min (uniform striping)
# ---------------------------------------------------------------------------


def mem_waterfill(flows: Sequence[Tuple[float, float, Tuple[int, ...]]],
                  capacities: Sequence[float]) -> List[float]:
    """Max-min rates for ``flows`` = (priority, cap_bw, device ids) over
    per-device ``capacities``.  A flow striped over ``k`` devices draws an
    EQUAL share ``s`` on each (rate ``k*s``); bottleneck-first progressive
    filling: repeatedly freeze the flows limited by their own cap or by
    the most-contended device, subtract their draw everywhere, repeat."""
    n = len(flows)
    out = [0.0] * n
    rem = [max(float(c), 0.0) for c in capacities]
    active = [i for i in range(n) if flows[i][2]]
    while active:
        levels: Dict[int, float] = {}
        for d in range(len(rem)):
            w = sum(flows[i][0] for i in active if d in flows[i][2])
            if w > _EPS:
                levels[d] = rem[d] / w
        if not levels:
            break
        lvl = min(levels.values())
        # flows whose own per-device cap binds before the bottleneck level
        capped = [i for i in active
                  if flows[i][1] / len(flows[i][2]) <= flows[i][0] * lvl + _EPS]
        if capped:
            freeze = [(i, flows[i][1] / len(flows[i][2])) for i in capped]
        else:
            dstar = min(levels, key=levels.get)
            freeze = [(i, flows[i][0] * lvl) for i in active
                      if dstar in flows[i][2]]
        for i, s in freeze:
            out[i] = s * len(flows[i][2])
            for d in flows[i][2]:
                rem[d] -= s
            active.remove(i)
    return out


# ---------------------------------------------------------------------------
# The arbiter
# ---------------------------------------------------------------------------


class MemPool:
    """Time-shared memory-bandwidth pool (see module docstring).

    Event-driven interface symmetric to :class:`~repro.core.nicpool.NicPool`:
    :meth:`submit` a flow at ``now``, :meth:`earliest_finish` under the
    current allocation, :meth:`advance` the clock collecting completed
    grants; :meth:`run` is the standalone loop for a static request list.
    A flow drains its bytes first, then serves its fixed latency tail —
    so completion is a two-event affair the callers never interpolate.
    """

    def __init__(self, spec: MemPoolSpec):
        self.spec = spec
        self._flows: Dict[int, _MemFlow] = {}
        self._next_id = 0
        self.segments: List[MemSegment] = []
        self.grants: List[MemGrant] = []
        # capacity trace: initial aggregate bw plus one step per drop_device()
        self.capacity_steps: List[Tuple[float, float]] = [(0.0, spec.total_bw)]
        self.dropped_devices: List[Tuple[float, MemDevice]] = []

    @staticmethod
    def _slack(f: _MemFlow) -> float:
        return _EPS * (1.0 + f.req.nbytes)

    # ---- allocation --------------------------------------------------------
    def allocation(self) -> Dict[int, float]:
        """Current grant (B/s) per active flow.  Flows in their latency
        tail hold no bandwidth."""
        entries = [(fid, f) for fid, f in self._flows.items()
                   if f.remaining > self._slack(f)]
        rates = mem_waterfill([(f.req.priority, f.cap, f.devices)
                               for _, f in entries],
                              [d.bw for d in self.spec.devices])
        return {fid: r for (fid, _), r in zip(entries, rates)}

    # ---- event interface ---------------------------------------------------
    def submit(self, req: MemRequest, now: float) -> int:
        if req.nbytes < 0:
            raise ValueError(f"negative demand: {req}")
        if req.priority <= 0:
            raise ValueError(f"priority must be positive: {req}")
        self.spec.placement(req.staging)  # validates the staging name
        fid = self._next_id
        self._next_id += 1
        self._flows[fid] = _MemFlow(fid, req, self.spec, now)
        return fid

    def earliest_finish(self, now: float) -> float:
        """Next completion OR drain->tail transition time under the
        current allocation (inf if idle / no progress)."""
        alloc = self.allocation()
        best = math.inf
        for fid, f in self._flows.items():
            if f.remaining > self._slack(f):
                g = alloc.get(fid, 0.0)
                if g > _EPS:
                    best = min(best, now + f.remaining / g)
            elif f.tail > _EPS:
                best = min(best, now + f.tail)
            else:
                best = min(best, now)
        return best

    def advance(self, now: float, until: float) -> List[Tuple[int, MemGrant]]:
        """Progress all flows from ``now`` to ``until`` at the current
        allocation; returns (flow id, grant) for completed flows.  The
        caller must not advance past :meth:`earliest_finish` plus fp
        slack — completions are detected, not interpolated."""
        if until < now - _EPS:
            raise ValueError(f"time moved backwards: {now} -> {until}")
        dt = max(until - now, 0.0)
        alloc = self.allocation()
        if alloc and dt > 0:
            self.segments.append(MemSegment(now, until, dict(alloc)))
        done: List[Tuple[int, MemGrant]] = []
        for fid in list(self._flows):
            f = self._flows[fid]
            slack = self._slack(f)
            if f.remaining > slack:
                g = alloc.get(fid, 0.0)
                f.remaining -= g * dt
                # a ~1e-7 B residual left by a 100+ GB/s grant can sit
                # above the byte slack while its drain time underflows
                # the clock's ulp at large `until` — earliest_finish then
                # returns `until` itself and dt stays 0 forever (Zeno
                # livelock); cut such a residual to the latency tail
                if f.remaining > slack and g > _EPS \
                        and until + f.remaining / g <= until:
                    f.remaining = 0.0
            else:
                f.tail -= dt
            # thresholds must match earliest_finish's: anything that
            # method reports as finishing "now" completes here
            if f.remaining <= slack and f.tail <= _EPS:
                grant = MemGrant(f.req, f.start, until)
                self.grants.append(grant)
                done.append((fid, grant))
                del self._flows[fid]
        return done

    @property
    def active(self) -> int:
        return len(self._flows)

    # ---- failure / re-grant semantics --------------------------------------
    def drop_device(self, name: str, now: float = 0.0) -> None:
        """Remove device ``name`` from the pool at ``now`` (an expander
        dies).  Every surviving flow is RE-STRIPED against the reduced
        spec: its placement, rate cap and per-device draw are recomputed
        exactly as at submit time (placements are index tuples into
        ``spec.devices``, so they are re-mapped, not filtered).
        Remaining bytes and the latency tail already assigned are
        conserved.  The capacity step is appended to
        :attr:`capacity_steps` so traces/audits can render and classify
        the degraded interval."""
        devs = tuple(d for d in self.spec.devices if d.name != name)
        if len(devs) == len(self.spec.devices):
            raise KeyError(
                f"no device named {name!r} in "
                f"{[d.name for d in self.spec.devices]}")
        if not devs:
            raise ValueError("cannot drop the last memory device")
        dead = next(d for d in self.spec.devices if d.name == name)
        self.spec = replace(self.spec, devices=devs)
        self.dropped_devices.append((float(now), dead))
        self.capacity_steps.append((float(now), self.spec.total_bw))
        for f in self._flows.values():
            f.devices = self.spec.placement(f.req.staging)
            deliver = self.spec.deliverable_bw(f.req.staging)
            f.cap = deliver if f.req.cap_bw is None \
                else min(float(f.req.cap_bw), deliver)

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
    def run(self, requests: Iterable[MemRequest]) -> List[MemGrant]:
        """Simulate a static request list to completion; grants in
        completion order."""
        if self._flows:
            raise RuntimeError("pool has active flows; use a fresh pool")
        pending = sorted(requests, key=lambda r: r.arrive)
        t = pending[0].arrive if pending else 0.0
        order: List[MemGrant] = []
        while pending or self._flows:
            if not self._flows and pending:
                t = max(t, pending[0].arrive)
            while pending and pending[0].arrive <= t + _EPS:
                self.submit(pending.pop(0), t)
            nxt_arrival = pending[0].arrive if pending else math.inf
            t_next = min(nxt_arrival, self.earliest_finish(t))
            if not math.isfinite(t_next):
                raise RuntimeError("mem pool deadlock: active flows, "
                                   "no progress")
            order.extend(g for _, g in self.advance(t, t_next))
            t = t_next
        return order

    # ---- audits ------------------------------------------------------------
    def peak_bw(self) -> float:
        """Max total granted bandwidth over the recorded trace — the
        paper's "memory pool demand" during a burst."""
        return max((s.total for s in self.segments), default=0.0)

    def busy_bytes(self) -> float:
        return sum(s.total * (s.t1 - s.t0) for s in self.segments)

    def counter_series(self) -> List[Tuple[float, float]]:
        """The recorded draw trace as piecewise-constant breakpoints
        ``(t, total granted B/s)`` — zeros at gaps and after the last
        segment, consecutive equal values merged; the series' max is
        exactly :meth:`peak_bw` (the Perfetto counter-track form)."""
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
