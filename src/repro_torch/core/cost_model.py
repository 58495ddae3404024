"""Analytic communication cost model for the DFabric fabric (N tiers).

This is the LPPU's "brain": closed-form completion-time estimates for each
collective strategy, used (a) by the planner to pick a strategy per gradient
bucket, (b) by the benchmarks to reproduce the paper's Figures 2, 9, 10 and
12, and (c) in the roofline analysis to attribute collective bytes to tiers.

All formulas are standard alpha-beta (latency-bandwidth) models:
  ring all-reduce over n members:  t = 2 (n-1)/n * B / bw + 2 (n-1) * lat
with DFabric's striping changing *which* bandwidth the cross-pod leg sees.

Two API levels:

  * the original two-tier methods (``flat_ring`` / ``hierarchical`` /
    ``optimal`` / ...), unchanged for existing call sites and paper-figure
    reproduction;
  * the general N-tier path (``ntier_striped`` / ``ntier_best``), which
    charges EVERY tier of a :class:`FabricSpec` independently and returns a
    per-tier breakdown.  A ``CostModel`` may be constructed from either a
    ``TwoTierTopology`` or a ``FabricSpec`` — the legacy methods see the
    collapsed two-tier view (``FabricSpec.as_two_tier``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import schedule as sched
from repro_torch.core.topology import FabricSpec, Tier, TwoTierTopology, as_fabric

# dtypes numpy cannot parse (jax extension types)
_ITEMSIZE = {"bfloat16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1,
             "float8_e4m3": 1, "float8_e5m2fnuz": 1, "float8_e4m3fnuz": 1}


def dtype_itemsize(dtype: str) -> int:
    try:
        return np.dtype(str(dtype)).itemsize
    except TypeError:
        return _ITEMSIZE.get(str(dtype), 4)


def codec_ratio(codec: Optional[str], cfg: "sched.SyncConfig") -> float:
    """Approximate wire-byte compression ratio of a codec (fp32 payload):
    int8 = 1 byte/elem (+block scales) ~ 4x; top-k sends (value, index)
    pairs for the kept fraction ~ 0.5/k_frac."""
    if codec == "int8":
        return 4.0
    if codec == "topk":
        return max(0.5 / max(cfg.codec_k_frac, 1e-9), 1.0)
    return 1.0


def ring_all_reduce_time(nbytes: float, n: int, bw: float, lat: float) -> float:
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * nbytes / bw + 2.0 * (n - 1) * lat


def ring_reduce_scatter_time(nbytes: float, n: int, bw: float, lat: float) -> float:
    if n <= 1:
        return 0.0
    return (n - 1) / n * nbytes / bw + (n - 1) * lat


def all_gather_time(nbytes: float, n: int, bw: float, lat: float) -> float:
    # gathering n shards that total nbytes
    if n <= 1:
        return 0.0
    return (n - 1) / n * nbytes / bw + (n - 1) * lat


def all_to_all_time(nbytes: float, n: int, bw: float, lat: float) -> float:
    if n <= 1:
        return 0.0
    return (n - 1) / n * nbytes / bw + (n - 1) * lat


@dataclass(frozen=True)
class CollectiveEstimate:
    strategy: str
    total_s: float
    ici_s: float
    dcn_s: float
    dcn_bytes_per_chip: float
    ici_bytes_per_chip: float
    notes: str = ""


@dataclass(frozen=True)
class TierCharge:
    """Time/bytes one tier contributes to an N-tier collective."""

    tier: str  # Tier.name
    axis: str
    seconds: float
    bytes_per_chip: float
    scattered: bool  # was this (fast) tier reduce-scattered or psum'ed?


@dataclass(frozen=True)
class NTierEstimate:
    strategy: str
    total_s: float
    charges: Tuple[TierCharge, ...]
    scatter_depth: int
    notes: str = ""

    @property
    def slow_s(self) -> float:
        return self.charges[-1].seconds if self.charges else 0.0

    @property
    def fast_s(self) -> float:
        return sum(c.seconds for c in self.charges[:-1])

    @property
    def slow_bytes_per_chip(self) -> float:
        return self.charges[-1].bytes_per_chip if self.charges else 0.0

    def tier_seconds(self) -> Dict[str, float]:
        return {c.tier: c.seconds for c in self.charges}


@dataclass(frozen=True)
class LegCharge:
    """Time/bytes one schedule leg contributes — the pricing twin of the
    executor's lowering of that same leg."""

    leg: object  # the CommSchedule leg priced (ReduceScatter/Psum/...)
    seconds: float
    bytes_per_chip: float


@dataclass(frozen=True)
class PredictedLeg:
    """One leg's predicted busy interval in the estimate's own timeline
    (t=0 at collective start) — the price rendered as a schedule, so a
    predicted track can sit next to the simulator's replay."""

    leg: object
    start: float
    finish: float
    path: str = ""  # slow legs: effective route; fast/local legs: ""
    chunk: int = -1


@dataclass(frozen=True)
class ScheduleEstimate:
    """Price of one :class:`~repro.core.schedule.CommSchedule`: per-leg
    charges (``leg_charges[i].leg is schedule.legs[i]``), per-tier
    aggregates, and the pipelined-overlap total.

    ``path_seconds`` is the per-route breakdown of the slow leg (the sum
    of each route's sub-flow charges, routes in first-issue order).  With
    more than one route the routes drain CONCURRENTLY, so the total
    charges the slowest route (``max``), not the sum — the per-tier
    ``charges`` keep the arithmetic sum (busy-seconds accounting), which
    can then exceed the wall-clock contribution, exactly like the
    pipelined overlap credit already does."""

    strategy: str
    total_s: float
    charges: Tuple[TierCharge, ...]
    leg_charges: Tuple[LegCharge, ...]
    scatter_depth: int
    chunks: int = 1
    pipelined: bool = False
    notes: str = ""
    path_seconds: Tuple[Tuple[str, float], ...] = ()

    @property
    def slow_s(self) -> float:
        return self.charges[-1].seconds if self.charges else 0.0

    @property
    def slow_effective_s(self) -> float:
        """Wall-clock slow-leg time: max over concurrent routes (equals
        ``slow_s`` for single-route schedules)."""
        if not self.path_seconds:
            return self.slow_s
        return max(s for _, s in self.path_seconds)

    @property
    def fast_s(self) -> float:
        return sum(c.seconds for c in self.charges[:-1])

    @property
    def slow_bytes_per_chip(self) -> float:
        return self.charges[-1].bytes_per_chip if self.charges else 0.0

    def tier_seconds(self) -> Dict[str, float]:
        return {c.tier: c.seconds for c in self.charges}

    def leg_timeline(self) -> Tuple[PredictedLeg, ...]:
        """The estimate unrolled into predicted per-leg intervals — the
        exact timeline :mod:`repro.sim.fabric_sim` replays for ONE
        uncontended tenant of this schedule (same per-route chaining,
        same two-stage pipeline), so the last finish equals ``total_s``
        (up to the multipath memory-pool serialization floor, which is a
        pool-level bound with no per-leg attribution).

        Sequential: legs chain in order; within a contiguous slow group
        the sub-flows chain PER ROUTE (routes drain concurrently) and
        whatever follows waits on every route's tail.  Pipelined: fast
        stages of ``fast_s / chunks`` chain on the engine, slow sub-flow
        *j* starts at ``max(stage_j finish, its route's previous
        sub-flow)`` — the recurrence ``from_schedule`` prices."""
        if not self.leg_charges:
            return ()
        slow_tier = self.charges[-1].tier if self.charges else None
        slow_axis = self.charges[-1].axis if self.charges else None
        routes = {p for p, _ in self.path_seconds} | {"eth"}

        def is_pool(leg) -> bool:
            # mirror of fabric_sim._is_pool_leg, driven by the charges'
            # own slow tier (the cost model always aggregates it last);
            # single-tier estimates degrade to a plain chain either way
            return len(self.charges) > 1 and (
                getattr(leg, "tier", None) in (slow_tier, slow_axis)
                or getattr(leg, "axis", None) == slow_axis)

        def eff_path(leg) -> str:
            p = getattr(leg, "path", "eth")
            return p if p in routes else "eth"

        out: List[PredictedLeg] = []
        slow = [lc for lc in self.leg_charges if is_pool(lc.leg)]
        if self.pipelined and self.chunks > 1 and slow:
            fast = [lc for lc in self.leg_charges if not is_pool(lc.leg)]
            C = len(slow)
            fast_total = sum(lc.seconds for lc in fast)
            F = 0.0
            tails: Dict[str, float] = {}
            for slc in slow:
                stage0, stage1 = F, F + fast_total / C
                t0 = stage0
                for lc in fast:  # per-chunk fast attribution, as replayed
                    frac = lc.seconds / fast_total if fast_total > 0 \
                        else 1.0 / len(fast)
                    t1 = min(t0 + (stage1 - stage0) * frac, stage1)
                    out.append(PredictedLeg(lc.leg, t0, t1, "",
                                            getattr(slc.leg, "index", -1)))
                    t0 = t1
                F = stage1
                p = eff_path(slc.leg)
                s0 = max(F, tails.get(p, 0.0))
                tails[p] = s0 + slc.seconds
                out.append(PredictedLeg(slc.leg, s0, tails[p], p,
                                        getattr(slc.leg, "index", -1)))
            return tuple(out)
        t = 0.0
        entry: Optional[float] = None
        tails = {}
        for lc in self.leg_charges:
            if is_pool(lc.leg):
                if entry is None:
                    entry, tails = t, {}
                p = eff_path(lc.leg)
                s0 = tails.get(p, entry)
                tails[p] = s0 + lc.seconds
                out.append(PredictedLeg(lc.leg, s0, tails[p], p,
                                        getattr(lc.leg, "index", -1)))
                t = max(tails.values())
            else:
                entry = None
                out.append(PredictedLeg(lc.leg, t, t + lc.seconds))
                t += lc.seconds
        return tuple(out)


class CostModel:
    """Completion-time estimates for an all-reduce of ``nbytes`` (global
    gradient size) over the DP domain of a :class:`TwoTierTopology` or an
    N-tier :class:`FabricSpec`."""

    def __init__(self, topo: Union[TwoTierTopology, FabricSpec]):
        self.fabric = as_fabric(topo)
        # legacy two-tier methods operate on the collapsed view
        self.topo = topo if isinstance(topo, TwoTierTopology) \
            else self.fabric.as_two_tier()

    # ---- effective tier rates ----------------------------------------------
    def _dcn_rate_per_chip(self, mem_bw_limit: Optional[float] = None, cached: bool = True) -> float:
        """Per-chip cross-pod rate, including the paper's C1 (memory wall)
        and C2 (no DRAM cache => synchronous far loads, ~2.1x degradation)."""
        hw = self.topo.hw
        rate = hw.dcn_bw * self.topo.dcn_lanes
        if mem_bw_limit is not None:
            # NIC pool DMA throttled by host memory channels (paper C1):
            # the pool's aggregate rate cannot exceed the memory bw.
            rate = min(rate, mem_bw_limit / self.topo.chips_per_pod)
        if not cached:
            # paper Table 4 / Fig 2: without the DRAM cache, synchronous
            # CXL.mem loads degrade throughput to ~1/2.1 (measured 2.1x
            # slowdown when data lives in far memory).
            rate = rate / 2.1
        return rate

    # ---- memory-pool pricing helpers ----------------------------------------
    def _mem_model(self, mem):
        """Normalize a ``mem`` argument (MemPoolSpec | MemPool | True for
        the fabric's own spec | None) to a MemPoolSpec or None."""
        if mem is None or mem is False:
            return None
        if mem is True:
            return self.fabric.mem
        spec = getattr(mem, "spec", mem)
        return spec

    def _mem_leg_seconds(self, wire_bytes: float, tier: Tier,
                         granted_lanes: float, spec, staging: Optional[str],
                         granted_mem_bw: Optional[float]) -> float:
        """Seconds the MEMORY side of one slow-tier leg needs: the leg's
        wire bytes hit the pool ``traffic_factor`` times (NIC-DMA write in
        + consumer read out), aggregated over the slow-tier group, drawn
        at min(pool grant, the flow's own max draw at its granted lanes),
        plus the staging placement's access-latency tail.  This is exactly
        the memory flow ``repro.sim.fabric_sim`` submits, so a slow leg
        priced ``max(wire, memory)`` matches the co-simulated completion
        (both flows drain in parallel; the task finishes when both do)."""
        grp = max(self.fabric.n_fast, 1)
        pool_bw = granted_mem_bw if granted_mem_bw is not None \
            else spec.deliverable_bw(staging)
        cap = spec.traffic_factor * grp * tier.bw * max(granted_lanes, 1e-30)
        eff = max(min(pool_bw, cap), 1e-30)
        return (spec.traffic_factor * grp * wire_bytes / eff
                + spec.staging_latency(staging))

    def _mem_leg_seconds_skewed(self, dest_bytes: Sequence[float],
                                tier: Tier, granted_lanes: float, spec,
                                staging: Optional[str],
                                granted_mem_bw: Optional[float]) -> float:
        """Skewed twin of :meth:`_mem_leg_seconds`: a skewed slow leg's
        memory traffic is its (n-1) per-destination flows at their TRUE
        bytes (``dest_bytes``, hottest row included once — NOT the
        incast bound, which is a wire-receiver property), each capped at
        an equal share of the leg's wire draw, all sharing the pool by
        max-min — exactly the flow set ``repro.sim.fabric_sim`` submits.
        Equal caps and equal priorities reduce the waterfill to a
        progressive fill: every active flow drains at the same rate, so
        flows complete smallest-first and the pool share rises (up to
        the cap) as they do."""
        grp = max(self.fabric.n_fast, 1)
        tf = spec.traffic_factor
        pool_bw = granted_mem_bw if granted_mem_bw is not None \
            else spec.deliverable_bw(staging)
        ndest = max(len(dest_bytes), 1)
        cap = tf * grp * tier.bw * max(granted_lanes, 1e-30) / ndest
        rem = sorted(tf * grp * float(b) for b in dest_bytes if b > 0)
        t = 0.0
        while rem:
            share = max(min(pool_bw / len(rem), cap), 1e-30)
            dt = rem[0] / share
            t += dt
            drained = share * dt
            rem = [b - drained for b in rem[1:]]
        return t + spec.staging_latency(staging)

    # ---- schedule pricing ---------------------------------------------------
    def from_schedule(self, schedule: "sched.CommSchedule", *,
                      mem_bw_limit: Optional[float] = None,
                      cached: bool = True,
                      granted_lanes: Union[float, Mapping[str, float],
                                           None] = None,
                      mem=None, staging: Optional[str] = None,
                      granted_mem_bw: Optional[float] = None) -> ScheduleEstimate:
        """Price EXACTLY the legs the executor will lower — walk the same
        :class:`~repro.core.schedule.CommSchedule` leg list, charging each
        leg its alpha-beta time on its tier (this retires the drift
        between ``ntier_striped`` and the executed recursion: divisibility
        skips, chunk clamping and per-tier codecs are already resolved in
        the schedule).

        Pipelined schedules get the overlap credit
        ``max(slow, fast) + min(per-chunk slow, per-chunk fast)``.

        ``granted_lanes`` is the contention-aware mode: slow legs are
        charged at the NIC-pool lanes the arbiter actually GRANTS this
        flow (e.g. ``NicPool.fair_share(tenants)``) instead of the tier's
        nominal ``lanes`` — the whole per-leg charge scales by
        ``nominal / granted``, matching ``repro.sim.fabric_sim``'s
        lane-second flow model (at ``granted == nominal`` the estimate is
        unchanged, and a single uncontended tenant's simulated makespan
        equals ``total_s``).  A scalar applies to every route; a mapping
        ``{path: granted}`` sets each route's grant independently (routes
        absent from the mapping stay uncontended — each declared path is
        its own lane group, so contention is per path).

        Multi-path slow legs (``SlowChunk.path != "eth"``): each sub-flow
        is priced at ITS route's bw/latency/lanes
        (``FabricSpec.path_tier`` — an undeclared route degrades to the
        Ethernet tier, keeping plans portable), the routes drain
        concurrently, and the slow leg's wall-clock contribution is the
        ``max`` over per-route sums (sequential) or the exact pipeline
        recurrence the simulator replays (pipelined, see below) — the
        single-route totals are bitwise what they always were.

        ``mem`` is the memory-aware mode (the paper's §4.1 pillar): a
        :class:`~repro.core.mempool.MemPoolSpec` (or ``MemPool``, or
        ``True`` for the fabric's own ``mem``).  Every slow-tier leg is
        then charged ``max(wire seconds, memory seconds)`` — its wire
        bytes hit the pool ``traffic_factor`` times (NIC-DMA in, consume
        out) and drain at the staging placement's deliverable bandwidth
        (see :meth:`_mem_leg_seconds`), so the leg's effective rate is
        ``min(granted lanes, granted memory bandwidth)``.  ``staging``
        overrides the schedule's planned placement ("local" | "pool");
        ``granted_mem_bw`` is the contention-aware override of the pool
        grant (e.g. ``deliverable / θ``), symmetric to ``granted_lanes``.
        With ``mem=None`` (the default) the estimate is bitwise what it
        was before the memory model existed.

        ``kind="all_to_all"`` schedules price the same way with the
        exchange volumes of a permutation instead of a reduction: every
        tier's stage (``AllToAll`` legs and the slow tier's ``SlowChunk``
        sub-flows alike) moves ``(n_i - 1) / n_i`` of the CURRENT payload
        once (no doubling — nothing comes back up), the payload never
        shrinks between legs, and the slow legs keep the full NIC-pool /
        memory-pool treatment (``granted_lanes`` scaling and the
        ``max(wire, memory)`` rule).

        Note: a flat-strategy schedule is priced as per-tier sequential
        rings (an optimistic flat); the planner keeps using ``flat_ring``
        (the bottleneck-link model) when COMPARING flat against
        hierarchical candidates."""
        fab = self.fabric
        cfg = schedule.cfg
        if isinstance(granted_lanes, Mapping):
            for p, g in granted_lanes.items():
                if g <= 0:
                    raise ValueError(
                        f"granted_lanes[{p!r}] must be positive: {g}")

            def _granted(path: str) -> Optional[float]:
                return granted_lanes.get(path)
        else:
            if granted_lanes is not None and granted_lanes <= 0:
                raise ValueError(
                    f"granted_lanes must be positive: {granted_lanes}")

            def _granted(path: str) -> Optional[float]:
                return granted_lanes
        if granted_mem_bw is not None and granted_mem_bw <= 0:
            raise ValueError(
                f"granted_mem_bw must be positive: {granted_mem_bw}")
        mem_spec = self._mem_model(mem)
        mem_staging = staging if staging is not None else schedule.staging
        payload = float(schedule.numel * dtype_itemsize(schedule.dtype))

        def tier_for(leg) -> Tier:
            for t in fab.tiers:
                if t.axis == leg.axis or t.name == leg.tier:
                    return t
            # mesh axis unknown to the fabric description: price it like
            # the fastest tier (conservative for a fast leg)
            t0 = fab.tiers[0]
            return Tier(leg.tier, leg.axis, leg.size, t0.bw, t0.latency)

        n_chunks = max(len(schedule.slow_legs), 1)
        # per-member wire traffic of one leg, relative to the payload it
        # carries: an all-reduce slow leg moves (n-1)/n down AND back up
        # (xfer=2), an all-to-all stage moves its cross fraction once
        a2a = schedule.kind == "all_to_all"
        xfer = 1.0 if a2a else 2.0
        leg_charges: List[LegCharge] = []
        fast_s = slow_s = 0.0
        slow_by_path: Dict[str, float] = {}
        slow_seq: List[Tuple[str, float]] = []  # issue order, for pipelining
        # memory-pool serialization across CONCURRENT routes: the pool is
        # one resource, so sub-flows riding different paths still queue
        # their staged bytes behind each other.  Accumulate each slow
        # leg's pure pool-drain time (bytes / pool grant, no per-flow
        # cap, no latency tail) plus per-route tail sums; the multipath
        # combine floors the slow phase at drain-total + slowest route's
        # tails, which is exactly when the co-simulated pool empties.
        pool_drain_s = 0.0
        pool_tails: Dict[str, float] = {}
        first_slow = True
        for leg in schedule.legs:
            t = tier_for(leg)
            n = leg.size
            if isinstance(leg, sched.AllToAll):
                # one hierarchical all-to-all stage: exchanges this tier's
                # own sub-index — (n-1)/n of the (never-shrinking) payload.
                # Skewed stages (dest_sizes) charge the INCAST bound
                # instead: the stage drains when the hottest sub-index has
                # received its (n-1) incoming copies, so the wire time is
                # (n-1) * max over destination rows, not the mean — on a
                # uniform profile (each row payload/n) the two coincide.
                if n <= 1:
                    secs = by = 0.0
                elif leg.dest_sizes is not None:
                    by = (n - 1) * max(leg.dest_sizes)
                    secs = by / t.rate + (n - 1) * t.latency
                else:
                    by = (n - 1) / n * payload
                    secs = by / t.rate + (n - 1) * t.latency
                fast_s += secs
            elif isinstance(leg, sched.ReduceScatter):
                # a compressed mid-tier scatter sends quantized wire bytes;
                # the reduced payload itself stays full precision
                ratio = codec_ratio(leg.codec, cfg)
                secs = ring_reduce_scatter_time(payload / ratio, n, t.rate,
                                                t.latency)
                by = (n - 1) / n * payload / ratio if n > 1 else 0.0
                payload /= max(n, 1)
                fast_s += secs
            elif isinstance(leg, sched.Psum):
                ratio = codec_ratio(leg.codec, cfg)
                if n <= 1:
                    secs = by = 0.0
                else:
                    by = 2.0 * (n - 1) / n * payload / ratio
                    secs = by / t.rate + 2.0 * (n - 1) * t.latency
                    # a flat plan's slow-tier psum crosses the NIC pool
                    # (and the memory pool behind it) too: both
                    # contention-aware modes treat it like SlowChunk legs
                    if fab.depth > 1 and t.name == fab.slowest.name:
                        g = _granted("eth")
                        if g is not None:
                            secs *= max(t.lanes, 1e-30) / g
                        if mem_spec is not None:
                            secs = max(secs, self._mem_leg_seconds(
                                by, t, g if g is not None else t.lanes,
                                mem_spec, mem_staging, granted_mem_bw))
                fast_s += secs
            elif isinstance(leg, sched.SlowChunk):
                # the sub-flow is priced at ITS route's tier; a route this
                # fabric does not declare degrades to "eth" ENTIRELY —
                # rate, contention grant and concurrency group — because
                # its flows physically ride (and queue on) the Ethernet
                # pool there
                p_eff = leg.path
                if p_eff != "eth":
                    if fab.path_named(p_eff) is None:
                        p_eff = "eth"
                    else:
                        t = fab.path_tier(p_eff, leg.axis, leg.size)
                rate = t.rate
                if mem_bw_limit is not None:
                    rate = min(rate, mem_bw_limit / max(fab.n_fast, 1))
                if not cached:
                    rate = rate / 2.1
                ratio = codec_ratio(leg.codec, cfg)
                if n <= 1:
                    secs = by = 0.0
                else:
                    sel = None
                    if leg.dest_sizes is not None:
                        # incast bound on the skewed sub-flow: the slow
                        # exchange drains when the hottest destination has
                        # its (n-1) incoming per-destination flows — max
                        # over rows, not the mean (dest_sizes are already
                        # this chunk's share; uniform rows coincide with
                        # the payload/n_chunks formula below).  ``sel``
                        # keeps the (n-1) wire rows (the self row — no
                        # wire — drops as the smallest), the TRUE bytes
                        # the memory pool stages.
                        sel = sorted(leg.dest_sizes,
                                     reverse=True)[:max(n - 1, 1)]
                        by = xfer * (n - 1) * sel[0] / ratio
                    else:
                        by = xfer * (n - 1) / n * (payload / n_chunks) \
                            / ratio
                    # ring latency once on the FIRST ISSUED sub-flow (the
                    # lane_offset rotation must not change the total),
                    # then a launch overhead per extra sub-flow (matches
                    # the retired ntier_striped total)
                    lat = xfer * (n - 1) * t.latency if first_slow \
                        else xfer * t.latency
                    secs = by / rate + lat
                    g = _granted(p_eff)
                    if g is not None:
                        secs *= max(t.lanes, 1e-30) / g
                    if mem_spec is not None:
                        g_lanes = g if g is not None else t.lanes
                        if sel is not None:
                            mem_secs = self._mem_leg_seconds_skewed(
                                [xfer * b / ratio for b in sel], t,
                                g_lanes, mem_spec, mem_staging,
                                granted_mem_bw)
                            by_pool = xfer * sum(sel) / ratio
                        else:
                            mem_secs = self._mem_leg_seconds(
                                by, t, g_lanes, mem_spec, mem_staging,
                                granted_mem_bw)
                            by_pool = by
                        secs = max(secs, mem_secs)
                        grp = max(self.fabric.n_fast, 1)
                        pbw = granted_mem_bw if granted_mem_bw is not None \
                            else mem_spec.deliverable_bw(mem_staging)
                        pool_drain_s += (mem_spec.traffic_factor * grp
                                         * by_pool / max(pbw, 1e-30))
                        pool_tails[p_eff] = pool_tails.get(p_eff, 0.0) \
                            + mem_spec.staging_latency(mem_staging)
                first_slow = False
                slow_s += secs
                if p_eff not in slow_by_path:
                    slow_by_path[p_eff] = 0.0
                slow_by_path[p_eff] += secs
                slow_seq.append((p_eff, secs))
            else:  # AllGather — mirrors its ReduceScatter's payload level
                payload *= n
                secs = all_gather_time(payload, n, t.rate, t.latency)
                by = (n - 1) / n * payload if n > 1 else 0.0
                fast_s += secs
            leg_charges.append(LegCharge(leg, secs, by))

        multipath = len(slow_by_path) > 1
        # pool-serialization floor for concurrent routes: total drain
        # plus the slowest route's latency tails (tails on different
        # routes overlap; tails behind each other on one route add up)
        pool_floor = pool_drain_s + max(pool_tails.values(), default=0.0) \
            if multipath and pool_drain_s > 0.0 else 0.0
        if schedule.pipelined and schedule.chunks > 1:
            # exact replay of the simulator's per-route chained pipeline:
            # fast stage j finishes at F_j = (j+1)*fast/C (stages are
            # chained), sub-flow j starts at max(F_j, its route's
            # previous sub-flow) and its route's chain tail advances by
            # its charge; the makespan is the latest tail (or the last
            # fast stage).  Single-route schedules price through the SAME
            # recurrence: the old closed form (max(slow, fast) + one
            # overhang chunk) used the MEAN slow charge for the overhang,
            # overpricing fast-dominated pipelines — the overhang is the
            # LAST sub-flow, which carries only a per-chunk latency while
            # the first carries the full ring latency — and a price above
            # the replay breaks the audit's lower-bound contract.
            C = max(len(slow_seq), 1)
            fast_per = fast_s / C
            F = 0.0
            tails: Dict[str, float] = {}
            for p, secs in slow_seq:
                F += fast_per
                tails[p] = max(F, tails.get(p, 0.0)) + secs
            total = max([fast_s] + list(tails.values()))
            if pool_floor > 0.0:
                # first sub-flow cannot stage before its fast stage
                total = max(total, fast_per + pool_floor)
        else:
            # concurrent routes: the slow phase ends when the SLOWEST
            # route's chain drains (single-route: the plain sum, bitwise
            # as before)
            slow_eff = max(slow_by_path.values()) if multipath else slow_s
            total = fast_s + max(slow_eff, pool_floor)

        # per-tier aggregates (slow tier LAST, for the slow_s accessors)
        agg: Dict[str, List] = {}
        order: List[str] = []
        for lc in leg_charges:
            leg = lc.leg
            if leg.tier not in agg:
                agg[leg.tier] = [leg.axis, 0.0, 0.0, False]
                order.append(leg.tier)
            agg[leg.tier][1] += lc.seconds
            agg[leg.tier][2] += lc.bytes_per_chip
            if isinstance(leg, sched.ReduceScatter):
                agg[leg.tier][3] = True
        slow_tier = fab.slowest.name if fab.depth > 1 else None
        if slow_tier is not None and slow_tier not in agg:
            agg[slow_tier] = [fab.slowest.axis, 0.0, 0.0, False]
            order.append(slow_tier)
        if slow_tier in order:
            order.remove(slow_tier)
            order.append(slow_tier)
        charges = tuple(TierCharge(nm, agg[nm][0], agg[nm][1], agg[nm][2],
                                   agg[nm][3]) for nm in order)
        name = f"schedule_{schedule.strategy}"
        if schedule.pipelined:
            name += "_ovl"
        return ScheduleEstimate(
            name, total, charges, tuple(leg_charges),
            scatter_depth=len(schedule.scattered_axes),
            chunks=schedule.chunks, pipelined=schedule.pipelined,
            notes=schedule.describe(),
            path_seconds=tuple(slow_by_path.items()))

    # ---- N-tier strategies --------------------------------------------------
    def ntier_striped(self, nbytes: float, scatter_depth: int = -1,
                      chunks: int = 1, compression_ratio: float = 1.0,
                      mem_bw_limit: Optional[float] = None,
                      cached: bool = True) -> NTierEstimate:
        """The general DFabric plan on an N-tier fabric: reduce-scatter down
        the first ``scatter_depth`` fast tiers (-1 = all), striped
        all-reduce on the slowest tier, all-gather back up.  Every tier is
        charged independently; fast tiers beyond the scatter depth are
        charged a full (unscattered) ring all-reduce at their level.
        """
        fab = self.fabric
        fast = fab.fast_tiers
        depth = len(fast) if scatter_depth < 0 else min(scatter_depth, len(fast))
        charges: List[TierCharge] = []
        payload = float(nbytes)
        # down + up the fast tiers
        for i, tier in enumerate(fast):
            if i < depth and tier.size > 1:
                t = (ring_reduce_scatter_time(payload, tier.size, tier.rate, tier.latency)
                     + all_gather_time(payload, tier.size, tier.rate, tier.latency))
                by = 2.0 * (tier.size - 1) / tier.size * payload
                charges.append(TierCharge(tier.name, tier.axis, t, by, True))
                payload /= tier.size
            else:
                # unscattered: this tier carries the whole current payload
                t = ring_all_reduce_time(payload, tier.size, tier.rate, tier.latency)
                by = 2.0 * (tier.size - 1) / tier.size * payload
                charges.append(TierCharge(tier.name, tier.axis, t, by, False))
        # the slowest leg (striped across everything scattered above it)
        slow = fab.slowest
        if fab.depth == 1:
            # single-tier fabric: the only tier IS the slowest; a plain
            # ring all-reduce on it is the whole collective
            t = ring_all_reduce_time(payload, slow.size, slow.rate, slow.latency)
            by = 2.0 * (slow.size - 1) / slow.size * payload
            charges.append(TierCharge(slow.name, slow.axis, t, by, False))
            return NTierEstimate("ntier_striped", t, tuple(charges), depth)
        if slow.size <= 1:
            # degenerate slow tier: charge it zero so charges[-1] (the
            # slow_s/slow_bytes_per_chip accessors) stays the slow tier
            charges.append(TierCharge(slow.name, slow.axis, 0.0, 0.0, False))
            total = sum(c.seconds for c in charges)
            return NTierEstimate("ntier_striped", total, tuple(charges), depth)
        rate = slow.rate
        if mem_bw_limit is not None:
            rate = min(rate, mem_bw_limit / max(fab.n_fast, 1))
        if not cached:
            rate = rate / 2.1
        slow_bytes = (2.0 * (slow.size - 1) / slow.size * payload
                      / max(compression_ratio, 1.0))
        t_slow = slow_bytes / rate + 2.0 * (slow.size - 1) * slow.latency
        t_slow += (max(chunks, 1) - 1) * slow.latency * 2  # per-chunk launch
        charges.append(TierCharge(slow.name, slow.axis, t_slow, slow_bytes, False))
        total = sum(c.seconds for c in charges)
        name = "ntier_striped"
        if compression_ratio > 1.0:
            name += "_comp"
        return NTierEstimate(name, total, tuple(charges), depth,
                             notes=f"chunks={chunks} comp={compression_ratio}")

    def ntier_best(self, nbytes: float, max_chunks: int = 4,
                   compression_ratio: float = 1.0) -> NTierEstimate:
        """Search over scatter depths (and optionally compression) for the
        cheapest N-tier plan."""
        cands = [self.ntier_striped(nbytes, scatter_depth=d)
                 for d in range(len(self.fabric.fast_tiers) + 1)]
        if compression_ratio > 1.0:
            cands.append(self.ntier_striped(
                nbytes, scatter_depth=-1, chunks=max_chunks,
                compression_ratio=compression_ratio))
        return min(cands, key=lambda e: e.total_s)

    # ---- two-tier strategies (legacy API, paper figures) --------------------
    def flat_ring(self, nbytes: float, nics_per_host: float = 1.0,
                  mem_bw_limit: Optional[float] = None, cached: bool = True) -> CollectiveEstimate:
        """ToR baseline: one flat ring over all DP members; every cross-pod
        hop carries the full ring traffic over a single host's NIC(s)."""
        topo, hw = self.topo, self.topo.hw
        n = topo.total_chips
        if topo.num_pods == 1:
            t = ring_all_reduce_time(nbytes, n, hw.ici_bw, hw.ici_latency)
            return CollectiveEstimate("flat_ring", t, t, 0.0, 0.0, 2 * (n - 1) / n * nbytes)
        # ring crosses DCN 2*num_pods times; slowest link dominates the ring:
        # each member forwards 2(n-1)/n * nbytes; cross-pod members do it at
        # NIC speed (not pooled: nics_per_host NICs for that one host).
        dcn_link = self._dcn_rate_per_chip(mem_bw_limit, cached) * nics_per_host
        per_member = 2.0 * (n - 1) / n * nbytes
        t_dcn = per_member / dcn_link
        t_lat = 2.0 * (n - 1) * hw.ici_latency + 2.0 * topo.num_pods * hw.dcn_latency
        t_ici = per_member / hw.ici_bw
        t = max(t_dcn, t_ici) + t_lat
        return CollectiveEstimate("flat_ring", t, t_ici, t_dcn, per_member, per_member,
                                  notes=f"nics_per_host={nics_per_host}")

    def hierarchical(self, nbytes: float, striped: bool = True, chunks: int = 1,
                     compression_ratio: float = 1.0,
                     mem_bw_limit: Optional[float] = None, cached: bool = True,
                     overlap: bool = False) -> CollectiveEstimate:
        """DFabric: reduce-scatter on ICI -> all-reduce over pods (striped
        across the whole NIC pool) -> all-gather on ICI.

        striped=False models a single "root" chip carrying the whole
        cross-pod payload (no NIC pool).  compression_ratio>1 models the
        DCN-tier gradient compression (beyond-paper).  overlap=True models
        chunk-pipelining of the DCN leg with the ICI legs.
        """
        topo, hw = self.topo, self.topo.hw
        n_ici = topo.chips_per_pod
        P = topo.num_pods
        t_rs = ring_reduce_scatter_time(nbytes, n_ici, hw.ici_bw, hw.ici_latency)
        t_ag = all_gather_time(nbytes, n_ici, hw.ici_bw, hw.ici_latency)
        if P == 1:
            total = t_rs + t_ag
            return CollectiveEstimate("hierarchical", total, total, 0.0, 0.0,
                                      2 * (n_ici - 1) / n_ici * nbytes / n_ici * n_ici)
        dcn_rate = self._dcn_rate_per_chip(mem_bw_limit, cached)
        shard = nbytes / (n_ici if striped else 1)
        dcn_bytes_per_chip = 2.0 * (P - 1) / P * shard / compression_ratio
        t_dcn = dcn_bytes_per_chip / dcn_rate + 2.0 * (P - 1) * hw.dcn_latency
        t_dcn += (chunks - 1) * hw.dcn_latency * 2  # per-chunk launch latency
        if overlap and chunks > 1:
            # pipeline: ICI legs hide all but one chunk of the DCN leg (or
            # vice versa, whichever dominates)
            per_chunk_dcn = t_dcn / chunks
            per_chunk_ici = (t_rs + t_ag) / chunks
            total = max(t_dcn, t_rs + t_ag) + min(per_chunk_dcn, per_chunk_ici)
        else:
            total = t_rs + t_dcn + t_ag
        name = "hier_striped" if striped else "hier_root"
        if compression_ratio > 1.0:
            name += "_comp"
        if overlap and chunks > 1:
            name += "_ovl"
        ici_bytes = 2.0 * (n_ici - 1) / n_ici * nbytes / n_ici * 1.0
        return CollectiveEstimate(name, total, t_rs + t_ag, t_dcn,
                                  dcn_bytes_per_chip, ici_bytes,
                                  notes=f"chunks={chunks} comp={compression_ratio}")

    def optimal(self, nbytes: float) -> CollectiveEstimate:
        """Lower bound: as if the fast interconnect spanned both pods
        (paper Fig.2 'optimal')."""
        topo, hw = self.topo, self.topo.hw
        n = topo.total_chips
        t = ring_all_reduce_time(nbytes, n, hw.ici_bw, hw.ici_latency)
        return CollectiveEstimate("optimal", t, t, 0.0, 0.0, 2 * (n - 1) / n * nbytes)

    # ---- other patterns (paper Fig. 12) -------------------------------------
    def gather(self, nbytes_per_cn: float, striped: bool = True) -> float:
        """CN0 receives from all other CNs (cross-pod part via NIC pool)."""
        topo, hw = self.topo, self.topo.hw
        remote = (topo.num_pods - 1) * topo.chips_per_pod * nbytes_per_cn
        pool_bw = topo.pool_dcn_bw if striped else hw.dcn_bw * topo.dcn_lanes
        # receiving side is one pod's pool; memory pool must absorb it
        rate = min(pool_bw, topo.pool_hbm_bw)
        local = (topo.chips_per_pod - 1) * nbytes_per_cn / hw.ici_bw
        return remote / rate + local + hw.dcn_latency

    def broadcast(self, nbytes: float, striped: bool = True) -> float:
        topo, hw = self.topo, self.topo.hw
        pool_bw = topo.pool_dcn_bw if striped else hw.dcn_bw * topo.dcn_lanes
        cross = (topo.num_pods - 1) * nbytes / min(pool_bw, topo.pool_hbm_bw)
        local = nbytes * (topo.chips_per_pod - 1) / topo.chips_per_pod / hw.ici_bw
        return cross + local + hw.dcn_latency

    def all_to_all(self, nbytes_per_cn: float, striped: bool = True) -> float:
        """Every CN exchanges with every other CN (MoE dispatch / paper's
        LLM gradient sync pattern). Cross-pod volume saturates the pool in
        both directions simultaneously."""
        topo, hw = self.topo, self.topo.hw
        n = topo.total_chips
        cross_frac = (topo.num_pods - 1) / topo.num_pods
        cross_bytes_per_chip = nbytes_per_cn * cross_frac
        rate = self._dcn_rate_per_chip() if striped else hw.dcn_bw / topo.chips_per_pod
        t_cross = cross_bytes_per_chip / rate
        t_local = nbytes_per_cn * (1 - cross_frac) / hw.ici_bw
        return max(t_cross, t_local) + hw.dcn_latency + (n - 1) * hw.ici_latency

    def ring_reduce_bw(self, nbytes: float, striped: bool = True) -> float:
        """Paper Fig.12 'Ring-Reduce': send+receive simultaneously."""
        est = self.hierarchical(nbytes, striped=striped)
        return est.total_s

    # ---- convenience ---------------------------------------------------------
    def best(self, nbytes: float, chunks: int = 4,
             compression_ratio: float = 1.0) -> CollectiveEstimate:
        cands = [
            self.flat_ring(nbytes),
            self.hierarchical(nbytes, striped=False),
            self.hierarchical(nbytes, striped=True),
            self.hierarchical(nbytes, striped=True, chunks=chunks, overlap=True),
        ]
        if compression_ratio > 1.0:
            cands.append(self.hierarchical(nbytes, striped=True, chunks=chunks,
                                           overlap=True, compression_ratio=compression_ratio))
        return min(cands, key=lambda e: e.total_s)

    def summary(self, nbytes: float) -> Dict[str, float]:
        return {
            "flat_ring": self.flat_ring(nbytes).total_s,
            "hier_root": self.hierarchical(nbytes, striped=False).total_s,
            "hier_striped": self.hierarchical(nbytes, striped=True).total_s,
            "hier_striped_ovl4": self.hierarchical(nbytes, striped=True, chunks=4, overlap=True).total_s,
            "hier_striped_comp4": self.hierarchical(nbytes, striped=True, compression_ratio=4.0).total_s,
            "optimal": self.optimal(nbytes).total_s,
        }

    def ntier_summary(self, nbytes: float) -> Dict[str, float]:
        """Per-depth N-tier summary (keys: scatter depth)."""
        out = {}
        for d in range(len(self.fabric.fast_tiers) + 1):
            out[f"depth{d}"] = self.ntier_striped(nbytes, scatter_depth=d).total_s
        out["comp4"] = self.ntier_striped(nbytes, compression_ratio=4.0).total_s
        return out
