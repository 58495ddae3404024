"""The sim↔price drift auditor: per-leg simulated-vs-priced drift tables.

The repo's contract (ROADMAP, enforced point-wise by the batteries) is
that :func:`repro.sim.fabric_sim.simulate` and
:meth:`CostModel.from_schedule` walk the SAME legs and agree — exactly
when nothing contends, and by documented bounds when something does.
:func:`compare` turns that into a continuously checkable table: every
simulated leg (and each tenant's total) is placed in a **contract
class** and judged against its expectation:

  ``exact``      uncontended sequential replay (incl. memory co-sim and
                 skewed all-to-alls): |sim − price| ≤ 1e-9 relative.
  ``pipelined``  uncontended pipelined replay: < 1% (the per-chunk
                 fp attribution and the closed-form overlap credit).
  ``priced``     uncontended multipath (≥ 2 concurrent route groups):
                 < 1% (the per-route recurrence).
  ``bracketed``  wire-contended FLUID flows: price(lo grant) ≤ sim ≤
                 price(hi grant), where the lo grant is the flow's own
                 cap (it can never run faster than alone at full cap)
                 and the hi grant is its weighted max-min guarantee
                 ``pool · w / Σ w`` (it is never granted less) — checked
                 with 1% slack (the pipelined/multipath tolerance).
  ``bounded``    pinned lanes, memory contention, or ``after``-queued
                 tenants (the serving fleet's phase/admission chains):
                 lower bound only, sim ≥ price(best case) − 1% (static
                 lane assignment, memory-pool queueing and simulated
                 admission delay have no closed-form upper bound worth
                 promising).
  ``degraded``   fluid tenants whose run overlaps a capacity loss (a
                 ``lane_down`` shrink recorded in the pool's
                 ``capacity_steps``): price-on-degraded-spec bounds the
                 sim — price(lo grant at the PRE-FAILURE capacity) ≤
                 sim ≤ price(max-min guarantee on the POST-FAILURE
                 capacity), 1% slack.  When MEMORY capacity degraded
                 (``device_down``) the upper bound is dropped (lower
                 bound only): the spec the mem price would use is the
                 already-degraded one, unsound for pre-failure legs.
  ``compute``    schedule-less tenants: compute phases against their
                 configured duration (exact, or ≥ under memory
                 contention).

Tenants killed mid-run (``SimResult.failed_tenants``) get NO
expectation — their replay was truncated at the failure, so neither
bound is defined.

:func:`auto_expectations` derives the class and the lo/hi estimates for
every tenant of a :class:`~repro.sim.fabric_sim.SimObservation`
automatically (contention detected from slow-event overlap per lane
group, memory contention from the mem trace, pinning from the tenant),
which is what ``benchmarks/run.py --trace-dir`` audits every smoke
figure with.

CLI: ``python -m repro.obs.audit [--out DIR]`` runs a built-in 2-tier +
skewed demo grid and writes ``demo*.trace.json`` + ``drift.csv``.

A copy of ``repro.obs.audit`` for the port (the port imports nothing of
``repro``): only its imports differ.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import (Dict, List, Mapping, Optional, Sequence, Tuple, Union)

from repro_torch.core.cost_model import CostModel, ScheduleEstimate
from repro_torch.sim.fabric_sim import (COMPUTE, SimObservation, SimResult, Tenant,
                                  leg_label)

TOL_EXACT = 1e-9
TOL_LOOSE = 1e-2  # pipelined / priced / bracket slack
_ABS_SLACK = 1e-12  # seconds; forgives fp dust on ~zero-length legs


@dataclass(frozen=True)
class Expectation:
    """What one tenant's replay is allowed to look like.  ``lo`` is the
    best-case estimate (solo at the flow's own cap); ``hi`` (contended
    fluid tenants only) the worst-case estimate at the max-min
    guaranteed grant.  ``cls`` forces the contract class; None derives
    it from the estimates (exact / pipelined / priced)."""

    lo: Optional[ScheduleEstimate]
    hi: Optional[ScheduleEstimate] = None
    cls: Optional[str] = None

    def resolved_cls(self) -> str:
        if self.cls is not None:
            return self.cls
        if self.lo is None:
            return "compute"
        if self.hi is not None:
            return "bracketed"
        if self.lo.pipelined and self.lo.chunks > 1:
            return "pipelined"
        if len(self.lo.path_seconds) > 1:
            return "priced"
        return "exact"


@dataclass(frozen=True)
class LegDrift:
    """One audited row: a (tenant, round, leg) interval or a tenant
    total.  ``drift`` is the signed relative deviation — vs ``lo`` for
    the point classes, the bracket exceedance (0 inside) for
    ``bracketed``, the shortfall below ``lo`` for ``bounded``."""

    tenant: str
    leg: str
    round: int
    cls: str
    sim_s: float
    lo_s: float
    hi_s: Optional[float]
    drift: float
    ok: bool


@dataclass(frozen=True)
class DriftReport:
    rows: Tuple[LegDrift, ...]

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.rows)

    def failures(self) -> Tuple[LegDrift, ...]:
        return tuple(r for r in self.rows if not r.ok)

    def max_drift(self) -> float:
        return max((abs(r.drift) for r in self.rows), default=0.0)

    @staticmethod
    def csv_header() -> str:
        return "tenant,leg,round,class,sim_s,lo_s,hi_s,drift,ok"

    def to_csv(self, header: bool = True, prefix: str = "") -> str:
        lines = []
        if header:
            head = self.csv_header()
            lines.append("figure," + head if prefix else head)
        for r in self.rows:
            hi = f"{r.hi_s:.9e}" if r.hi_s is not None else ""
            row = (f"{r.tenant},{r.leg},{r.round},{r.cls},{r.sim_s:.9e},"
                   f"{r.lo_s:.9e},{hi},{r.drift:.3e},{r.ok}")
            lines.append(f"{prefix},{row}" if prefix else row)
        return "\n".join(lines)

    def describe(self) -> str:
        bad = self.failures()
        lines = [f"DriftReport: {len(self.rows)} rows, "
                 f"max |drift| {self.max_drift():.2e}, "
                 f"{'OK' if self.ok else f'{len(bad)} OUT OF CLASS'}"]
        by_cls: Dict[str, int] = {}
        for r in self.rows:
            by_cls[r.cls] = by_cls.get(r.cls, 0) + 1
        lines.append("  " + "  ".join(f"{c}:{n}"
                                      for c, n in sorted(by_cls.items())))
        for r in bad:
            hi = f", hi {r.hi_s:.3e}" if r.hi_s is not None else ""
            lines.append(f"  FAIL {r.tenant} {r.leg} r{r.round} [{r.cls}] "
                         f"sim {r.sim_s:.3e} vs lo {r.lo_s:.3e}{hi} "
                         f"(drift {r.drift:+.2e})")
        return "\n".join(lines)


def _leg_spans(result: SimResult, name: str
               ) -> List[Tuple[int, object, float, float, bool]]:
    """Per-(round, leg) busy intervals of one tenant: pool legs (events
    with lanes > 0) take the SPAN max(finish) − min(start) — an
    all-to-all leg's per-destination flows run concurrently and the leg
    ends with the hottest — while engine legs SUM their event durations
    (a pipelined fast leg is attributed per chunk).  Returns
    [(round, leg, start, seconds, is_pool)] in first-event order."""
    acc: Dict[Tuple[int, int], List] = {}
    order: List[Tuple[int, int]] = []
    for e in result.tenant_events(name):
        key = (e.round, id(e.leg))
        if key not in acc:
            acc[key] = [e.leg, e.start, e.finish, 0.0, e.lanes > 0]
            order.append(key)
        rec = acc[key]
        rec[1] = min(rec[1], e.start)
        rec[2] = max(rec[2], e.finish)
        rec[3] += e.finish - e.start
        rec[4] = rec[4] or e.lanes > 0
    out = []
    for key in order:
        leg, start, finish, summed, is_pool = acc[key]
        secs = (finish - start) if is_pool else summed
        out.append((key[0], leg, start, secs, is_pool))
    return out


def _tol(cls: str, tol_exact: float, tol_loose: float) -> float:
    return tol_exact if cls in ("exact", "compute") else tol_loose


def compare(result: SimResult,
            estimates: Mapping[str, Union[ScheduleEstimate, Expectation,
                                          None]],
            tenants: Optional[Sequence[Tenant]] = None, *,
            tol_exact: float = TOL_EXACT,
            tol_loose: float = TOL_LOOSE) -> DriftReport:
    """Walk every matched leg of ``result`` against ``estimates`` (one
    per tenant name: a bare :class:`ScheduleEstimate` means "uncontended
    contract", an :class:`Expectation` carries class/bracket) and emit
    the per-leg drift table plus one ``total`` row per tenant.

    Legs match by IDENTITY: the estimate must be priced from the same
    :class:`CommSchedule` object the tenant replayed (the repo-wide
    ``leg_charges[i].leg is schedule.legs[i]`` contract)."""
    cfg: Dict[str, Tenant] = {t.name: t for t in (tenants or ())}
    rows: List[LegDrift] = []
    for name in sorted(result.finish):
        if name not in estimates:
            continue
        exp = estimates[name]
        if not isinstance(exp, Expectation):
            exp = Expectation(exp)
        cls = exp.resolved_cls()
        tol = _tol(cls, tol_exact, tol_loose)
        lo_by = {id(lc.leg): lc.seconds for lc in exp.lo.leg_charges} \
            if exp.lo is not None else {}
        hi_by = {id(lc.leg): lc.seconds for lc in exp.hi.leg_charges} \
            if exp.hi is not None else {}
        tn = cfg.get(name)
        compute_meas = 0.0
        first_start: Optional[float] = None
        rounds = 0
        for rnd, leg, start, secs, is_pool in _leg_spans(result, name):
            rounds = max(rounds, rnd + 1)
            if first_start is None:
                first_start = start
            if leg == COMPUTE:
                compute_meas += secs
                lo = tn.compute_s if tn is not None else secs
                hi: Optional[float] = lo
                # compute stretches only under memory contention, where
                # the whole tenant is lower-bounded anyway
                leg_cls = cls if cls == "bounded" else "compute"
                if leg_cls == "bounded":
                    hi = None
            elif id(leg) in lo_by:
                lo = lo_by[id(leg)]
                hi = hi_by.get(id(leg))
                leg_cls = cls
                if cls in ("bracketed", "degraded") and hi is None:
                    # bracketed: fast legs ride the private engine;
                    # degraded without an upper estimate (memory
                    # degradation) stays lower-bound only
                    hi = lo if exp.hi is not None else \
                        (lo if cls == "bracketed" else None)
                elif cls not in ("bracketed", "bounded", "degraded"):
                    hi = lo
                if not is_pool and cls in ("bracketed", "bounded",
                                           "degraded"):
                    # engine legs are never contended: exact both ways
                    leg_cls, hi = "exact", lo
            else:
                continue  # unpriced leg (foreign estimate) — skip
            rows.append(_judge(name, leg_label(leg), rnd, leg_cls, secs,
                               lo, hi, _tol(leg_cls, tol_exact, tol_loose)))
        # ---- the tenant total --------------------------------------------
        t0 = tn.start if tn is not None else (first_start or 0.0)
        sim_total = result.finish[name] - t0
        if exp.lo is None:
            lo_t = compute_meas
            hi_t: Optional[float] = None if cls == "bounded" else lo_t
        else:
            lo_t = compute_meas + rounds * exp.lo.total_s
            no_hi = cls == "bounded" or (cls == "degraded"
                                         and exp.hi is None)
            hi_t = None if no_hi else \
                compute_meas + rounds * (exp.hi or exp.lo).total_s
        rows.append(_judge(name, "total", 0,
                           cls if exp.lo is not None or cls == "bounded"
                           else "compute",
                           sim_total, lo_t, hi_t, tol))
    return DriftReport(tuple(rows))


def _judge(tenant: str, leg: str, rnd: int, cls: str, sim: float,
           lo: float, hi: Optional[float], tol: float) -> LegDrift:
    scale = max(abs(lo), _ABS_SLACK)
    if hi is not None and hi != lo:
        # bracket: lo ≤ sim ≤ hi, with `tol` relative slack each side
        if sim < lo * (1 - tol) - _ABS_SLACK:
            drift = (sim - lo) / scale
            ok = False
        elif sim > hi * (1 + tol) + _ABS_SLACK:
            drift = (sim - hi) / max(abs(hi), _ABS_SLACK)
            ok = False
        else:
            drift = 0.0
            ok = True
        return LegDrift(tenant, leg, rnd, cls, sim, lo, hi, drift, ok)
    if hi is None:
        # lower bound only
        drift = (sim - lo) / scale
        return LegDrift(tenant, leg, rnd, cls, sim, lo, None, drift,
                        sim >= lo * (1 - tol) - _ABS_SLACK)
    drift = (sim - lo) / scale
    return LegDrift(tenant, leg, rnd, cls, sim, lo, hi, drift,
                    abs(sim - lo) <= tol * scale + _ABS_SLACK)


# ---------------------------------------------------------------------------
# Automatic expectation derivation (the --trace-dir auditor)
# ---------------------------------------------------------------------------


def _overlap(a: Sequence[Tuple[float, float]],
             b: Sequence[Tuple[float, float]], eps: float = 1e-12) -> bool:
    for s0, f0 in a:
        for s1, f1 in b:
            if s0 < f1 - eps and s1 < f0 - eps:
                return True
    return False


def auto_expectations(obs: SimObservation) -> Dict[str, Expectation]:
    """Derive each tenant's :class:`Expectation` from what the run
    actually did (see the module docstring's class table):

      * contention per lane group = another tenant's pool flows overlap
        this tenant's in time on that group;
      * memory contention = the mem trace is nonempty and another
        memory-demanding tenant's activity overlaps this one's;
      * the lo grant per group is ``min(cap, pool lanes)`` (cap =
        ``max_lanes`` on the Ethernet group, the group's nominal lanes
        otherwise; 1.0-per-lane for pinned flows);
      * the hi grant is the weighted max-min guarantee
        ``pool · p·nd / Σ p·nd`` over the group's contenders (nd = an
        all-to-all leg's per-destination fan-out — each destination is
        its own flow), clamped at the lo cap — sound for fluid flows,
        so ANY pinning on a shared group demotes the class to bounded.
    """
    fab, result, cm = obs.fabric, obs.result, obs.cost
    mem_arg = result.mem if result.mem is not None else None

    def eff_path(leg) -> str:
        p = getattr(leg, "path", "eth")
        if p != "eth" and fab.path_named(p) is None:
            p = "eth"
        return p

    def nominal_of(path: str) -> float:
        if path != "eth":
            return fab.path_named(path).lanes
        return fab.slowest.lanes if fab.depth > 1 else 1.0

    def pool_of(path: str):
        return result.pool if path == "eth" else result.path_pools[path]

    def pool_cap0(path: str) -> float:
        # the PRE-FAILURE capacity: a lower-bound price must clamp at
        # what the pool offered at its largest (legs before a shrink ran
        # on the healthy pool and may beat a degraded-capacity price)
        pl = pool_of(path)
        steps = getattr(pl, "capacity_steps", None)
        return steps[0][1] if steps else pl.lanes

    # degraded lane groups: first capacity-loss time per group (from the
    # shrink steps the arbiters record), plus memory degradation
    deg_path_t: Dict[str, float] = {}
    for p in ("eth",) + tuple(result.path_pools):
        t0 = getattr(pool_of(p), "degraded_since", lambda: None)()
        if t0 is not None:
            deg_path_t[p] = t0
    mem_deg = result.mem is not None \
        and getattr(result.mem, "degraded_since", lambda: None)() is not None
    failed = set(result.failed_tenants)

    # per-tenant busy intervals: pool flows per lane group, plus memory-
    # demanding activity (slow flows always; compute when it draws bw)
    slow_iv: Dict[str, Dict[str, List[Tuple[float, float]]]] = {}
    mem_iv: Dict[str, List[Tuple[float, float]]] = {}
    cfg = {t.name: t for t in obs.tenants}
    for e in result.events:
        if e.lanes > 0:
            slow_iv.setdefault(e.tenant, {}) \
                .setdefault(eff_path(e.leg), []).append((e.start, e.finish))
            mem_iv.setdefault(e.tenant, []).append((e.start, e.finish))
        elif e.leg == COMPUTE and cfg[e.tenant].compute_mem_bw > 0:
            mem_iv.setdefault(e.tenant, []).append((e.start, e.finish))

    mem_on = result.mem is not None and bool(result.mem.segments)

    def contended_paths(name: str) -> List[str]:
        mine = slow_iv.get(name, {})
        out = []
        for p, ivs in mine.items():
            for other, theirs in slow_iv.items():
                if other != name and p in theirs \
                        and _overlap(ivs, theirs[p]):
                    out.append(p)
                    break
        return out

    def mem_contended(name: str) -> bool:
        if not mem_on or name not in mem_iv:
            return False
        return any(_overlap(mem_iv[name], ivs)
                   for other, ivs in mem_iv.items() if other != name)

    # per-leg fan-out: an all-to-all slow leg expands into (size-1) flows
    def fanout(tn: Tenant, path: str) -> int:
        if tn.schedule is None or tn.schedule.kind != "all_to_all":
            return 1
        nd = 1
        for leg in tn.schedule.slow_legs:
            if eff_path(leg) == path:
                nd = max(nd, max(int(leg.size) - 1, 1))
        return nd

    def lo_cap(tn: Tenant, path: str) -> float:
        cap = nominal_of(path)
        if path == "eth" and tn.max_lanes is not None:
            cap = tn.max_lanes
        if tn.pin_lanes:
            cap = min(cap, 1.0)  # a pinned flow owns at most its lane
        return min(cap, pool_cap0(path))

    out: Dict[str, Expectation] = {}
    for tn in obs.tenants:
        name = tn.name
        if name in failed:
            continue  # truncated replay: neither bound is defined
        # an `after` tenant's total is measured from its own `start` but
        # it really began at its predecessor's finish — the queueing
        # delay is simulated, not priced, so only the lower bound holds
        queued = tn.after is not None
        if tn.schedule is None:
            out[name] = Expectation(
                None, cls="bounded" if queued or mem_contended(name)
                else "compute")
            continue
        paths = list(slow_iv.get(name, {}))
        granted_lo = {p: lo_cap(tn, p) for p in paths
                      if lo_cap(tn, p) != nominal_of(p)}
        # the simulator's memory flows cap at the flow's OWN lane cap
        # (max_lanes / nominal), not at the arbiter's grant — pricing the
        # memory side at a REDUCED grant (pinning, an undersized pool)
        # would overstate it and break the lower bound, so the lo price
        # drops the memory term whenever the grant sits below the cap
        def sim_cap(p: str) -> float:
            if p == "eth" and tn.max_lanes is not None:
                return tn.max_lanes
            return nominal_of(p)

        # memory degradation poisons the mem price for this run: the
        # spec the price would use is the already-shrunk one, which
        # overstates pre-failure legs — drop the mem term from lo
        mem_degraded = mem_deg and name in mem_iv
        unsafe_mem = mem_arg is not None and (mem_degraded or any(
            granted_lo[p] < sim_cap(p) - 1e-12 for p in granted_lo))
        lo = cm.from_schedule(
            tn.schedule, granted_lanes=granted_lo or None,
            mem=None if unsafe_mem else mem_arg)
        hot = contended_paths(name)
        # lane groups that lost capacity during the run: every tenant on
        # them brackets against the POST-FAILURE pool (the loosest upper
        # bound — sound whether the tenant ran before or after the step)
        deg_paths = [p for p in paths if p in deg_path_t]
        pinned_near = any(
            cfg[other].pin_lanes
            for p in hot for other in slow_iv if p in slow_iv[other])

        def hi_guarantee(groups: Sequence[str]) -> Dict[str, float]:
            granted_hi = dict(granted_lo)
            for p in groups:
                mine = tn.priority * fanout(tn, p)
                total = sum(cfg[o].priority * fanout(cfg[o], p)
                            for o in slow_iv if p in slow_iv[o])
                # pool_of(p).lanes is the FINAL (post-shrink) capacity
                share = pool_of(p).lanes * mine / max(total, 1e-30)
                granted_hi[p] = min(share, lo_cap(tn, p))
            return granted_hi

        if queued or tn.pin_lanes or (hot and pinned_near):
            out[name] = Expectation(lo, cls="bounded")
        elif mem_contended(name):
            out[name] = Expectation(lo, cls="bounded")
        elif mem_degraded:
            out[name] = Expectation(lo, cls="degraded")
        elif deg_paths:
            hi = cm.from_schedule(
                tn.schedule,
                granted_lanes=hi_guarantee(sorted(set(deg_paths) | set(hot))),
                mem=mem_arg)
            out[name] = Expectation(lo, hi, cls="degraded")
        elif hot:
            hi = cm.from_schedule(tn.schedule,
                                  granted_lanes=hi_guarantee(hot),
                                  mem=mem_arg)
            out[name] = Expectation(lo, hi, cls="bracketed")
        else:
            out[name] = Expectation(lo)
    return out


def audit_observation(obs: SimObservation, **kw) -> DriftReport:
    """``compare`` with automatically derived expectations."""
    return compare(obs.result, auto_expectations(obs), obs.tenants, **kw)


# ---------------------------------------------------------------------------
# CLI demo: python -m repro.obs.audit [--out DIR]
# ---------------------------------------------------------------------------


def _demo(out_dir: str) -> DriftReport:
    from repro_torch.core.schedule import SyncConfig, build_all_to_all, \
        build_schedule
    from repro_torch.core.topology import Tier, FabricSpec
    from repro_torch.obs.capture import capture, export_observation
    from repro_torch.sim.fabric_sim import simulate

    fab = FabricSpec(tiers=(
        Tier("ici", "pod", 4, 40e9, 1e-6),
        Tier("dcn", "dp", 2, 5e9, 10e-6)))
    rows: List[LegDrift] = []
    with capture() as observations:
        # 2-tier grid: sequential + pipelined, solo (exact / pipelined)
        for chunks, pipe in ((1, False), (2, False), (2, True), (4, True)):
            s = build_schedule(
                fab, SyncConfig(strategy="hier_striped", chunks=chunks,
                                pipeline=pipe), (1 << 14,), 0)
            simulate(fab, [Tenant("cn0", s, compute_s=1e-4)])
        # θ=2 contention on the shared pool (bracketed)
        s = build_schedule(
            fab, SyncConfig(strategy="hier_striped", chunks=2,
                            pipeline=False), (1 << 14,), 0)
        simulate(fab, [Tenant("a", s), Tenant("b", s)])
        # skewed all-to-all incast, solo (exact)
        n = 8
        sizes = [float(1 << 10)] * n
        sizes[0] *= 4.0  # the hot destination
        s = build_all_to_all(fab, SyncConfig(strategy="hier_striped",
                                             chunks=1, pipeline=False),
                             (n, 1 << 8), "float32", dest_sizes=sizes)
        simulate(fab, [Tenant("moe", s)])
    for k, ob in enumerate(observations):
        _, rep = export_observation(ob, out_dir, f"demo_{k:02d}")
        rows.extend(rep.rows)
    report = DriftReport(tuple(rows))
    with open(os.path.join(out_dir, "drift.csv"), "w") as f:
        f.write(report.to_csv() + "\n")
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro.obs.audit",
        description="sim↔price drift demo: traces + drift.csv")
    ap.add_argument("--out", default="out", help="artifact directory")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    report = _demo(args.out)
    print(report.describe())
    print(f"artifacts in {args.out}/ (demo_*.trace.json, drift.csv)")
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
