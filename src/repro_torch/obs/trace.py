"""SimResult → Chrome-trace / Perfetto JSON.

``to_chrome_trace`` renders one :class:`~repro.sim.fabric_sim.SimResult`
as the Trace Event Format Perfetto (ui.perfetto.dev) and
``chrome://tracing`` load directly:

  * pid 1 ``sim``: one thread per tenant for its serial engine (compute
    phases + fast legs), plus ``<tenant> slow`` sub-threads for pool
    flows — overlapping flows (concurrent routes, all-to-all
    per-destination expansion) are spread across sub-threads by greedy
    interval partitioning so complete (``X``) events never overlap
    within a thread;
  * pid 2 ``predicted``: the :class:`~repro.core.cost_model
    .ScheduleEstimate` timelines (``leg_timeline``), one thread set per
    tenant, replicated per round at the predicted period — the price
    rendered as a schedule, side by side with what the simulator did;
  * pid 3 ``pools``: counter (``C``) tracks from the arbiters' recorded
    allocation traces — total granted lanes per lane group (the Ethernet
    pool and each declared path's pool) and the memory pool's total
    granted B/s.  Counter maxima equal ``SimResult.peak_pool_lanes`` /
    ``peak_mem_bw`` exactly.

Timestamps are microseconds (the format's unit); all events carry
``pid``/``tid``/``ts`` and ``X`` events a nonnegative ``dur``.

A copy of ``repro.obs.trace`` for the port (the port imports nothing of
``repro``): only its imports differ.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.cost_model import ScheduleEstimate
from repro_torch.sim.fabric_sim import COMPUTE, SimResult, Tenant, leg_label

_US = 1e6

PID_SIM = 1
PID_PREDICTED = 2
PID_POOLS = 3


def _partition_lanes(intervals: Sequence[Tuple[float, float, object]],
                     eps: float = 1e-15) -> List[List[object]]:
    """Greedy interval partitioning: assign each (start, finish, item) to
    the first lane whose previous item finished by its start — minimal
    lane count for sorted input, stable within a lane."""
    lanes: List[List[object]] = []
    tails: List[float] = []
    for start, finish, item in sorted(intervals,
                                      key=lambda iv: (iv[0], iv[1])):
        for i, tail in enumerate(tails):
            if start >= tail - eps:
                lanes[i].append(item)
                tails[i] = finish
                break
        else:
            lanes.append([item])
            tails.append(finish)
    return lanes


def _meta(pid: int, tid: Optional[int], name: str) -> dict:
    ev = {"ph": "M", "pid": pid,
          "name": "process_name" if tid is None else "thread_name",
          "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _x(pid: int, tid: int, name: str, start: float, finish: float,
       cat: str, **args) -> dict:
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "cat": cat,
            "ts": start * _US, "dur": max(finish - start, 0.0) * _US,
            "args": args}


def to_chrome_trace(result: SimResult,
                    estimates: Optional[Mapping[str, ScheduleEstimate]]
                    = None,
                    tenants: Optional[Sequence[Tenant]] = None,
                    max_tracks: int = 32,
                    fleet_lanes: int = 8) -> dict:
    """Render ``result`` (and, when given, per-tenant predicted
    ``estimates``) as a Chrome-trace dict; see the module docstring for
    the track layout.  ``tenants`` (the ``simulate`` inputs) add the
    predicted compute phases, start offsets and per-round replication —
    without them each estimate renders once at t=0.

    Fleet-scale hygiene: above ``max_tracks`` tenants, only the first
    ``max_tracks`` (sorted by name) get their own thread rows; the rest
    collapse into shared ``fleet +K`` threads (greedy interval
    partitioning, at most ``fleet_lanes`` of them — events that do not
    fit are counted in the last thread's name rather than rendered) plus
    one ``active tenants`` counter track, so a 1000-session serving sim
    stays loadable and readable in Perfetto instead of producing
    thousands of rows.  Predicted tracks render for the shown tenants
    only."""
    events: List[dict] = []
    events.append(_meta(PID_SIM, None, "sim"))
    tenant_cfg: Dict[str, Tenant] = {t.name: t for t in (tenants or ())}
    names = sorted(result.finish)
    shown = names if len(names) <= max_tracks else names[:max_tracks]
    shown_set = set(shown)
    rest = names[len(shown):]

    # --- pid 1: simulated per-tenant tracks --------------------------------
    tid = 0
    for name in shown:
        evs = result.tenant_events(name)
        main = [e for e in evs if e.lanes <= 0]
        slow = [(e.start, e.finish, e) for e in evs if e.lanes > 0]
        events.append(_meta(PID_SIM, tid, name))
        for e in main:
            events.append(_x(PID_SIM, tid, leg_label(e.leg), e.start,
                             e.finish, "sim", round=e.round, chunk=e.chunk))
        tid += 1
        for k, lane in enumerate(_partition_lanes(slow)):
            suffix = " slow" if k == 0 else f" slow·{k + 1}"
            events.append(_meta(PID_SIM, tid, name + suffix))
            for e in lane:
                events.append(_x(PID_SIM, tid, leg_label(e.leg), e.start,
                                 e.finish, "sim", round=e.round,
                                 chunk=e.chunk, lanes=round(e.lanes, 6)))
            tid += 1

    # --- pid 1 tail: collapsed fleet threads + active-tenant counter -------
    if rest:
        rest_set = set(rest)
        rest_ev = [(e.start, e.finish, e) for e in result.events
                   if e.tenant in rest_set]
        lanes = _partition_lanes(rest_ev)
        elided = sum(len(lane) for lane in lanes[fleet_lanes:])
        for k, lane in enumerate(lanes[:fleet_lanes]):
            label = f"fleet +{len(rest)}·{k + 1}"
            if elided and k == min(len(lanes), fleet_lanes) - 1:
                label += f" ({elided} events elided)"
            events.append(_meta(PID_SIM, tid, label))
            for e in lane:
                events.append(_x(PID_SIM, tid,
                                 f"{e.tenant}:{leg_label(e.leg)}",
                                 e.start, e.finish, "sim", round=e.round,
                                 chunk=e.chunk, lanes=round(e.lanes, 6)))
            tid += 1
        # concurrently-busy tenant count over ALL tenants: the fleet's
        # admission/occupancy curve, readable at any scale
        marks: List[Tuple[float, int]] = []
        span: Dict[str, Tuple[float, float]] = {}
        for e in result.events:
            s, f = span.get(e.tenant, (e.start, e.finish))
            span[e.tenant] = (min(s, e.start), max(f, e.finish))
        for s, f in span.values():
            marks.append((s, 1))
            marks.append((f, -1))
        marks.sort()
        events.append(_meta(PID_SIM, tid, "active tenants"))
        level = 0
        for t, d in marks:
            level += d
            events.append({"ph": "C", "pid": PID_SIM, "tid": tid,
                           "name": "active tenants", "ts": t * _US,
                           "args": {"tenants": level}})
        tid += 1

    # --- pid 2: predicted tracks -------------------------------------------
    if estimates:
        events.append(_meta(PID_PREDICTED, None, "predicted"))
        for name in sorted(estimates):
            if name not in shown_set:
                continue
            est = estimates[name]
            if est is None:
                continue
            cfg = tenant_cfg.get(name)
            rounds = max(cfg.rounds, 1) if cfg is not None else 1
            compute_s = cfg.compute_s if cfg is not None else 0.0
            t0 = cfg.start if cfg is not None else 0.0
            period = compute_s + est.total_s
            timeline = est.leg_timeline()
            intervals: List[Tuple[float, float, tuple]] = []
            for r in range(rounds):
                base = t0 + r * period
                if compute_s > 0:
                    intervals.append((base, base + compute_s,
                                      (COMPUTE, base, base + compute_s,
                                       r, -1)))
                base += compute_s
                for pl in timeline:
                    intervals.append(
                        (base + pl.start, base + pl.finish,
                         (pl.leg, base + pl.start, base + pl.finish,
                          r, pl.chunk)))
            for k, lane in enumerate(_partition_lanes(intervals)):
                suffix = "" if k == 0 else f"·{k + 1}"
                events.append(_meta(PID_PREDICTED, tid,
                                    f"{name} predicted{suffix}"))
                for leg, s, f, r, chunk in lane:
                    events.append(_x(PID_PREDICTED, tid, leg_label(leg),
                                     s, f, "predicted", round=r,
                                     chunk=chunk))
                tid += 1

    # --- pid 3: pool counter tracks ----------------------------------------
    events.append(_meta(PID_POOLS, None, "pools"))
    pools = [("eth lanes", "lanes", result.pool)]
    pools += [(f"{p} lanes", "lanes", pl)
              for p, pl in sorted(result.path_pools.items())]
    if result.mem is not None:
        pools.append(("mem bw (B/s)", "bw", result.mem))
    ctid = 0
    for track, series, pool in pools:
        events.append(_meta(PID_POOLS, ctid, track))
        for t, v in pool.counter_series():
            events.append({"ph": "C", "pid": PID_POOLS, "tid": ctid,
                           "name": track, "ts": t * _US,
                           "args": {series: v}})
        ctid += 1
        # a pool that LOST capacity mid-run gets a second counter track
        # stepping through its capacity_steps, so the degraded interval
        # is visible right under the granted-allocation curve
        steps = getattr(pool, "capacity_steps", None)
        if steps and len(steps) > 1:
            cap_track = track.replace("lanes", "capacity (lanes)") \
                .replace("bw (B/s)", "capacity (B/s)")
            events.append(_meta(PID_POOLS, ctid, cap_track))
            for t, v in steps:
                events.append({"ph": "C", "pid": PID_POOLS, "tid": ctid,
                               "name": cap_track, "ts": t * _US,
                               "args": {series: v}})
            ctid += 1

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(trace: dict, path: str) -> str:
    """Write a ``to_chrome_trace`` dict as ``.trace.json`` (parent
    directories created); returns the path."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
