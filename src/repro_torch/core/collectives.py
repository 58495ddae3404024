"""DFabric collectives — the executor that lowers a :class:`CommSchedule`
to ``torch.distributed`` collectives; the port of ``repro.core.collectives``.

Every function runs on each member of the DP domain, with axis names
resolved against the mesh bound by ``prims.bind``.  The fast side of the
domain is an ORDERED tuple of axes, fastest first (e.g. ``("data",
"host")``); the slowest tier (``slow_axis``, "pod") is where the NIC pool
stripes.  ``repro.core.schedule`` (copied here) builds the typed leg list
once; this module only lowers legs:

  * sequential lowering walks the legs in order — reduce-scatter down, slow
    chunks, all-gather up;
  * **pipelined** lowering (``CommSchedule.pipelined``) splits the tensor
    into ``chunks`` along the scatter dim and software-pipelines the slow
    leg: chunk *i*'s slow-tier collective is issued with ``async_op=True``
    BEFORE chunk *i−1* runs its fast-tier all-gathers, so the slow leg is
    really in flight while the fast tiers gather (in the JAX package
    XLA's async scheduler decides).  ``psum(x) == concat(psum(chunk_i))``.

Codec / chunking apply to the slowest leg (int8 with error feedback, or
top-k with error feedback, which never chunks); an optional ``mid_codec``
compresses mid-tier legs, unscattered psums and scattered reduce-scatters
alike, as int8 without error feedback.  The int8 encode is the quantize
kernel (K2) on CUDA tensors.  ``lower_all_to_all`` walks ``kind=
"all_to_all"`` schedules (shuffle / MoE dispatch traffic, one tier's own
sub-index a stage) and ``ring_all_reduce`` is the explicit ring on
``prims.ppermute``.
"""
from __future__ import annotations

import math
from dataclasses import replace as _dc_replace
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import compression as comp
from repro_torch.core import prims
from repro_torch.core.prims import axis_size
from repro_torch.core.schedule import (AllToAll, CommSchedule, Psum,
                                       ReduceScatter, SlowChunk, SyncConfig,
                                       all_to_all_from_axes,
                                       schedule_from_axes)

__all__ = [
    "SyncConfig", "dfabric_all_reduce", "dfabric_reduce_scatter",
    "dfabric_all_gather", "dfabric_all_to_all", "pod_psum",
    "lower_all_reduce", "lower_all_to_all", "lower_reduce_scatter",
    "ring_all_reduce", "normalize_axes", "fast_axes_size",
]

Axes = Union[str, Sequence[str]]


# ---------------------------------------------------------------------------
# Axis helpers
# ---------------------------------------------------------------------------


def normalize_axes(fast_axis: Optional[Axes]) -> Tuple[str, ...]:
    """A single axis name or an ordered sequence -> tuple, fastest first."""
    if fast_axis is None:
        return ()
    if isinstance(fast_axis, str):
        return (fast_axis,)
    return tuple(fast_axis)


def fast_axes_size(fast_axis: Optional[Axes]) -> int:
    n = 1
    for a in normalize_axes(fast_axis):
        n *= axis_size(a)
    return n


def _split_chunks(x: torch.Tensor, chunks: int) -> Sequence[torch.Tensor]:
    if chunks <= 1:
        return [x]
    n = x.shape[0]
    assert n % chunks == 0, (n, chunks)
    return list(x.reshape(chunks, n // chunks).unbind(0))


def _trace_schedule(fast: Tuple[str, ...], slow_axis: Optional[str],
                    cfg: SyncConfig, shape: Tuple[int, ...],
                    scatter_dim: int, lane_offset: int = 0,
                    staging: Optional[str] = None) -> CommSchedule:
    """Build a schedule from live axis sizes (the legacy entry points'
    constructor path), keeping the planner's ``lane_offset`` and
    ``staging``."""
    sizes = {a: axis_size(a) for a in fast}
    if slow_axis is not None:
        sizes[slow_axis] = axis_size(slow_axis)
    s = schedule_from_axes(fast, slow_axis, cfg, tuple(shape), scatter_dim,
                           sizes)
    if lane_offset:
        s = s.with_lane_offset(lane_offset)
    if staging is not None:
        s = s.with_staging(staging)
    return s


def _schedule_usable(schedule: Optional[CommSchedule], x: torch.Tensor,
                     fast: Tuple[str, ...], slow_axis: Optional[str]) -> bool:
    """A planner-built schedule is trusted only when it describes exactly
    this operand (shape) and these mesh axes."""
    if schedule is None:
        return False
    if tuple(schedule.shape) != tuple(x.shape):
        return False
    avail = set(fast) | ({slow_axis} if slow_axis else set())
    return set(schedule.axes) <= avail


# ---------------------------------------------------------------------------
# Leg lowering
# ---------------------------------------------------------------------------


class _PlainSlow:
    """A slow sub-flow in flight with no codec, or one already finished
    (top-k; the int8 one is ``compression.PendingInt8Psum``); ``finish()``
    -> (sum, EF)."""

    def __init__(self, pending: prims.Pending, ef: Optional[torch.Tensor]):
        self.pending, self.ef = pending, ef

    def finish(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.pending.wait(), self.ef


def _issue_slow(leg: SlowChunk, x_flat: torch.Tensor,
                ef_flat: Optional[torch.Tensor], cfg: SyncConfig):
    """Issue ONE slow-tier sub-flow (the only leg kind where the Section
    codec runs) without waiting for it; ``finish()`` on the result waits."""
    if leg.codec is None:
        return _PlainSlow(prims.psum_async(x_flat, leg.axis), ef_flat)
    assert leg.codec == cfg.codec, (leg.codec, cfg.codec)
    codec = cfg.make_codec()
    if isinstance(codec, comp.Int8Codec):
        return comp.issue_psum_int8(x_flat, leg.axis, codec, ef_flat)
    if isinstance(codec, comp.TopKCodec):  # never chunked: done at once
        out, new_ef = comp.compressed_psum_topk(x_flat, leg.axis, codec,
                                                ef_flat)
        return _PlainSlow(prims.Pending(out), new_ef)
    raise ValueError(leg.codec)


def _slow_chunk_psum(leg: SlowChunk, x_flat: torch.Tensor,
                     ef_flat: Optional[torch.Tensor], cfg: SyncConfig
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Lower ONE slow-tier sub-flow to completion."""
    return _issue_slow(leg, x_flat, ef_flat, cfg).finish()


def _psum_leg(leg: Psum, x: torch.Tensor, cfg: SyncConfig) -> torch.Tensor:
    """Lower one unscattered (mid-tier / flat) psum leg."""
    if leg.codec is None:
        return prims.psum(x, leg.axis)
    # the mid-tier codec: int8 without error feedback (the EF state belongs
    # to the slow leg)
    assert leg.codec == cfg.mid_codec, (leg.codec, cfg.mid_codec)
    out, _ = comp.compressed_psum_int8(x.reshape(-1), leg.axis,
                                       cfg.make_mid_codec(), None)
    return out.reshape(x.shape)


def _rs_leg(leg: ReduceScatter, x: torch.Tensor, dim: int,
            cfg: SyncConfig) -> torch.Tensor:
    """Lower one fast-tier reduce-scatter leg (a scattered mid-tier leg may
    carry the mid codec: int8 without error feedback, like mid psums)."""
    if leg.codec is None:
        return prims.reduce_scatter_tiled(x, leg.axis, dim)
    assert leg.codec == cfg.mid_codec, (leg.codec, cfg.mid_codec)
    return comp.compressed_reduce_scatter_int8(x, leg.axis,
                                               cfg.make_mid_codec(), dim)


def _slow_group(legs: Sequence[SlowChunk], x: torch.Tensor,
                ef: Optional[torch.Tensor], cfg: SyncConfig
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sequentially lower a contiguous run of slow chunks over the
    flattened shard (the non-pipelined slow leg).  Legs arrive in ISSUE
    order (rotated by the schedule's ``lane_offset``); the payload is split
    and reassembled by ``SlowChunk.index``."""
    shp = x.shape
    xf = x.reshape(-1)
    ef_f = ef.reshape(-1) if ef is not None else None
    C = len(legs)
    parts = _split_chunks(xf, C)
    ef_parts = _split_chunks(ef_f, C) if ef_f is not None else [None] * C
    outs: List = [None] * C
    nefs: List = [None] * C
    for leg in legs:
        o, ne = _slow_chunk_psum(leg, parts[leg.index], ef_parts[leg.index],
                                 cfg)
        outs[leg.index] = o
        nefs[leg.index] = ne
    out = torch.cat(outs) if C > 1 else outs[0]
    if ef is not None:
        nef = (torch.cat(nefs) if C > 1 else nefs[0]).reshape(ef.shape)
    else:
        nef = None
    return out.reshape(shp), nef


def _apply_down(legs: Sequence, x: torch.Tensor, dim: int, cfg: SyncConfig,
                log: Optional[List]) -> torch.Tensor:
    """Lower the down phase (ReduceScatter / Psum legs), coalescing runs of
    codec-less psums into one ``psum`` call."""
    pend: List[Psum] = []

    def flush():
        nonlocal x
        if pend:
            x = prims.psum(x, tuple(l.axis for l in pend))
            if log is not None:
                log.extend(pend)
            pend.clear()

    for leg in legs:
        if isinstance(leg, Psum) and leg.codec is None:
            pend.append(leg)
            continue
        flush()
        if isinstance(leg, ReduceScatter):
            x = _rs_leg(leg, x, dim, cfg)
        elif isinstance(leg, Psum):
            x = _psum_leg(leg, x, cfg)
        else:
            raise TypeError(leg)
        if log is not None:
            log.append(leg)
    flush()
    return x


def _lower_sequential(schedule: CommSchedule, x: torch.Tensor,
                      ef: Optional[torch.Tensor], log: Optional[List], *,
                      gather_up: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    dim = max(schedule.scatter_dim, 0)
    cfg = schedule.cfg
    x = _apply_down(schedule.down_legs, x, dim, cfg, log)
    slow = schedule.slow_legs
    if slow:
        x, ef = _slow_group(slow, x, ef, cfg)
        if log is not None:
            log.extend(slow)
    if gather_up:
        for leg in schedule.up_legs:
            x = prims.all_gather_tiled(x, leg.axis, dim)
            if log is not None:
                log.append(leg)
    return x, ef


def _lower_pipelined(schedule: CommSchedule, x: torch.Tensor,
                     ef: Optional[torch.Tensor], log: Optional[List]
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The overlapped slow-leg pipeline.

    The tensor is split into ``chunks`` along the scatter dim BEFORE the
    fast-tier reduce-scatters.  Chunk *i*'s slow-tier collective is issued
    asynchronously, THEN chunk *i−1* waits for its own slow leg and runs its
    fast-tier all-gathers while chunk *i*'s is on the wire.  Error-feedback
    slice *i* pairs with chunk *i*, as in the JAX package."""
    dim = schedule.scatter_dim
    cfg = schedule.cfg
    C = schedule.chunks
    down, slow, up = schedule.down_legs, schedule.slow_legs, schedule.up_legs
    assert len(slow) == C, (len(slow), C)
    blk = x.shape[dim] // C
    parts = [x.narrow(dim, i * blk, blk) for i in range(C)]
    if ef is not None:
        ef_parts = _split_chunks(ef.reshape(-1), C)
    else:
        ef_parts = [None] * C

    down_log: List = [] if log is not None else None
    slow_log: List = [] if log is not None else None
    up_log: List = [] if log is not None else None

    shards = [_apply_down(down, p, dim, cfg, down_log if i == 0 else None)
              for i, p in enumerate(parts)]
    shard_shape = shards[0].shape

    def issue_slow(pos: int):
        # legs are in ISSUE order; the leg's index picks the data chunk
        leg = slow[pos]
        inflight = _issue_slow(leg, shards[leg.index].reshape(-1),
                               ef_parts[leg.index], cfg)
        if slow_log is not None:
            slow_log.append(leg)
        return leg.index, inflight

    def gather(inflight, lg):
        buf, buf_ef = inflight.finish()
        y = buf.reshape(shard_shape)
        for leg in up:
            y = prims.all_gather_tiled(y, leg.axis, dim)
            if lg is not None:
                lg.append(leg)
        return y, buf_ef

    outs: List[Optional[torch.Tensor]] = [None] * C
    nefs: List[Optional[torch.Tensor]] = [None] * C
    prev = issue_slow(0)
    for pos in range(1, C):
        nxt = issue_slow(pos)        # this sub-flow crosses the slow tier
        idx, inflight = prev         # ... while the previous one gathers
        outs[idx], nefs[idx] = gather(inflight, up_log if pos == 1 else None)
        prev = nxt
    idx, inflight = prev
    outs[idx], nefs[idx] = gather(inflight, up_log if C == 1 else None)

    if log is not None:
        log.extend(down_log + slow_log + up_log)
    out = torch.cat(outs, dim=dim)
    nef = None
    if ef is not None:
        nef = torch.cat(nefs).reshape(ef.shape)
    return out, nef


def lower_all_reduce(schedule: CommSchedule, x: torch.Tensor,
                     ef: Optional[torch.Tensor] = None,
                     leg_log: Optional[List] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Lower a full all-reduce schedule.  ``leg_log``, when given, receives
    the legs actually lowered, in schedule order (the contract: it equals
    the leg list ``CostModel.from_schedule`` prices)."""
    if schedule.kind != "all_reduce":
        raise ValueError(
            f"lower_all_reduce needs an all_reduce schedule, got "
            f"kind={schedule.kind!r} (use lower_all_to_all)")
    if not schedule.legs:
        return x, ef
    if schedule.pipelined and schedule.chunks > 1:
        return _lower_pipelined(schedule, x, ef, leg_log)
    return _lower_sequential(schedule, x, ef, leg_log)


def lower_reduce_scatter(schedule: CommSchedule, x: torch.Tensor,
                         ef: Optional[torch.Tensor] = None,
                         leg_log: Optional[List] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Lower only the down half of a schedule (fast-tier reduce-scatters +
    slow leg), leaving the caller owning its 1/prod(fast sizes) shard — the
    ZeRO-1 entry point."""
    assert schedule.strategy == "hier_striped", schedule.strategy
    assert not any(isinstance(l, Psum) for l in schedule.down_legs), \
        "ZeRO-1 sections must scatter every fast tier"
    return _lower_sequential(schedule, x, ef, leg_log, gather_up=False)


# ---------------------------------------------------------------------------
# Legacy entry points — thin constructors over the IR
# ---------------------------------------------------------------------------


def pod_psum(x: torch.Tensor, slow_axis: Optional[str], cfg: SyncConfig,
             ef: Optional[torch.Tensor] = None, lane_offset: int = 0
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """All-reduce ``x`` (this member's fast-tier-scattered shard) over the
    slowest axis — the bare NIC-pool leg.  ``cfg.chunks`` splits it into
    sub-flows; the codec (if any) runs here and only here."""
    if slow_axis is None or axis_size(slow_axis) == 1:
        return x, ef
    n = axis_size(slow_axis)
    chunks = max(cfg.chunks, 1) if cfg.codec != "topk" else 1
    while chunks > 1 and x.shape[0] % chunks != 0:
        chunks -= 1
    legs = [SlowChunk((j + lane_offset) % chunks, chunks, cfg.codec,
                      slow_axis, slow_axis, n) for j in range(chunks)]
    return _slow_group(legs, x, ef, cfg)


def dfabric_all_reduce(x: torch.Tensor, fast_axis: Optional[Axes],
                       slow_axis: Optional[str],
                       cfg: SyncConfig, scatter_dim: int = 0,
                       ef: Optional[torch.Tensor] = None,
                       schedule: Optional[CommSchedule] = None,
                       leg_log: Optional[List] = None,
                       lane_offset: int = 0,
                       staging: Optional[str] = None,
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """All-reduce ``x`` over (fast tiers x slow tier) with the DFabric
    plan; ``schedule`` is the planner's when it describes this operand,
    else one is built from ``cfg``."""
    fast = normalize_axes(fast_axis)
    if not _schedule_usable(schedule, x, fast, slow_axis):
        schedule = _trace_schedule(fast, slow_axis, cfg, x.shape, scatter_dim,
                                   lane_offset, staging)
    return lower_all_reduce(schedule, x, ef=ef, leg_log=leg_log)


def dfabric_reduce_scatter(x: torch.Tensor, fast_axis: Axes,
                           slow_axis: Optional[str],
                           cfg: SyncConfig, scatter_dim: int = 0,
                           ef: Optional[torch.Tensor] = None,
                           schedule: Optional[CommSchedule] = None,
                           leg_log: Optional[List] = None,
                           lane_offset: int = 0,
                           staging: Optional[str] = None):
    """Like :func:`dfabric_all_reduce` but stops before the final fast-tier
    all-gathers — the caller owns the 1/prod(fast sizes) shard, indexed
    fastest-tier-major (ZeRO-1 entry point)."""
    fast = normalize_axes(fast_axis)
    nf = fast_axes_size(fast)
    assert x.shape[scatter_dim] % nf == 0, (x.shape, scatter_dim, nf)
    if not _schedule_usable(schedule, x, fast, slow_axis) \
            or schedule.strategy != "hier_striped" \
            or any(isinstance(l, Psum) for l in schedule.down_legs):
        full = _dc_replace(cfg, scatter_depth=-1)
        schedule = _trace_schedule(fast, slow_axis, full, x.shape,
                                   scatter_dim, lane_offset, staging)
    return lower_reduce_scatter(schedule, x, ef=ef, leg_log=leg_log)


def dfabric_all_gather(x: torch.Tensor, fast_axis: Axes,
                       gather_dim: int = 0) -> torch.Tensor:
    """All-gather over the fast tiers, undoing
    :func:`dfabric_reduce_scatter`'s ownership order (gathers run in
    reverse tier order so the fastest tier ends up major)."""
    fast = normalize_axes(fast_axis)
    for a in reversed(fast):
        if axis_size(a) > 1:
            x = prims.all_gather_tiled(x, a, gather_dim)
    return x


# ---------------------------------------------------------------------------
# Multi-stage hierarchical all-to-all (the NIC pool applied to MoE dispatch /
# shuffle traffic)
# ---------------------------------------------------------------------------


def lower_all_to_all(schedule: CommSchedule, x: torch.Tensor,
                     leg_log: Optional[List] = None) -> torch.Tensor:
    """Lower a ``kind="all_to_all"`` schedule.

    ``x``: (n_total, ...): row r holds the payload for member r of the DP
    domain, rows ordered slow-major.  Each tier exchanges its OWN
    sub-index, fastest tier first, so a stripe crossing the slow tier is
    one contiguous block; the result equals one flat all-to-all over the
    joint (slowest, ..., fastest) domain, bit for bit.  The slow tier's
    exchange runs as the schedule's ``SlowChunk`` sub-flows, each an equal
    slice of every destination's payload, issued in leg order and
    reassembled by ``SlowChunk.index``.  ``leg_log`` receives the legs
    lowered, in schedule order."""
    if schedule.kind != "all_to_all":
        raise ValueError(
            f"lower_all_to_all needs an all_to_all schedule, got "
            f"kind={schedule.kind!r}")
    fast_legs = [l for l in schedule.legs if isinstance(l, AllToAll)]
    slow = schedule.slow_legs
    active = [(l.axis, l.size) for l in fast_legs]
    if slow:
        active.append((slow[0].axis, slow[0].size))
    if not active:
        return x
    sizes = [n for _, n in active]
    n_total = math.prod(sizes)
    assert x.shape[0] == n_total, (x.shape, sizes)
    rest = tuple(x.shape[1:])
    # the leading dim viewed slow-major: dims ordered (slowest, ..., fastest)
    y = x.reshape(tuple(reversed(sizes)) + rest)
    k = len(active)
    for i, leg in enumerate(fast_legs):  # fastest tier first
        y = prims.all_to_all_tiled(y, leg.axis, k - 1 - i)
        if leg_log is not None:
            leg_log.append(leg)
    if slow:
        C = len(slow)
        yshape = y.shape
        yf = y.reshape(slow[0].size, -1)
        blk = yf.shape[1] // C
        outs: List[Optional[torch.Tensor]] = [None] * C
        for leg in slow:  # in issue order; the payload slice picked by index
            part = yf.narrow(1, leg.index * blk, blk)
            outs[leg.index] = prims.all_to_all_tiled(part, leg.axis, 0)
            if leg_log is not None:
                leg_log.append(leg)
        yf = torch.cat(outs, dim=1) if C > 1 else outs[0]
        y = yf.reshape(yshape)
    return y.reshape((n_total,) + rest)


def dfabric_all_to_all(x: torch.Tensor, fast_axis: Axes,
                       slow_axis: Optional[str],
                       cfg: Optional[SyncConfig] = None,
                       schedule: Optional[CommSchedule] = None,
                       leg_log: Optional[List] = None,
                       lane_offset: int = 0,
                       staging: Optional[str] = None) -> torch.Tensor:
    """All-to-all over the (fast tiers x slow tier) DP domain, one stage a
    tier (see :func:`lower_all_to_all`).  ``schedule`` is the planner's
    (``Planner.plan_all_to_all``) when it describes this operand, else one
    is built from ``cfg`` (default: one slow sub-flow) and the live axis
    sizes, keeping ``lane_offset`` and ``staging``."""
    if schedule is not None and schedule.kind != "all_to_all":
        raise ValueError(
            f"dfabric_all_to_all needs an all_to_all schedule, got "
            f"kind={schedule.kind!r}")
    fast = normalize_axes(fast_axis)
    if not _schedule_usable(schedule, x, fast, slow_axis):
        sizes = {a: axis_size(a) for a in fast}
        if slow_axis is not None:
            sizes[slow_axis] = axis_size(slow_axis)
        schedule = all_to_all_from_axes(fast, slow_axis, cfg or SyncConfig(),
                                        tuple(x.shape), sizes)
        if lane_offset:
            schedule = schedule.with_lane_offset(lane_offset)
        if staging is not None:
            schedule = schedule.with_staging(staging)
    return lower_all_to_all(schedule, x, leg_log=leg_log)


# ---------------------------------------------------------------------------
# Explicit ring all-reduce on ppermute
# ---------------------------------------------------------------------------


def ring_all_reduce(x: torch.Tensor, axis_name: str, n: int) -> torch.Tensor:
    """Bandwidth-optimal ring all-reduce on ``prims.ppermute``: n − 1
    reduce-scatter steps, then n − 1 all-gather steps, one 1/n chunk a
    step.  ``n`` is the size of ``axis_name``; ``x.shape[0]`` must divide
    by it.  Equals ``prims.psum`` up to the order of the adds."""
    if n == 1:
        return x
    assert x.shape[0] % n == 0, (x.shape, n)
    idx = prims.axis_rank(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = x.reshape(n, -1).clone()
    # reduce-scatter: at step k this member sends chunk (idx - k) mod n;
    # after n - 1 steps it owns the whole sum of chunk (idx + 1) mod n
    buf = acc[idx % n]
    for k in range(n - 1):
        recv = prims.ppermute(buf, axis_name, perm)
        jr = (idx - k - 1) % n
        acc[jr] += recv
        buf = acc[jr]
    # all-gather
    own = (idx + 1) % n
    out = acc.clone()
    buf = acc[own]
    for k in range(n - 1):
        recv = prims.ppermute(buf, axis_name, perm)
        out[(own - k - 1) % n] = recv
        buf = recv
    return out.reshape(x.shape)
