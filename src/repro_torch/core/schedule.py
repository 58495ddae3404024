"""CommSchedule — the one IR behind DFabric's hierarchical collectives.

Before this module existed the tier walk (reduce-scatter down the fast
tiers, striped slow leg, all-gather back up) was re-encoded three separate
times: ``collectives.py`` executed it, ``cost_model.py`` priced it, and
``planner.py`` searched it — and the three copies drifted (the cost model
credited an overlapped chunk pipeline the runtime never delivered).

Now there is exactly one description: a :class:`CommSchedule` is a typed
list of **legs** built once from ``(FabricSpec, SyncConfig, shape)``:

  * ``ReduceScatter(tier)`` — scatter one fast tier (down phase),
  * ``Psum(tier)``          — sum a tier in place (unscattered fast tier,
                              or one leg of a flat plan); may carry a
                              mid-tier codec,
  * ``SlowChunk(i, codec)`` — one sub-flow of the slowest (NIC-pool) leg,
  * ``AllGather(tier)``     — gather one fast tier back (up phase),
  * ``AllToAll(tier)``      — exchange one tier's own sub-index (one stage
                              of a hierarchical all-to-all; only appears
                              in ``kind="all_to_all"`` schedules).

A schedule has a ``kind``: ``"all_reduce"`` (the gradient-sync walk above)
or ``"all_to_all"`` (the §6.2 shuffle / MoE-dispatch exchange built by
:func:`build_all_to_all` — ``AllToAll`` stages down the fast tiers, the
slow tier's exchange chunked into ``SlowChunk`` sub-flows that carry
``lane_offset`` / ``staging`` exactly like the all-reduce slow leg).

Three consumers walk the SAME leg list:

  * ``collectives.lower_all_reduce`` lowers it to JAX ops (and, when
    ``pipelined``, software-pipelines slow chunk *i* against chunk *i−1*'s
    fast-tier all-gathers),
  * ``CostModel.from_schedule`` prices exactly those legs,
  * ``Planner`` searches over candidate schedules (depth x chunks x
    per-tier codec) and stores the winner on each ``Section``.

The builder owns ALL divisibility decisions (which tiers scatter, how many
chunks survive), so the executor and the cost model never re-derive them.

``SyncConfig`` lives here (re-exported from ``repro.core.collectives`` for
the legacy import path) and the legacy entry points are thin constructors
over :func:`build_schedule`.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core import compression as comp
from repro_torch.core.topology import FabricSpec, SLOW_PATHS, Tier

# ---------------------------------------------------------------------------
# SyncConfig (the per-Section knob set; thin constructor over the IR)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SyncConfig:
    """How one gradient bucket ("Section") is synchronized.

    ``scatter_depth``: number of fast tiers to reduce-scatter over before
    the slowest leg (-1 = all of them).  Fast tiers beyond the depth are
    summed in place (plain psum) instead of scattered — the planner picks
    the depth per section from the cost model (e.g. a tensor divisible by
    the ICI size but not by ICI*CXL scatters only one level deep).

    ``pipeline``: when chunks > 1, software-pipeline the slow leg against
    the fast-tier all-gathers (chunk *i*'s slow psum is issued while chunk
    *i−1* gathers).  ``mid_codec``: optional int8 codec on mid-tier legs —
    UNSCATTERED psums AND mid-tier reduce-scatters (any fast tier past the
    fastest; deep hierarchies where a full or striped payload crosses a
    mid tier).

    ``path_split``: optional multi-path routing of the slow sub-flows,
    ``((path_name, fraction), ...)`` for the NON-eth routes (see
    ``repro.core.topology.PathSpec``); the Ethernet pool keeps the
    remaining fraction.  ``None`` (or all-zero fractions) is the
    eth-only degenerate: exactly today's single-path schedules.
    """

    strategy: str = "hier_striped"  # flat | hier_root | hier_striped
    chunks: int = 1  # slow-tier sub-flows per Section (MPTCP analogue)
    codec: Optional[str] = None  # None | "int8" | "topk"
    codec_block: int = 2048
    codec_k_frac: float = 0.0625
    error_feedback: bool = True
    scatter_depth: int = -1  # fast tiers to scatter over (-1 = all)
    pipeline: bool = True  # overlap slow chunks with fast all-gathers
    mid_codec: Optional[str] = None  # codec on mid-tier (psum + rs) legs
    path_split: Optional[Tuple[Tuple[str, float], ...]] = None

    def __post_init__(self):
        if self.path_split is None:
            return
        # canonicalize (JSON hands back lists) so round-tripped configs
        # compare equal, then validate the split
        ps = tuple((str(n), float(f)) for n, f in self.path_split)
        object.__setattr__(self, "path_split", ps)
        total = 0.0
        for name, frac in ps:
            if name == "eth" or name not in SLOW_PATHS:
                raise ValueError(
                    f"path_split names the non-eth routes "
                    f"{[n for n in SLOW_PATHS if n != 'eth']}; got {name!r}")
            if not 0.0 <= frac <= 1.0:
                raise ValueError(f"path_split fraction for {name!r} "
                                 f"must be in [0, 1]: {frac}")
            total += frac
        if total > 1.0 + 1e-12:
            raise ValueError(f"path_split fractions sum to {total} > 1")

    def make_codec(self):
        return comp.make_codec(self.codec, block=self.codec_block,
                               k_frac=self.codec_k_frac)

    def make_mid_codec(self):
        return comp.make_codec(self.mid_codec, block=self.codec_block)


# ---------------------------------------------------------------------------
# Legs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ReduceScatter:
    """Reduce-scatter one fast tier (down phase).  ``codec`` is the
    optional mid-tier compressor (int8) on SCATTERED mid-tier legs: the
    wire payload is quantized, the reduction runs on dequantized values
    (no error-feedback state — mid tiers are stateless, like ``Psum``)."""

    tier: str  # Tier.name
    axis: str  # mesh axis
    size: int
    codec: Optional[str] = None

    kind = "reduce_scatter"


@dataclass(frozen=True)
class Psum:
    """Sum a tier in place — an unscattered fast tier, or one axis of a
    flat plan.  ``codec`` is the optional mid-tier compressor (int8)."""

    tier: str
    axis: str
    size: int
    codec: Optional[str] = None

    kind = "psum"


@dataclass(frozen=True)
class SlowChunk:
    """One sub-flow of the slowest (NIC-pool striped) leg.

    ``path`` is the ROUTE the sub-flow rides: ``"eth"`` (the slowest
    tier's own Ethernet pool lanes — the default, and the only route
    before multi-path), ``"cxl"`` (a CXL-fabric shortcut through an
    otherwise-idle fast-tier/expander route) or ``"loop"`` (loopback via
    a peer rack).  Routing is numerics-free: the executor splits and
    reassembles the payload by ``index`` regardless of path, so any
    split ratio lowers bitwise-identically; only pricing and the
    simulator's lane arbitration see the route.

    ``dest_sizes`` makes the sub-flow's per-destination traffic
    NON-UNIFORM: ``dest_sizes[r]`` is the wire bytes THIS sub-flow
    carries to slow-tier destination ``r`` (length ``size``, from a
    symmetric per-member profile — every member sends the same sizes,
    the MoE hot-expert / WordCount incast shape).  ``None`` (the
    default) keeps the uniform ``payload / (size * chunks)`` split and
    prices/simulates bitwise as before.  Like ``path`` it is
    numerics-free: the executed exchange stays the rectangular
    (capacity-padded) payload, only the cost model's incast bound and
    the simulator's per-destination flow sizes see the skew."""

    index: int
    chunks: int
    codec: Optional[str]
    tier: str
    axis: str
    size: int
    path: str = "eth"
    dest_sizes: Optional[Tuple[float, ...]] = None

    kind = "slow_chunk"

    def __post_init__(self):
        if self.dest_sizes is not None:
            object.__setattr__(self, "dest_sizes",
                               tuple(float(b) for b in self.dest_sizes))


@dataclass(frozen=True)
class AllGather:
    """All-gather one fast tier back (up phase, reverse scatter order)."""

    tier: str
    axis: str
    size: int

    kind = "all_gather"


@dataclass(frozen=True)
class AllToAll:
    """Exchange one tier's OWN sub-index — one stage of the hierarchical
    all-to-all (``kind="all_to_all"`` schedules only).  Stages run fastest
    tier first, so a stripe crossing a slower tier is one contiguous block
    and every member below carries its 1/members_below share; the local
    payload size never changes (an all-to-all is a permutation).

    ``dest_sizes[j]`` is the wire bytes this stage moves to the tier's
    own sub-index ``j`` (length ``size``; the per-member row sizes
    aggregated over this tier's digit — see ``all_to_all_from_axes``).
    ``None`` keeps the uniform ``payload / size`` split."""

    tier: str
    axis: str
    size: int
    dest_sizes: Optional[Tuple[float, ...]] = None

    kind = "all_to_all"

    def __post_init__(self):
        if self.dest_sizes is not None:
            object.__setattr__(self, "dest_sizes",
                               tuple(float(b) for b in self.dest_sizes))


Leg = Union[ReduceScatter, Psum, SlowChunk, AllGather, AllToAll]

_LEG_KINDS = {cls.kind: cls for cls in (ReduceScatter, Psum, SlowChunk,
                                        AllGather, AllToAll)}


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CommSchedule:
    """One Section's communication plan: an ordered leg list plus the
    static facts every consumer needs (local block shape, scatter dim,
    chunking, pipelining) and the originating :class:`SyncConfig` (codec
    parameters).

    Invariants the builder guarantees (consumers never re-check):
      * every ``ReduceScatter`` leg divides ``shape[scatter_dim]`` given
        the legs before it;
      * when ``pipelined``, ``shape[scatter_dim]`` is divisible by
        ``chunks * prod(scattered tier sizes)``;
      * ``SlowChunk`` legs are contiguous, between the down and up phases
        — listed in ISSUE order (sub-flow ``index`` rotated by
        ``lane_offset``), and every index in ``range(chunks)`` appears
        exactly once.

    ``lane_offset`` is the planner's NIC-pool stagger (see
    ``repro.core.nicpool.NicPool.stagger``): slow sub-flow *i* rides pool
    lane ``i mod lanes``, and rotating the issue order by the offset makes
    concurrent Sections' first sub-flows land on DIFFERENT lanes.  The
    executor lowers legs in listed (issue) order but splits/reassembles
    the payload by ``SlowChunk.index``, so the rotation is numerically
    free.

    ``staging`` is the planner's memory-pool placement for the slow leg's
    staging buffers: ``"local"`` (host DRAM channels only — lower access
    latency) or ``"pool"`` (interleaved across the fabric's memory
    devices — higher bandwidth, the expander's added latency).  ``None``
    means unplanned (priced as "pool" when a memory model is present).
    Like ``lane_offset`` it is numerics-free: the simulator and the cost
    model place the flow's memory traffic by it, the executor treats it
    as an annotation (JAX memory-kind offload is gated in
    ``repro.core.staging_utils``).

    ``kind`` selects the collective the legs describe: ``"all_reduce"``
    (lowered by ``collectives.lower_all_reduce``) or ``"all_to_all"``
    (``collectives.lower_all_to_all`` — ``shape[0]`` is the DP-domain row
    count, rows ordered slow-major, and ``SlowChunk`` legs split the
    per-destination payload instead of the reduced shard).
    """

    legs: Tuple[Leg, ...]
    shape: Tuple[int, ...]
    dtype: str = "float32"
    scatter_dim: int = 0
    chunks: int = 1
    pipelined: bool = False
    strategy: str = "hier_striped"
    cfg: SyncConfig = field(default_factory=SyncConfig)
    lane_offset: int = 0
    staging: Optional[str] = None
    kind: str = "all_reduce"

    def __post_init__(self):
        # validated HERE (not only in with_staging) so a hand-edited /
        # corrupted plan JSON fails at load, not at a distant pricing or
        # simulation call site
        if self.staging not in (None, "local", "pool"):
            raise ValueError(
                f"staging must be local|pool|None: {self.staging!r}")
        if self.kind not in ("all_reduce", "all_to_all"):
            raise ValueError(
                f"kind must be all_reduce|all_to_all: {self.kind!r}")
        if self.kind == "all_to_all" and self.pipelined:
            # no executor implements an overlapped all-to-all (there is
            # no fast up-phase to hide slow chunks behind), so a
            # pipelined flag here would make the cost model and the
            # simulator credit an overlap the lowering never delivers
            raise ValueError("all_to_all schedules cannot be pipelined")
        for l in self.legs:
            if isinstance(l, SlowChunk) and l.path not in SLOW_PATHS:
                raise ValueError(
                    f"slow chunk {l.index}: path must be one of "
                    f"{list(SLOW_PATHS)}: {l.path!r}")
            ds = getattr(l, "dest_sizes", None)
            if ds is not None:
                if self.kind != "all_to_all":
                    # a reduction has no per-destination rows — skewed
                    # sizes on an all-reduce leg would be priced as an
                    # exchange the executor never performs
                    raise ValueError(
                        "dest_sizes only apply to all_to_all schedules: "
                        f"{l.kind} leg carries {len(ds)} sizes on a "
                        f"kind={self.kind!r} schedule")
                if len(ds) != l.size:
                    raise ValueError(
                        f"{l.kind} leg needs one dest size per member: "
                        f"{len(ds)} sizes for size={l.size}")
                if any(b < 0 for b in ds) or max(ds) <= 0:
                    raise ValueError(
                        f"dest_sizes must be non-negative with a positive "
                        f"max: {ds}")

    # ---- structure ---------------------------------------------------------
    @property
    def down_legs(self) -> Tuple[Leg, ...]:
        return tuple(l for l in self.legs
                     if isinstance(l, (ReduceScatter, Psum)))

    @property
    def slow_legs(self) -> Tuple[SlowChunk, ...]:
        return tuple(l for l in self.legs if isinstance(l, SlowChunk))

    @property
    def up_legs(self) -> Tuple[AllGather, ...]:
        return tuple(l for l in self.legs if isinstance(l, AllGather))

    @property
    def scattered_axes(self) -> Tuple[str, ...]:
        return tuple(l.axis for l in self.legs if isinstance(l, ReduceScatter))

    @property
    def scattered_prod(self) -> int:
        n = 1
        for l in self.legs:
            if isinstance(l, ReduceScatter):
                n *= l.size
        return n

    @property
    def axes(self) -> Tuple[str, ...]:
        seen = []
        for l in self.legs:
            if l.axis not in seen:
                seen.append(l.axis)
        return tuple(seen)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def with_lane_offset(self, offset: int) -> "CommSchedule":
        """The NIC-pool stagger: rotate the slow sub-flow ISSUE order by
        ``offset`` (position ``j`` issues chunk ``(j + offset) % chunks``)
        and record the normalized offset.  Cost- and numerics-invariant:
        the same legs are lowered and priced, only their wire order (and
        hence which pool lane is hit first) changes."""
        slow = self.slow_legs
        C = len(slow)
        if C == 0:
            return replace(self, lane_offset=0)
        off = int(offset) % C
        if off == self.lane_offset and all(
                l.index == (j + off) % C for j, l in enumerate(slow)):
            return self
        by_index = {l.index: l for l in slow}
        rotated = [by_index[(j + off) % C] for j in range(C)]
        first = next(i for i, l in enumerate(self.legs)
                     if isinstance(l, SlowChunk))
        legs = (self.legs[:first] + tuple(rotated)
                + self.legs[first + C:])
        return replace(self, legs=legs, lane_offset=off)

    def with_staging(self, staging: Optional[str]) -> "CommSchedule":
        """The planner's memory-pool placement (see class docstring) —
        cost- and numerics-free relabeling, like ``with_lane_offset``.
        Values are validated by ``__post_init__``."""
        if staging == self.staging:
            return self
        return replace(self, staging=staging)

    def describe(self) -> str:
        parts = []
        for l in self.legs:
            if isinstance(l, ReduceScatter):
                c = f",{l.codec}" if l.codec else ""
                parts.append(f"rs[{l.axis}x{l.size}{c}]")
            elif isinstance(l, Psum):
                c = f",{l.codec}" if l.codec else ""
                parts.append(f"psum[{l.axis}x{l.size}{c}]")
            elif isinstance(l, SlowChunk):
                c = f",{l.codec}" if l.codec else ""
                p = f"@{l.path}" if l.path != "eth" else ""
                sk = "~" if l.dest_sizes is not None else ""
                parts.append(f"slow[{l.index}/{l.chunks}{c}{p}{sk}]")
            elif isinstance(l, AllToAll):
                sk = "~" if l.dest_sizes is not None else ""
                parts.append(f"a2a[{l.axis}x{l.size}{sk}]")
            else:
                parts.append(f"ag[{l.axis}x{l.size}]")
        mode = "pipelined" if self.pipelined else "sequential"
        if self.lane_offset:
            mode += f"+lane{self.lane_offset}"
        if self.staging:
            mode += f"@{self.staging}"
        return f"{self.strategy}/{mode}: " + " -> ".join(parts)

    # ---- (de)serialization -------------------------------------------------
    def to_json(self) -> str:
        """Serialize; format documented in ``SyncPlan.to_json``."""
        return json.dumps(self.to_dict())

    def to_dict(self) -> dict:
        def leg_dict(l: Leg) -> dict:
            d = {"kind": l.kind, "tier": l.tier, "axis": l.axis,
                 "size": l.size}
            if isinstance(l, (ReduceScatter, Psum, SlowChunk)) and l.codec:
                d["codec"] = l.codec
            if isinstance(l, SlowChunk):
                d["index"] = l.index
                d["chunks"] = l.chunks
                if l.path != "eth":  # old-plan JSON stays byte-identical
                    d["path"] = l.path
            if isinstance(l, (SlowChunk, AllToAll)) \
                    and l.dest_sizes is not None:  # uniform stays bare
                d["dest_sizes"] = list(l.dest_sizes)
            return d

        c = self.cfg
        return {
            "legs": [leg_dict(l) for l in self.legs],
            "shape": list(self.shape), "dtype": self.dtype,
            "scatter_dim": self.scatter_dim, "chunks": self.chunks,
            "pipelined": self.pipelined, "strategy": self.strategy,
            "lane_offset": self.lane_offset,
            "staging": self.staging,
            "collective": self.kind,
            "cfg": {"strategy": c.strategy, "chunks": c.chunks,
                    "codec": c.codec, "codec_block": c.codec_block,
                    "codec_k_frac": c.codec_k_frac,
                    "error_feedback": c.error_feedback,
                    "scatter_depth": c.scatter_depth,
                    "pipeline": c.pipeline, "mid_codec": c.mid_codec,
                    "path_split": [list(p) for p in c.path_split]
                    if c.path_split else None},
        }

    @classmethod
    def from_json(cls, s: str) -> "CommSchedule":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_dict(cls, d: dict) -> "CommSchedule":
        legs = []
        for ld in d["legs"]:
            k = _LEG_KINDS[ld["kind"]]
            if k is SlowChunk:
                ds = ld.get("dest_sizes")
                legs.append(SlowChunk(ld["index"], ld["chunks"],
                                      ld.get("codec"), ld["tier"],
                                      ld["axis"], ld["size"],
                                      ld.get("path", "eth"),
                                      tuple(ds) if ds else None))
            elif k is AllToAll:
                ds = ld.get("dest_sizes")
                legs.append(AllToAll(ld["tier"], ld["axis"], ld["size"],
                                     tuple(ds) if ds else None))
            elif k is Psum:
                legs.append(Psum(ld["tier"], ld["axis"], ld["size"],
                                 ld.get("codec")))
            elif k is ReduceScatter:
                legs.append(ReduceScatter(ld["tier"], ld["axis"],
                                          ld["size"], ld.get("codec")))
            else:
                legs.append(k(ld["tier"], ld["axis"], ld["size"]))
        c = dict(d["cfg"])
        ps = c.pop("path_split", None)
        cfg = SyncConfig(**c, path_split=tuple(
            (n, f) for n, f in ps) if ps else None)
        return cls(legs=tuple(legs), shape=tuple(d["shape"]),
                   dtype=d["dtype"], scatter_dim=d["scatter_dim"],
                   chunks=d["chunks"], pipelined=d["pipelined"],
                   strategy=d["strategy"], cfg=cfg,
                   lane_offset=int(d.get("lane_offset", 0)),
                   staging=d.get("staging"),
                   kind=d.get("collective", "all_reduce"))


# ---------------------------------------------------------------------------
# Builder — the ONLY place tier-walk / divisibility decisions are made
# ---------------------------------------------------------------------------


def assign_paths(chunks: int,
                 path_split: Optional[Tuple[Tuple[str, float], ...]]
                 ) -> Tuple[str, ...]:
    """Route each slow sub-flow index: non-eth paths take the TRAILING
    ``round(frac * chunks)`` indices (in declaration order, from the
    end), Ethernet keeps the leading remainder — so the first ISSUED
    sub-flow (which carries the ring-latency charge) stays on eth
    whenever eth carries anything.  Half-up rounding, clamped so the
    assignment never oversubscribes."""
    paths = ["eth"] * chunks
    if not path_split:
        return tuple(paths)
    pos = chunks
    for name, frac in path_split:
        n_p = min(int(frac * chunks + 0.5), pos)
        for i in range(pos - n_p, pos):
            paths[i] = name
        pos -= n_p
    return tuple(paths)


def _clamp_chunks(cfg: SyncConfig, dim_extent: int, scattered: int,
                  pipelined: bool, shard_numel: int) -> int:
    """Largest feasible chunk count <= cfg.chunks.

    Pipelined schedules split the tensor along the scatter dim BEFORE the
    reduce-scatters, so each chunk must still divide by every scattered
    tier (``dim_extent % (c * scattered) == 0``).  Sequential schedules
    split the flattened shard after the scatters (``shard_numel % c``)."""
    c = max(int(cfg.chunks), 1)
    if cfg.codec == "topk":
        return 1  # top-k compresses the whole shard at once
    while c > 1:
        ok = (dim_extent % (c * scattered) == 0) if pipelined \
            else (shard_numel % c == 0)
        if ok:
            return c
        c -= 1
    return 1


def schedule_from_axes(fast_axes: Sequence[str], slow_axis: Optional[str],
                       cfg: SyncConfig, shape: Sequence[int],
                       scatter_dim: int, sizes: Mapping[str, int],
                       dtype: str = "float32",
                       tier_names: Optional[Mapping[str, str]] = None
                       ) -> CommSchedule:
    """Build a :class:`CommSchedule` from raw axis names + sizes.

    This is the generic core: :func:`build_schedule` feeds it a
    ``FabricSpec``, and the legacy in-trace entry points feed it
    ``lax.axis_size`` results.  ``tier_names`` maps axis -> tier name for
    display/pricing (defaults to the axis name itself)."""
    if cfg.mid_codec not in (None, "int8"):
        raise ValueError(
            f"mid_codec={cfg.mid_codec!r}: only int8 is supported on "
            "unscattered mid-tier psum legs (no error-feedback state there)")
    fast = tuple(fast_axes)
    names = dict(tier_names or {})
    shape = tuple(int(s) for s in shape)

    def tname(axis: str) -> str:
        return names.get(axis, axis)

    def mk_slow_legs(chunks: int) -> list:
        if slow_axis is None or sizes.get(slow_axis, 1) <= 1:
            return []
        n = int(sizes[slow_axis])
        paths = assign_paths(chunks, cfg.path_split)
        return [SlowChunk(i, chunks, cfg.codec, tname(slow_axis),
                          slow_axis, n, paths[i]) for i in range(chunks)]

    strategy = cfg.strategy
    dim = scatter_dim if scatter_dim >= 0 else 0
    numel = 1
    for s in shape:
        numel *= s

    # ---- flat: one psum leg per axis (executor coalesces) ------------------
    all_axes = fast + ((slow_axis,) if slow_axis else ())
    if strategy == "flat" or not fast:
        legs = [Psum(tname(a), a, int(sizes.get(a, 1))) for a in all_axes]
        return CommSchedule(tuple(legs), shape, dtype, -1, 1, False,
                            "flat", cfg)

    # ---- hier_root: psum the fast tiers, slow leg carries full payload ----
    if strategy == "hier_root":
        chunks = _clamp_chunks(cfg, shape[dim], 1, False, numel)
        legs = [Psum(tname(a), a, int(sizes.get(a, 1))) for a in fast]
        legs += mk_slow_legs(chunks)
        return CommSchedule(tuple(legs), shape, dtype, -1, chunks, False,
                            "hier_root", cfg)

    assert strategy == "hier_striped", strategy

    # ---- hier_striped: the recursive tier walk, made explicit -------------
    depth = cfg.scatter_depth if cfg.scatter_depth >= 0 else len(fast)
    planned_prefix = 1
    for a in fast[:depth]:
        planned_prefix *= int(sizes.get(a, 1))
    if shape[dim] % planned_prefix != 0:
        # indivisible by even the planned scatter prefix: flat fallback
        # (tiny leaves only — the planner emits feasible depths)
        legs = [Psum(tname(a), a, int(sizes.get(a, 1))) for a in all_axes]
        return CommSchedule(tuple(legs), shape, dtype, -1, 1, False,
                            "flat", cfg)

    # per-tier scatter/psum decisions (mirrors the retired recursion:
    # a tier that cannot or may not scatter is psum'ed AND consumes a
    # depth unit)
    decisions = []  # (op, axis, size)
    cur = shape[dim]
    d = depth
    for a in fast:
        n = int(sizes.get(a, 1))
        if n <= 1:
            # degenerate tier: no leg, but it still consumes a depth unit
            # (depth semantics index tiers, matching the planner's prefix
            # products)
            d = 0 if d == 0 else d - 1
        elif d == 0 or cur % n != 0:
            decisions.append(("psum", a, n))
            d = 0 if d == 0 else d - 1
        else:
            decisions.append(("rs", a, n))
            cur //= n
            d -= 1
    scattered = [(a, n) for op, a, n in decisions if op == "rs"]
    nf = 1
    for _, n in scattered:
        nf *= n

    has_slow = slow_axis is not None and sizes.get(slow_axis, 1) > 1
    pipelined = bool(cfg.pipeline) and cfg.chunks > 1 and has_slow \
        and bool(scattered)
    shard_numel = numel // nf
    chunks = _clamp_chunks(cfg, shape[dim], nf, pipelined, shard_numel)
    if chunks <= 1:
        pipelined = False

    mid = cfg.mid_codec
    legs = []
    for i_d, (op, a, n) in enumerate(decisions):
        if op == "rs":
            # mid codec also compresses SCATTERED mid-tier legs (any
            # active fast tier past the fastest); the fastest tier's
            # scatter stays exact — it dominates the reduction's
            # precision and its wire time is already cheap
            legs.append(ReduceScatter(tname(a), a, n,
                                      mid if i_d > 0 else None))
        else:
            legs.append(Psum(tname(a), a, n, mid if n > 1 else None))
    legs += mk_slow_legs(chunks)
    legs += [AllGather(tname(a), a, n) for a, n in reversed(scattered)]
    return CommSchedule(tuple(legs), shape, dtype, dim, chunks, pipelined,
                        "hier_striped", cfg)


def build_schedule(fabric: FabricSpec, cfg: SyncConfig,
                   shape: Sequence[int], scatter_dim: int = 0,
                   dtype: str = "float32",
                   fast_axes: Optional[Sequence[str]] = None,
                   fast_sizes: Optional[Sequence[int]] = None
                   ) -> CommSchedule:
    """Build the schedule for one Section from ``(FabricSpec, SyncConfig,
    shape)``.

    ``fast_axes`` / ``fast_sizes`` override the fabric's fast-tier axis
    names / extents when the mesh truth differs from the hardware
    description (the planner's ``fast_axis_sizes`` escape hatch)."""
    fab_fast = list(fabric.fast_tiers)
    axes = list(fast_axes) if fast_axes is not None \
        else [t.axis for t in fab_fast]
    if fast_sizes is not None:
        sizes_list = [int(s) for s in fast_sizes]
    else:
        sizes_list = [t.size for t in fab_fast]
    if len(axes) != len(sizes_list):
        # mesh said N fast tiers but the fabric describes M: trust the mesh
        # axis list and pad names generically
        while len(axes) < len(sizes_list):
            axes.append(f"fast{len(axes)}")
        axes = axes[:len(sizes_list)]
    sizes = dict(zip(axes, sizes_list))
    names = {}
    for i, a in enumerate(axes):
        names[a] = fab_fast[i].name if i < len(fab_fast) else a
    slow_axis = fabric.slow_axis
    if slow_axis is not None:
        sizes[slow_axis] = fabric.slowest.size
        names[slow_axis] = fabric.slowest.name
    return schedule_from_axes(axes, slow_axis, cfg, shape, scatter_dim,
                              sizes, dtype, tier_names=names)


# ---------------------------------------------------------------------------
# All-to-all builder (kind="all_to_all": shuffle / MoE-dispatch traffic)
# ---------------------------------------------------------------------------


def all_to_all_from_axes(fast_axes: Sequence[str], slow_axis: Optional[str],
                         cfg: SyncConfig, shape: Sequence[int],
                         sizes: Mapping[str, int], dtype: str = "float32",
                         tier_names: Optional[Mapping[str, str]] = None,
                         dest_sizes: Optional[Sequence[float]] = None
                         ) -> CommSchedule:
    """Build the all-to-all :class:`CommSchedule` from raw axis names +
    sizes (the generic core behind :func:`build_all_to_all`, fed live
    ``lax.axis_size`` results by the in-trace entry point).

    ``shape`` is the LOCAL payload ``(n_total, ...)``: row *r* holds the
    sub-payload destined for member *r* of the DP domain, rows ordered
    slow-major (the slowest tier's sub-index is the most significant
    digit).  One ``AllToAll`` leg per active fast tier (fastest first),
    then the slow tier's exchange chunked into ``cfg.chunks``
    ``SlowChunk`` sub-flows — each sub-flow carries an equal slice of
    every destination's payload, so chunking is a pure split of the wire
    transfer (the builder clamps ``chunks`` to divide the per-slow-row
    payload).  Unlike the all-reduce walk there is no down/up phase and
    the payload never shrinks; schedules are never pipelined.

    ``dest_sizes`` makes the exchange NON-UNIFORM: ``dest_sizes[m]`` is
    the wire bytes each member sends to DP member *m* (length
    ``n_total``, slow-major like the payload rows; a symmetric profile —
    every member sends the same sizes, e.g. per-expert MoE flows).  The
    builder aggregates it per tier digit: each fast ``AllToAll`` leg
    gets the row sizes summed over ITS sub-index, and each ``SlowChunk``
    gets the per-slow-destination sums split evenly over the chunk
    count.  ``None`` (the default) builds exactly the uniform schedule —
    byte-identical ``to_json``.  The skew is an annotation (the executed
    payload stays ``shape``); the cost model charges the incast bound
    over the sizes and the simulator expands the per-destination flows
    at them.

    Codecs do not apply: an all-to-all moves payload verbatim (there is
    no reduction for error feedback to absorb quantization into), so a
    ``cfg`` carrying a codec is rejected."""
    if cfg.codec is not None or cfg.mid_codec is not None:
        raise ValueError(
            "all-to-all schedules cannot carry a codec (no reduction to "
            f"absorb quantization error): codec={cfg.codec!r} "
            f"mid_codec={cfg.mid_codec!r}")
    names = dict(tier_names or {})
    shape = tuple(int(s) for s in shape)
    numel = 1
    for s in shape:
        numel *= s

    def tname(axis: str) -> str:
        return names.get(axis, axis)

    active = [(a, int(sizes.get(a, 1))) for a in tuple(fast_axes)
              if int(sizes.get(a, 1)) > 1]
    n_slow = int(sizes.get(slow_axis, 1)) if slow_axis is not None else 1
    n_total = n_slow if n_slow > 1 else 1
    for _, n in active:
        n_total *= n
    if n_total > 1 and (not shape or shape[0] != n_total):
        raise ValueError(
            f"all-to-all payload must carry one row per DP member: "
            f"shape {shape} vs {n_total} members")

    ds = None
    if dest_sizes is not None:
        ds = [float(b) for b in dest_sizes]
        if len(ds) != n_total:
            raise ValueError(
                f"dest_sizes needs one wire size per DP member: "
                f"{len(ds)} sizes for {n_total} members")

    def digit_sums(stride: int, n: int) -> Tuple[float, ...]:
        """Row sizes summed over one tier's digit (rows are slow-major:
        the fastest tier's digit is the least significant)."""
        out = [0.0] * n
        for m, b in enumerate(ds):
            out[(m // stride) % n] += b
        return tuple(out)

    legs: list = []
    stride = 1
    for a, n in active:  # fastest first, so strides grow left to right
        legs.append(AllToAll(tname(a), a, n,
                             digit_sums(stride, n) if ds else None))
        stride *= n
    chunks = 1
    if n_slow > 1:
        row = numel // n_slow  # per-slow-sub-index payload the chunks split
        chunks = max(int(cfg.chunks), 1)
        while chunks > 1 and row % chunks != 0:
            chunks -= 1
        paths = assign_paths(chunks, cfg.path_split)
        slow_ds = None
        if ds:
            # per-slow-destination totals, split evenly over the chunks
            # (every chunk slices an equal share of EVERY destination's
            # payload — see lower_all_to_all)
            slow_ds = tuple(b / chunks for b in digit_sums(stride, n_slow))
        legs += [SlowChunk(i, chunks, None, tname(slow_axis), slow_axis,
                           n_slow, paths[i], slow_ds)
                 for i in range(chunks)]
    return CommSchedule(tuple(legs), shape, dtype, 0, chunks, False,
                        "all_to_all", cfg, kind="all_to_all")


def build_all_to_all(fabric: FabricSpec, cfg: SyncConfig,
                     shape: Sequence[int], dtype: str = "float32",
                     fast_axes: Optional[Sequence[str]] = None,
                     fast_sizes: Optional[Sequence[int]] = None,
                     dest_sizes: Optional[Sequence[float]] = None
                     ) -> CommSchedule:
    """Build the all-to-all schedule for one exchange from ``(FabricSpec,
    SyncConfig, shape)`` — the ``kind="all_to_all"`` twin of
    :func:`build_schedule`; same ``fast_axes`` / ``fast_sizes`` escape
    hatch for meshes that differ from the hardware description.
    ``dest_sizes`` (per-member wire bytes, slow-major) makes the
    exchange non-uniform — see :func:`all_to_all_from_axes`."""
    fab_fast = list(fabric.fast_tiers)
    axes = list(fast_axes) if fast_axes is not None \
        else [t.axis for t in fab_fast]
    if fast_sizes is not None:
        sizes_list = [int(s) for s in fast_sizes]
    else:
        sizes_list = [t.size for t in fab_fast]
    if len(axes) != len(sizes_list):
        while len(axes) < len(sizes_list):
            axes.append(f"fast{len(axes)}")
        axes = axes[:len(sizes_list)]
    sizes = dict(zip(axes, sizes_list))
    names = {}
    for i, a in enumerate(axes):
        names[a] = fab_fast[i].name if i < len(fab_fast) else a
    slow_axis = fabric.slow_axis
    if slow_axis is not None:
        sizes[slow_axis] = fabric.slowest.size
        names[slow_axis] = fabric.slowest.name
    return all_to_all_from_axes(axes, slow_axis, cfg, shape, sizes, dtype,
                                tier_names=names, dest_sizes=dest_sizes)
