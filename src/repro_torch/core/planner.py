"""The LPPU analogue: a control plane that plans gradient synchronization.

A copy of ``repro.core.planner`` (framework-free): leaf shapes come as
:class:`ShapeDtype` records with numpy dtype names instead of
``jax.ShapeDtypeStruct``; the candidate report (``keep_report``,
``replan``) comes from the port's copy of ``obs/plan_report``.

The paper's LPPU owns the NIC pool's control plane — it maps sub-flows to
NICs by queue depth and allocates pool memory (Sections / Buffers).  XLA
programs are static, so the *dynamic per-packet* scheduling does not
transfer (recorded in DESIGN.md §2); what does transfer is cost-driven
planning at trace time:

  * gradients are bucketed into **Sections** (paper §4.1 terminology),
  * for each Section the planner SEARCHES over candidate
    :class:`~repro.core.schedule.CommSchedule` objects — scatter depth x
    slow-leg chunk count (overlapped pipeline) x per-tier codec — pricing
    each with :meth:`CostModel.from_schedule`, i.e. the planner prices the
    exact leg list the executor will lower,
  * the winning schedule is stored ON the Section (``Section.schedule``),
    so ``grad_sync`` / ``train_loop`` thread a schedule instead of
    re-deriving one from ``SyncConfig``,
  * the plan is a static artifact — inspectable, serializable, and testable
    without running anything.

The planner accepts either the legacy :class:`TwoTierTopology` or an
N-tier :class:`FabricSpec`; with more than two tiers the per-section search
runs over scatter depths of the hierarchical collective (see
``repro.core.schedule``).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, replace
from typing import (TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from repro_torch.core.cost_model import CostModel, dtype_itemsize
from repro_torch.core.nicpool import NicPool
from repro_torch.core.schedule import (CommSchedule, SyncConfig, build_all_to_all,
                                 build_schedule)
from repro_torch.core.topology import FabricSpec, TwoTierTopology, as_fabric

if TYPE_CHECKING:  # import-time cycle: obs/__init__ -> audit -> fabric_sim
    from repro_torch.obs.plan_report import PlanReport


class DtypeName(str):
    """A numpy dtype name (``"float32"``, ``"bfloat16"``) with the
    ``itemsize`` the planner reads; ``str()`` of it is the name itself."""

    @property
    def itemsize(self) -> int:
        return dtype_itemsize(self)


@dataclass(frozen=True)
class ShapeDtype:
    """What the planner reads of a gradient leaf: its shape and a numpy
    dtype name (the reference takes ``jax.ShapeDtypeStruct``).  Never a
    torch dtype: ``str(torch.bfloat16)`` would price at 4 bytes."""

    shape: Tuple[int, ...]
    dtype: DtypeName

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        object.__setattr__(self, "dtype", DtypeName(self.dtype))


@dataclass(frozen=True)
class Section:
    """One sync unit: either a single large tensor or a bucket of small
    flattened leaves (the paper's Section; leaves are its Buffers).

    ``scatter_dim`` indexes the (TP-)LOCAL block shape — the sync runs
    inside a nested model-manual shard_map (§Perf iteration 6), so all
    shapes it sees are per-model-shard.  ``model_sharded`` marks sections
    whose gradient is split over the TP axis (their global sq-norm needs an
    extra psum over 'model').  The tier plan lives in ``schedule`` (the
    planner-built :class:`CommSchedule` the executor lowers); ``sync``
    keeps the equivalent :class:`SyncConfig` knobs for legacy consumers
    and for rebuilding the schedule in-trace when shapes differ (the
    non-nested TP path)."""

    name: str
    leaf_paths: Tuple[str, ...]
    numel: int
    dtype: str
    scatter_dim: int  # dimension scattered over the fast tiers (-1 = flat 1d)
    sync: SyncConfig = field(default_factory=SyncConfig)
    model_sharded: bool = False
    schedule: Optional[CommSchedule] = None

    @property
    def nbytes(self) -> int:
        return self.numel * dtype_itemsize(self.dtype)


@dataclass
class SyncPlan:
    sections: List[Section]
    est_total_s: float = 0.0
    est_dcn_bytes_per_chip: float = 0.0
    # candidate-level search audit, only when Planner(keep_report=True);
    # serializes separately via PlanReport.to_json (next to to_json below)
    report: Optional[PlanReport] = None

    def describe(self) -> str:
        lines = [f"SyncPlan: {len(self.sections)} sections, "
                 f"est {self.est_total_s*1e3:.3f} ms, "
                 f"DCN {self.est_dcn_bytes_per_chip/2**20:.2f} MiB/chip"]
        for s in self.sections:
            lines.append(
                f"  {s.name:40s} {s.numel:>12d} x {s.dtype:8s} "
                f"{s.sync.strategy:>13s} depth={s.sync.scatter_depth} "
                f"chunks={s.sync.chunks} codec={s.sync.codec}")
            if s.schedule is not None:
                lines.append(f"    {s.schedule.describe()}")
        return "\n".join(lines)

    def to_json(self) -> str:
        """Serialize the plan, one object per section.

        Schedule JSON format (``"schedule"`` key, when the planner built
        one)::

            {"legs": [{"kind": "reduce_scatter" | "psum" | "slow_chunk"
                               | "all_gather" | "all_to_all",
                       "tier": "<tier name>", "axis": "<mesh axis>",
                       "size": <int>,
                       // slow_chunk only:
                       "index": <int>, "chunks": <int>,
                       // slow_chunk only, when routed off the Ethernet
                       // pool ("cxl" | "loop"; absent == "eth"):
                       "path": "<route>",
                       // slow_chunk / all_to_all only, when the exchange
                       // is NON-UNIFORM (absent == uniform): per-
                       // destination wire bytes, one per member of the
                       // leg's tier (slow_chunk: this chunk's share):
                       "dest_sizes": [<float>, ...],
                       // psum / reduce_scatter / slow_chunk, only when
                       // compressed:
                       "codec": "int8" | "topk"},
                      ...],
             "shape": [<local block shape>], "dtype": "<dtype>",
             "scatter_dim": <int>, "chunks": <int>,
             "pipelined": <bool>, "strategy": "<strategy>",
             "lane_offset": <int>,
             "staging": "local" | "pool" | null,
             "collective": "all_reduce" | "all_to_all",
             "cfg": {<SyncConfig fields>}}

        Legs appear in lowering order: reduce-scatters down the fast
        tiers, unscattered psums, the slow-tier sub-flows, then
        all-gathers back up.  ``lane_offset`` is the planner's NIC-pool
        stagger (``NicPool.stagger``): the slow_chunk legs appear in
        ISSUE order, their ``index`` fields rotated by the offset so
        concurrent Sections' first sub-flows ride different pool lanes
        (sub-flow *i* maps to lane ``i mod lanes``); the executor
        reassembles the payload by ``index``, so the field only affects
        wire order.  Absent in pre-NIC-pool plans (defaults to 0 on
        load).  ``staging`` is the planner's memory-pool placement for
        the slow leg's staging buffers ("local" DRAM channels vs the
        "pool" device interleave — see ``repro.core.mempool``); numerics-
        free like ``lane_offset``, absent/null in pre-mempool plans.
        ``collective`` is the schedule kind (``CommSchedule.kind``):
        "all_to_all" schedules (``Planner.plan_all_to_all`` — shuffle /
        MoE-dispatch exchanges) carry "all_to_all" legs plus slow_chunk
        sub-flows that split the per-destination payload; absent in
        pre-all-to-all plans (defaults to "all_reduce" on load).
        ``"path"`` on a slow_chunk leg is the planner's multi-path
        routing (``SyncConfig.path_split``, also under ``"cfg"``): the
        sub-flow rides that declared route ("cxl" / "loop") instead of
        the Ethernet pool.  Emitted only when != "eth", so pre-multipath
        plans are byte-identical and old JSON loads with every sub-flow
        defaulting to "eth".  ``"dest_sizes"`` is likewise emitted only
        on skewed legs (``Planner.plan_all_to_all(dest_sizes=...)`` —
        hot-expert MoE dispatch / incast shuffles), so uniform plans
        stay byte-identical; the executor never reads it (the executed
        payload is the rectangular ``shape``), only the cost model's
        incast bound and the simulator's per-destination flows do.
        ``CommSchedule.from_json`` round-trips this exactly."""
        return json.dumps([
            dict(name=s.name, numel=s.numel, dtype=s.dtype,
                 strategy=s.sync.strategy, chunks=s.sync.chunks,
                 codec=s.sync.codec, scatter_depth=s.sync.scatter_depth,
                 pipeline=s.sync.pipeline,
                 leaves=list(s.leaf_paths),
                 schedule=(s.schedule.to_dict()
                           if s.schedule is not None else None))
            for s in self.sections
        ], indent=2)


class Planner:
    """Plans one :class:`SyncPlan` for a gradient pytree.

    ``topo``: TwoTierTopology | FabricSpec.  ``fast_axis_sizes`` overrides
    the per-tier fast-axis extents (ordered fastest first) when the mesh
    truth differs from the fabric description; ``fast_axis_size`` is the
    legacy single-tier override.  ``pipeline`` enables the overlapped
    slow-leg pipeline for chunked sections; ``mid_codec`` adds candidates
    that int8-compress mid-tier legs (unscattered psums AND scattered
    reduce-scatters — the fastest active tier stays exact);
    ``stagger_lanes`` asks the NIC-pool arbiter for per-Section sub-flow
    phase offsets (``CommSchedule.lane_offset``) so concurrent Sections'
    slow legs interleave across pool lanes instead of colliding.

    When the fabric declares alternative slow-leg routes
    (``FabricSpec.paths`` — e.g. a CXL shortcut), every candidate is
    additionally priced per path split (``SyncConfig.path_split``): a
    fraction of the slow sub-flows rides each declared route while the
    rest stay on the Ethernet pool, and a split is kept only when
    STRICTLY cheaper than the eth-only degenerate (which therefore
    reproduces path-free plans exactly).

    When the fabric carries a memory model (``FabricSpec.mem``), every
    candidate is additionally priced per staging placement — slow-leg
    staging buffers in local DRAM (low latency) vs interleaved across
    the pooled devices (high bandwidth, the expander's added latency) —
    and the winner's placement is stored on the schedule
    (``CommSchedule.staging``); slow-leg chunk counts are clamped when
    MEMORY, not lanes, is the binding constraint (extra sub-flows only
    add per-chunk access-latency tails a memory-bound pipeline cannot
    hide)."""

    def __init__(self, topo: Union[TwoTierTopology, FabricSpec], *,
                 fast_axis_size: Optional[int] = None,
                 fast_axis_sizes: Optional[Sequence[int]] = None,
                 codec: Optional[str] = None,
                 max_chunks: int = 8,
                 min_chunk_numel: int = 1 << 16,
                 strategy: str = "auto",
                 pipeline: bool = True,
                 mid_codec: Optional[str] = None,
                 stagger_lanes: bool = True,
                 keep_report: bool = False):
        self.topo = topo
        self.fabric = as_fabric(topo)
        self.cost = CostModel(topo)
        self.stagger_lanes = stagger_lanes
        self.nic_pool = NicPool.from_fabric(self.fabric)
        # remembered so for_fabric() can tell a mesh-truth override apart
        # from fabric-derived defaults (even when they happen to coincide)
        self._explicit_fast_sizes = (fast_axis_sizes is not None
                                     or fast_axis_size is not None)
        if fast_axis_sizes is not None:
            self.fast_sizes: Tuple[int, ...] = tuple(int(s) for s in fast_axis_sizes)
        elif fast_axis_size is not None:
            self.fast_sizes = (int(fast_axis_size),)
        else:
            self.fast_sizes = tuple(t.size for t in self.fabric.fast_tiers) or (1,)
        self.nf = int(np.prod(self.fast_sizes))
        self.codec = codec
        self.max_chunks = max_chunks
        self.min_chunk_numel = min_chunk_numel
        self.strategy = strategy
        self.pipeline = pipeline
        self.mid_codec = mid_codec
        self.keep_report = keep_report
        # last plan's / plan_all_to_all's candidate audit (keep_report only)
        self.report: Optional[PlanReport] = None

    def for_fabric(self, topo: Union[TwoTierTopology, FabricSpec]
                   ) -> "Planner":
        """A new planner with THIS planner's knobs on a different fabric
        (typically ``FabricSpec.degrade(...)``'s output).  A
        ``fast_axis_sizes`` mesh override carries over verbatim; when the
        sizes were just the old fabric's defaults, the new planner
        re-derives them from the new fabric instead — a degraded tier
        (``tier_members``) then shrinks the plan's fast axes too."""
        sizes = self.fast_sizes if self._explicit_fast_sizes else None
        return Planner(topo,
                       fast_axis_sizes=sizes,
                       codec=self.codec,
                       max_chunks=self.max_chunks,
                       min_chunk_numel=self.min_chunk_numel,
                       strategy=self.strategy,
                       pipeline=self.pipeline,
                       mid_codec=self.mid_codec,
                       stagger_lanes=self.stagger_lanes,
                       keep_report=self.keep_report)

    def replan(self, degraded: Union[TwoTierTopology, FabricSpec],
               shapes: Dict[str, ShapeDtype], *,
               old_plan: Optional[SyncPlan] = None,
               reason: str = "fabric degraded",
               **plan_kw):
        """Re-plan ``shapes`` on a ``degraded`` fabric and explain the
        change: returns ``(new_plan, diff)`` where ``diff`` is a
        :class:`repro.obs.plan_report.PlanDiff` naming every per-section
        knob the degradation flipped (depth/chunks/staging/path split/...)
        against ``old_plan`` (typically this planner's plan for the same
        shapes on the healthy fabric; None diffs against nothing and
        reports every section as added).  ``plan_kw`` forwards to
        :meth:`plan` (``bucket_bytes``, ``avoid_dims``, ...)."""
        from repro_torch.obs.plan_report import diff_plans
        new_plan = self.for_fabric(degraded).plan(shapes, **plan_kw)
        return new_plan, diff_plans(old_plan, new_plan, reason=reason)

    @property
    def n_fast_tiers(self) -> int:
        return len(self.fast_sizes)

    @property
    def domain_size(self) -> int:
        """Member count of the DP domain THIS planner plans for: the
        product of the ACTIVE (size > 1) fast-tier extents — honoring the
        ``fast_axis_sizes`` mesh override — times the slow tier's.  This
        is the row count ``plan_all_to_all`` payloads must carry."""
        n = int(np.prod([s for s in self.fast_sizes if s > 1])) \
            if any(s > 1 for s in self.fast_sizes) else 1
        if self.fabric.depth > 1 and self.fabric.slowest.size > 1:
            n *= self.fabric.slowest.size
        return n

    def _prefix_prod(self, depth: int) -> int:
        return int(np.prod(self.fast_sizes[:depth])) if depth > 0 else 1

    # -- per-section decisions -------------------------------------------------
    def _pick_scatter_dim(self, shape: Tuple[int, ...],
                          avoid: frozenset = frozenset()) -> Tuple[int, int]:
        """(dim, depth): the largest dim divisible by the deepest possible
        prefix of the fast-tier sizes; (-1, 0) if none divides even the
        fastest tier.

        ``avoid`` holds dims already sharded over an auto (TP/FSDP) axis —
        scattering those would force GSPMD regrouping, so they are only
        used as a last resort.
        """
        for depth in range(self.n_fast_tiers, 0, -1):
            prod = self._prefix_prod(depth)
            best, best_dim = -1, -1
            for d, s in enumerate(shape):
                if d in avoid:
                    continue
                if s % prod == 0 and s > best:
                    best, best_dim = s, d
            if best_dim >= 0:
                return best_dim, depth
        return -1, 0

    def _mem_chunk_cap(self, shard_numel: int, xfer: float = 2.0) -> int:
        """Largest slow-leg chunk count worth pricing under the memory
        model.  When memory (not lanes) is the binding slow-leg
        constraint, extra sub-flows cannot speed the leg up — they only
        add one staging-latency tail each — so candidates are clamped to
        keep the summed tails under ~10% of the memory-bound slow time.
        With no memory model (or when lanes bind) the NIC-pool search
        rules are unchanged.  ``xfer`` is the per-member traffic factor of
        the slow leg: 2 for the all-reduce walk (down + up), 1 for an
        all-to-all exchange."""
        spec = self.fabric.mem
        fab = self.fabric
        if spec is None or fab.depth <= 1 or fab.slowest.size <= 1:
            return self.max_chunks
        slow = fab.slowest
        grp = max(fab.n_fast, 1)
        # per-chip wire rate the memory pool can sustain, best placement
        mem_rate = spec.deliverable_bw("pool") / (spec.traffic_factor * grp)
        if mem_rate >= slow.rate:
            return self.max_chunks  # lanes bind, not memory
        tail = spec.staging_latency("pool")
        if tail <= 0:
            return self.max_chunks
        wire = xfer * (slow.size - 1) / slow.size * shard_numel \
            * dtype_itemsize("float32")  # the wire dtype (see _search_section)
        return max(1, min(self.max_chunks,
                          int(0.1 * (wire / mem_rate) / tail)))

    def _staging_candidates(self) -> List[Optional[str]]:
        """Memory-pool staging placements worth pricing (ordered: "pool"
        first — the tie-break; see ``_search_section``)."""
        mem = self.fabric.mem
        if mem is None:
            return [None]
        if mem.placement("pool") == mem.placement("local"):
            # degenerate pool (e.g. local channels only): both stagings
            # resolve to the same device set — price once, label honestly
            return ["pool" if mem.pooled_devices else "local"]
        return ["pool", "local"]

    def _path_split_candidates(self, chunks: int
                               ) -> List[Optional[Tuple[Tuple[str, float], ...]]]:
        """Slow-leg path splits worth pricing for a ``chunks``-sub-flow
        leg: no split FIRST (the eth-only degenerate — the tie-break that
        keeps today's plans on path-free fabrics and whenever striping an
        alternative route is not strictly cheaper), then, for each route
        the fabric declares (``FabricSpec.paths``), the fractions
        ``k/chunks`` (k = 1..chunks) of the sub-flows rerouted onto it —
        every split ``assign_paths`` can realize at this chunk count."""
        cands: List[Optional[Tuple[Tuple[str, float], ...]]] = [None]
        fab = self.fabric
        if not fab.paths or fab.depth <= 1 or fab.slowest.size <= 1:
            return cands
        for spec in fab.paths:
            for k in range(1, chunks + 1):
                cands.append(((spec.name, k / chunks),))
        return cands

    def _candidate_chunks(self, shard_numel: int,
                          cap: Optional[int] = None) -> List[int]:
        """Slow-leg sub-flow counts worth pricing: 1 plus powers of two up
        to ``max_chunks`` (clamped to ``cap`` — the memory-bound limit)
        that divide the shard and keep each sub-flow above
        ``min_chunk_numel``."""
        cands = [1]
        c = 2
        top = self.max_chunks if cap is None else min(self.max_chunks, cap)
        while c <= top:
            if shard_numel % c == 0 and shard_numel // c >= self.min_chunk_numel:
                cands.append(c)
            c *= 2
        return cands

    def _build(self, cfg: SyncConfig, shape: Tuple[int, ...], sd: int,
               dtype: str) -> CommSchedule:
        return build_schedule(self.fabric, cfg, shape, max(sd, 0),
                              dtype=dtype, fast_sizes=self.fast_sizes)

    @staticmethod
    def _knobs(cfg: SyncConfig, s: Optional[CommSchedule]) -> dict:
        """The searched knob values of one candidate, as
        ``repro.obs.plan_report.Candidate`` fields."""
        return dict(strategy=cfg.strategy, scatter_depth=cfg.scatter_depth,
                    chunks=s.chunks if s is not None else cfg.chunks,
                    codec=cfg.codec, mid_codec=cfg.mid_codec,
                    staging=s.staging if s is not None else None,
                    path_split=cfg.path_split,
                    pipelined=bool(s.pipelined if s is not None
                                   else cfg.pipeline))

    def _record_search(self, name: Optional[str], kind: str,
                       shape: Tuple[int, ...],
                       priced: List[Tuple[float, dict, object]]) -> None:
        if not self.keep_report or name is None:
            return
        from repro_torch.obs.plan_report import PlanReport
        if self.report is None:
            self.report = PlanReport()
        self.report.sections.append(
            PlanReport.build_section(name, kind, shape, priced))

    def _search_section(self, lshape: Tuple[int, ...],
                        avoid: frozenset = frozenset(),
                        report_name: Optional[str] = None
                        ) -> Tuple[SyncConfig, int, Optional[CommSchedule]]:
        """Search candidate schedules (depth x chunks x per-tier codec x
        slow-leg path split), pricing each with
        ``CostModel.from_schedule``; returns the winner's
        (SyncConfig, scatter_dim, CommSchedule).

        Schedules are priced at the fp32 WIRE dtype (grad_sync upcasts
        every gradient before the collectives run); feasibility (scatter
        dims, chunk counts) is element-count-driven from the true local
        shape.

        Candidate order encodes tie-breaks: within the striped family
        deeper scatters come first (never slower in the alpha-beta model),
        within a depth the "pool" staging precedes "local" (more
        deliverable bandwidth — local only wins when strictly cheaper,
        i.e. when the expander tail costs more than its bandwidth buys),
        and a flat plan only wins when strictly cheaper than every
        hierarchical one (matching the legacy selection)."""
        dtype = "float32"  # the wire dtype
        numel = int(np.prod(lshape))
        nbytes = numel * dtype_itemsize(dtype)
        sd, dmax = self._pick_scatter_dim(lshape, avoid)
        strat = self.strategy
        stagings = self._staging_candidates()

        def price(s: CommSchedule) -> float:
            return self.cost.from_schedule(s, mem=True).total_s

        flat_cfg = SyncConfig(strategy="flat", chunks=1, codec=self.codec,
                              pipeline=self.pipeline)
        if strat == "flat" or (sd < 0 or dmax == 0) and strat != "hier_root":
            # forced flat, or nothing divides even the fastest tier
            s = self._build(flat_cfg, lshape, sd, dtype)
            self._record_search(report_name, "section", lshape, [
                (self.cost.flat_ring(nbytes).total_s,
                 self._knobs(flat_cfg, s), s)])
            return flat_cfg, sd, s

        cands: List[Tuple[float, SyncConfig, CommSchedule]] = []
        if strat in ("auto", "hier_striped"):
            for d in range(dmax, 0, -1):  # deepest first
                depth_val = -1 if d >= self.n_fast_tiers else d
                shard_numel = numel // self._prefix_prod(d)
                mids: List[Optional[str]] = [None]
                # mid tiers exist when some tier is neither the fastest
                # scattered one (d >= 2: scattered-RS mid tiers) nor the
                # slow leg (d < n_fast_tiers: unscattered-psum mid tiers)
                if self.mid_codec and (d >= 2 or d < self.n_fast_tiers):
                    mids.append(self.mid_codec)
                cap = self._mem_chunk_cap(shard_numel)
                for c in self._candidate_chunks(shard_numel, cap):
                    for mid in mids:
                        for split in self._path_split_candidates(c):
                            cfg = SyncConfig(strategy="hier_striped",
                                             chunks=c, codec=self.codec,
                                             scatter_depth=depth_val,
                                             pipeline=self.pipeline,
                                             mid_codec=mid,
                                             path_split=split)
                            s0 = self._build(cfg, lshape, sd, dtype)
                            for stg in stagings:
                                s = s0.with_staging(stg)
                                cands.append((price(s), cfg, s))
        if strat in ("auto", "hier_root"):
            cfg = SyncConfig(strategy="hier_root", chunks=1, codec=self.codec,
                             pipeline=self.pipeline)
            s0 = self._build(cfg, lshape, sd, dtype)
            for stg in stagings:
                s = s0.with_staging(stg)
                cands.append((price(s), cfg, s))
        if strat == "auto":
            # flat priced by the bottleneck-link model (a flat ring's
            # cross-pod hop is NOT pooled), not by per-tier rings
            s = self._build(flat_cfg, lshape, sd, dtype)
            cands.append((self.cost.flat_ring(nbytes).total_s, flat_cfg, s))

        # strict ordering: the FIRST candidate at the minimum wins, so the
        # list order above is the tie-break
        self._record_search(report_name, "section", lshape,
                            [(p, self._knobs(cfg, s), s)
                             for p, cfg, s in cands])
        best = min(cands, key=lambda t: t[0])
        _, cfg, s = best
        # record the chunk count the builder actually kept
        if cfg.chunks != s.chunks:
            cfg = replace(cfg, chunks=s.chunks)
        if s.strategy == "flat" and cfg.strategy != "flat":
            cfg = replace(cfg, strategy="flat", chunks=1)
        return cfg, sd, s

    def plan_all_to_all(self, shape: Tuple[int, ...],
                        dtype: str = "float32",
                        dest_sizes: Optional[Sequence[float]] = None
                        ) -> CommSchedule:
        """Search slow-leg chunk count x path split x staging placement
        for ONE all-to-all exchange over the DP domain (the §6.2 shuffle
        / MoE dispatch), pricing each candidate with
        ``CostModel.from_schedule(mem=True)`` — the ``kind="all_to_all"``
        twin of ``_search_section``.

        ``shape`` is the per-member payload ``(n_total, per_dest...)``:
        one row per DP member, rows slow-major (what
        ``collectives.lower_all_to_all`` lowers).  Chunk feasibility uses
        the per-slow-row payload the sub-flows actually split; the
        memory-bound chunk clamp applies with the all-to-all's single-
        direction wire factor.  The winner carries the staging placement
        (``CommSchedule.staging``); concurrent exchanges can still be
        staggered with ``CommSchedule.with_lane_offset`` /
        ``NicPool.stagger`` (or, skew-aware, ``stagger_exchanges``).

        ``dest_sizes`` (per-member wire bytes, slow-major — see
        ``schedule.all_to_all_from_axes``) makes the search SKEW-AWARE:
        every candidate carries the sizes, so the incast bound (max over
        destination rows, not the mean) is what chunk counts, path
        splits and staging placements are judged by — a hot destination
        inflates the Ethernet pool's per-chunk charge until rerouting
        sub-flows onto a declared shortcut ("cxl" / "loop") or flipping
        the staging placement is strictly cheaper, decisions the
        uniform-assuming search cannot reach.  The memory-bound chunk
        clamp is likewise taken at the incast-equivalent volume
        (``n_slow * max`` per-destination bytes), not the mean."""
        fab = self.fabric
        shape = tuple(int(s) for s in shape)
        numel = int(np.prod(shape))
        n_slow = fab.slowest.size if fab.depth > 1 else 1
        row = numel // n_slow if n_slow > 1 else numel
        cap_numel = numel
        if dest_sizes is not None and n_slow > 1:
            # chunk-clamp at the incast bound: the volume that actually
            # gates the memory pool is (n-1) * max per-slow-destination
            # bytes, i.e. the uniform-formula volume of an exchange
            # n_slow * max(B_s) bytes big
            probe = build_all_to_all(
                fab, SyncConfig(strategy="hier_striped", chunks=1,
                                pipeline=False),
                shape, dtype, fast_sizes=self.fast_sizes,
                dest_sizes=dest_sizes)
            slow = probe.slow_legs
            if slow and slow[0].dest_sizes:
                cap_numel = max(1, int(
                    n_slow * max(slow[0].dest_sizes)
                    / dtype_itemsize("float32")))
        cap = self._mem_chunk_cap(cap_numel, xfer=1.0)
        cands: List[Tuple[float, SyncConfig, CommSchedule]] = []
        for c in self._candidate_chunks(row, cap):
            for split in self._path_split_candidates(c):
                cfg = SyncConfig(strategy="hier_striped", chunks=c,
                                 pipeline=False, path_split=split)
                s0 = build_all_to_all(fab, cfg, shape, dtype,
                                      fast_sizes=self.fast_sizes,
                                      dest_sizes=dest_sizes)
                for stg in self._staging_candidates():
                    s = s0.with_staging(stg)
                    cands.append(
                        (self.cost.from_schedule(s, mem=True).total_s,
                         cfg, s))
        self._record_search(
            f"all_to_all{shape}" + ("~skew" if dest_sizes is not None
                                    else ""),
            "all_to_all", shape,
            [(p, self._knobs(cfg, s), s) for p, cfg, s in cands])
        # first candidate at the minimum wins: more chunks only when
        # strictly cheaper, "pool" staging over "local" on ties
        return min(cands, key=lambda t: t[0])[2]

    def stagger_exchanges(self, schedules: Sequence[Optional[CommSchedule]]
                          ) -> List[CommSchedule]:
        """Skew-aware NIC-pool stagger for CONCURRENT all-to-all
        exchanges: offsets are assigned hottest exchange first (largest
        max per-destination slow bytes — the incast bound that decides
        who waits), so the skewed flows grab lane 0's head-of-line slot
        and the cold tail interleaves behind them; uniform exchanges
        keep ``NicPool.stagger``'s plain round-robin (list order)."""
        def heat(s: Optional[CommSchedule]) -> float:
            if s is None:
                return 0.0
            return max((max(l.dest_sizes) for l in s.slow_legs
                        if l.dest_sizes), default=0.0)

        order = sorted(range(len(schedules)),
                       key=lambda i: -heat(schedules[i]))
        offs = self.nic_pool.stagger([schedules[i] for i in order])
        out: List[Optional[CommSchedule]] = [None] * len(schedules)
        for k, i in enumerate(order):
            s = schedules[i]
            out[i] = s if s is None else s.with_lane_offset(offs[k])
        return out

    def _section_estimate(self, sec: Section):
        """Cost estimate of one section under its chosen schedule; returns
        (seconds, slow_tier_bytes_per_chip)."""
        if sec.sync.strategy == "flat" or sec.schedule is None \
                or sec.schedule.strategy == "flat":
            est = self.cost.flat_ring(sec.nbytes)
            return est.total_s, est.dcn_bytes_per_chip
        est = self.cost.from_schedule(sec.schedule, mem=True)
        # on a 1-tier fabric the single tier doubles as "slowest" in the
        # estimate accessors, but there is no DCN leg to report
        slow_by = est.slow_bytes_per_chip if self.fabric.depth > 1 else 0.0
        return est.total_s, slow_by

    # -- public API -------------------------------------------------------------
    def plan(self, shapes: Dict[str, ShapeDtype],
             bucket_bytes: int = 4 << 20,
             avoid_dims: Optional[Dict[str, frozenset]] = None,
             local_shapes: Optional[Dict[str, Tuple[int, ...]]] = None) -> SyncPlan:
        """``shapes``: flat {path: ShapeDtypeStruct} of the gradient tree.

        Large tensors become their own Section; small leaves are packed
        into flat buckets of ~``bucket_bytes`` (2 MiB "huge page" Sections
        in the paper; we default to 4 MiB).  ``avoid_dims`` marks dims
        already sharded over auto axes (TP) per path; ``local_shapes``
        gives the per-TP-shard block shapes the sync actually operates on
        (divisibility decisions use these).
        """
        avoid_dims = avoid_dims or {}
        local_shapes = local_shapes or {}
        if self.keep_report:
            from repro_torch.obs.plan_report import PlanReport
            self.report = PlanReport()
        sections: List[Section] = []
        small: List[Tuple[str, ShapeDtype]] = []
        for path, sds in sorted(shapes.items()):
            nbytes = int(np.prod(sds.shape)) * sds.dtype.itemsize
            lshape = tuple(local_shapes.get(path, sds.shape))
            model_sharded = lshape != tuple(sds.shape)
            if nbytes >= bucket_bytes or model_sharded:
                cfg, sd, sched = self._search_section(
                    lshape, avoid_dims.get(path, frozenset()),
                    report_name=path.replace("/", "."))
                if cfg.strategy == "flat":
                    sd = -1
                numel = int(np.prod(sds.shape))
                sections.append(Section(
                    # '.'-separated name: section names are dict keys in the
                    # sync state and must not collide with tree-path '/'
                    name=path.replace("/", "."), leaf_paths=(path,),
                    numel=numel, dtype=str(sds.dtype), scatter_dim=sd,
                    sync=cfg, model_sharded=model_sharded, schedule=sched))
            else:
                small.append((path, sds))
        # pack small leaves into flat bucket Sections
        bucket: List[Tuple[str, ShapeDtype]] = []
        bucket_numel = 0

        def flush():
            nonlocal bucket, bucket_numel
            if not bucket:
                return
            numel = bucket_numel
            # buckets are packed flat and zero-padded to the full fast-tier
            # product (grad_sync._bucket_pack), so the schedule plans the
            # PADDED extent
            padded = numel + ((-numel) % max(self.nf, 1))
            cfg, _, sched = self._search_section(
                (padded,),
                report_name=(f"bucket[{bucket[0][0].replace('/', '.')}"
                             f"...x{len(bucket)}]"))
            depth = self.n_fast_tiers if cfg.scatter_depth < 0 \
                else cfg.scatter_depth
            chunks = self._adjust_chunks((padded,), 0, cfg.chunks, depth)
            if chunks != cfg.chunks:
                stg = sched.staging if sched is not None else None
                cfg = replace(cfg, chunks=chunks)
                sched = self._build(cfg, (padded,), 0,
                                    "float32").with_staging(stg)
            sections.append(Section(
                name=f"bucket[{bucket[0][0].replace('/', '.')}...x{len(bucket)}]",
                leaf_paths=tuple(p for p, _ in bucket), numel=numel,
                dtype="float32", scatter_dim=-1,
                sync=cfg, schedule=sched))
            bucket, bucket_numel = [], 0

        for path, sds in small:
            bucket.append((path, sds))
            bucket_numel += int(np.prod(sds.shape))
            if bucket_numel * 4 >= bucket_bytes:
                flush()
        flush()

        if self.stagger_lanes:
            sections = self._stagger_sections(sections)
        plan = SyncPlan(sections, report=self.report)
        # aggregate estimates
        tot, dcn = 0.0, 0.0
        for s in plan.sections:
            est_s, est_dcn = self._section_estimate(s)
            tot += est_s
            dcn += est_dcn
        plan.est_total_s = tot
        plan.est_dcn_bytes_per_chip = dcn
        return plan

    def _stagger_sections(self, sections: List[Section]) -> List[Section]:
        """NIC-pool stagger: concurrent Sections (bucket slow-legs
        especially) hit the pool together, so ask the arbiter for a phase
        offset per Section and rotate each schedule's slow sub-flow issue
        order (``CommSchedule.with_lane_offset`` — cost- and
        numerics-invariant; stored on the schedule, honored by
        ``collectives.lower_all_reduce``, serialized by
        ``SyncPlan.to_json``)."""
        offs = self.nic_pool.stagger([s.schedule for s in sections])
        out = []
        for sec, off in zip(sections, offs):
            if off and sec.schedule is not None:
                sec = replace(sec,
                              schedule=sec.schedule.with_lane_offset(off))
            out.append(sec)
        return out

    def _adjust_chunks(self, shape, scatter_dim, chunks, depth=None) -> int:
        """Chunking flattens the fast-tier-scattered shard; ensure
        divisibility of the shard the slow leg actually sees."""
        if scatter_dim < 0:
            return 1
        nf = self._prefix_prod(depth) if depth is not None else self.nf
        numel = int(np.prod(shape)) // max(nf, 1)
        c = min(chunks, self.max_chunks)
        while c > 1 and numel % c != 0:
            c -= 1
        return c
