"""Interconnect topology — the DFabric hardware model, generalized to N tiers.

The paper studies exactly two tiers (rack-level CXL fabric + inter-rack
Ethernet).  Real deployments have more: intra-host NVLink/ICI, a rack-level
CXL fabric, and inter-rack Ethernet.  The general model here is a
:class:`FabricSpec`: an ordered list of :class:`Tier` entries from fastest
to slowest, each mapping to one mesh axis.  A hierarchical collective
reduce-scatters down the fast tiers, runs the striped (NIC-pool) leg on the
slowest tier, and all-gathers back up — see ``repro.core.collectives``.

:class:`TwoTierTopology` is kept as a thin compatibility constructor: all
existing call sites keep working, and ``.fabric`` exposes the equivalent
two-tier :class:`FabricSpec`.

A copy of ``repro.core.topology``.  The :class:`HardwareSpec` defaults are
the JAX package's constants, kept so that both packages plan alike; they
are not this port's card or fabric, which are not measured yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core.mempool import MemPoolSpec


@dataclass(frozen=True)
class HardwareSpec:
    """Per-chip hardware constants.  The defaults are the JAX package's
    (``repro.core.topology.HardwareSpec``), copied so that both packages
    price and plan alike; they describe neither the H100 nor its fabric."""

    peak_flops_bf16: float = 197e12  # FLOP/s
    hbm_bw: float = 819e9  # B/s
    hbm_bytes: float = 16e9  # device memory per chip
    ici_bw: float = 50e9  # B/s per fast-tier link ("CXL fabric" tier)
    ici_links: int = 4  # links per chip
    ici_latency: float = 1e-6  # s per hop
    dcn_bw: float = 6.25e9  # B/s per chip ("Ethernet" tier)
    dcn_latency: float = 10e-6  # s
    cxl_bw: float = 25e9  # B/s per chip (rack-level CXL switch, the 3-tier mid tier)
    cxl_latency: float = 2e-6  # s
    mem_channels_bw: Optional[float] = None  # host local memory bw (paper's C1)
    vmem_bytes: float = 128 * 2**20  # on-chip scratch per chip

    def with_ratio(self, ratio: float) -> "HardwareSpec":
        """Set DCN so that ici_bw : dcn_bw = ratio (paper Fig.2 uses 10:1)."""
        return replace(self, dcn_bw=self.ici_bw / ratio)


# ---------------------------------------------------------------------------
# N-tier fabric
# ---------------------------------------------------------------------------

# slow-leg routing vocabulary: "eth" is the implicit default (the slowest
# tier's own Ethernet pool lanes); the rest are alternative PathSpec routes
SLOW_PATHS = ("eth", "cxl", "loop")


@dataclass(frozen=True)
class PathSpec:
    """One ALTERNATIVE route for slow-tier traffic (multi-path striping).

    The default route for every slow sub-flow is the slowest tier itself
    (path ``"eth"``); a :class:`FabricSpec` may additionally declare

      * ``"cxl"`` — a CXL-fabric shortcut: an otherwise-idle fast-tier /
        expander route that can carry cross-group bytes while the fast
        tiers sit idle during the slow leg;
      * ``"loop"`` — loopback through a peer rack's switch.

    ``bw``/``latency``/``lanes`` are per-chip, exactly like :class:`Tier`;
    each declared path is arbitrated as its OWN lane group (a second
    ``NicPool``), so concurrent tenants contend per path independently.
    """

    name: str  # "cxl" | "loop"
    bw: float
    latency: float
    lanes: float = 1.0

    @property
    def rate(self) -> float:
        return self.bw * self.lanes


def cxl_shortcut_path(hw: Optional[HardwareSpec] = None,
                      lanes: float = 1.0) -> PathSpec:
    """The canonical CXL shortcut: the hardware's rack-level CXL switch
    numbers, usable as a second slow-leg route when the fast tier is idle."""
    hw = hw or HardwareSpec()
    return PathSpec("cxl", bw=hw.cxl_bw, latency=hw.cxl_latency, lanes=lanes)


def loopback_path(peer: Optional[HardwareSpec] = None,
                  lanes: float = 1.0, hops: int = 2) -> PathSpec:
    """The ``"loop"`` route: bounce slow-tier bytes off a PEER rack's
    switch and back (detour load balancing — a flow rides the peer's
    otherwise-idle uplink when its own rack's pool is hot).

    ``peer`` is the peer rack's hardware description (its Ethernet /
    DCN numbers are what the detour actually rides); the loop's
    bandwidth is the peer's per-chip DCN rate and its latency pays the
    DCN hop ``hops`` times (out to the peer switch and back — the
    detour's extra traversal, 2 by default).  PR 6 priced and simulated
    ``"loop"`` sub-flows but left the route underivable from a hardware
    spec; this is the constructor the planner's fabric builders use."""
    peer = peer or HardwareSpec()
    if hops < 1:
        raise ValueError(f"a loopback detour needs at least 1 hop: {hops}")
    return PathSpec("loop", bw=peer.dcn_bw,
                    latency=float(hops) * peer.dcn_latency, lanes=lanes)


@dataclass(frozen=True)
class Tier:
    """One interconnect tier.

    ``axis`` is the mesh axis the tier's collective runs over; ``size`` its
    extent (members per group).  ``bw``/``latency`` are per-chip.  ``lanes``
    is the NIC-pool multiplicity knob on the slowest tier (the paper's
    N + M added NICs, normalized per chip).
    """

    name: str  # "ici" | "cxl" | "dcn" | ...
    axis: str  # mesh axis ("data", "host", "pod", ...)
    size: int
    bw: float
    latency: float
    lanes: float = 1.0

    @property
    def rate(self) -> float:
        return self.bw * self.lanes


@dataclass(frozen=True)
class FabricSpec:
    """Ordered interconnect tiers, FASTEST FIRST (tiers[0] = intra-host,
    tiers[-1] = the slowest / striped leg).

    The hierarchical collective contract: reduce-scatter down
    ``fast_tiers`` in order, run the (optionally compressed / chunked)
    striped all-reduce on ``slowest``, all-gather back up in reverse.

    ``mem`` is the optional memory-pool description
    (:class:`~repro.core.mempool.MemPoolSpec`): when present, the
    simulator charges slow-tier flows for memory bandwidth, the cost
    model's ``from_schedule(mem=...)`` mode prices it, and the planner
    chooses a per-Section staging placement.  ``None`` means memory is
    unmodeled (infinite bandwidth) — every pre-mempool result is
    unchanged.
    """

    tiers: Tuple[Tier, ...]
    hw: HardwareSpec = field(default_factory=HardwareSpec)
    mem: Optional[MemPoolSpec] = None
    paths: Tuple[PathSpec, ...] = ()

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("FabricSpec needs at least one tier")
        axes = [t.axis for t in self.tiers]
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate tier axes: {axes}")
        for t in self.tiers:
            if t.size < 1:
                raise ValueError(f"tier {t.name}: size must be >= 1")
        names = [p.name for p in self.paths]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate path names: {names}")
        for p in self.paths:
            if p.name not in SLOW_PATHS or p.name == "eth":
                raise ValueError(
                    f"path {p.name!r}: must be one of "
                    f"{[n for n in SLOW_PATHS if n != 'eth']} "
                    "('eth' is the implicit slowest-tier route)")
            if p.bw <= 0 or p.lanes <= 0:
                raise ValueError(f"path {p.name}: bw and lanes must be > 0")

    # ---- structure ---------------------------------------------------------
    @property
    def depth(self) -> int:
        return len(self.tiers)

    @property
    def fast_tiers(self) -> Tuple[Tier, ...]:
        return self.tiers[:-1]

    @property
    def slowest(self) -> Tier:
        return self.tiers[-1]

    @property
    def fast_axes(self) -> Tuple[str, ...]:
        """Axes of the fast tiers, fastest first."""
        return tuple(t.axis for t in self.fast_tiers)

    @property
    def slow_axis(self) -> Optional[str]:
        return self.slowest.axis if self.depth > 1 else None

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(t.axis for t in self.tiers)

    @property
    def n_fast(self) -> int:
        n = 1
        for t in self.fast_tiers:
            n *= t.size
        return n

    @property
    def total_chips(self) -> int:
        n = 1
        for t in self.tiers:
            n *= t.size
        return n

    def members_below(self, i: int) -> int:
        """Product of the sizes of tiers strictly faster than tier ``i`` —
        the striping factor the tier-``i`` leg sees when every faster tier
        was reduce-scattered."""
        n = 1
        for t in self.tiers[:i]:
            n *= t.size
        return n

    # ---- aggregate rates ---------------------------------------------------
    @property
    def pool_rate(self) -> float:
        """Aggregate slow-tier bandwidth of one group's NIC pool."""
        return self.members_below(self.depth - 1) * self.slowest.rate

    @property
    def pool_lanes(self) -> float:
        """Total NIC-pool lanes of one slow-tier group (every member's
        per-chip ``lanes`` consolidated — the capacity a
        ``repro.core.nicpool.NicPool`` arbitrates)."""
        return self.members_below(self.depth - 1) * self.slowest.lanes

    @property
    def pool_hbm_bw(self) -> float:
        """Aggregate memory-pool bandwidth per slow-tier group."""
        return self.members_below(self.depth - 1) * self.hw.hbm_bw

    def tier_of_axis(self, axis: str) -> Optional[Tier]:
        for t in self.tiers:
            if t.axis == axis:
                return t
        return None

    # ---- multi-path slow-leg routes ----------------------------------------
    @property
    def path_names(self) -> Tuple[str, ...]:
        """All slow-leg routes, "eth" (the slowest tier itself) first."""
        return ("eth",) + tuple(p.name for p in self.paths)

    def path_named(self, name: str) -> Optional[PathSpec]:
        for p in self.paths:
            if p.name == name:
                return p
        return None

    def path_tier(self, name: str, leg_axis: Optional[str] = None,
                  leg_size: Optional[int] = None) -> Tier:
        """The effective :class:`Tier` a slow sub-flow on route ``name``
        is priced at: the slowest tier for ``"eth"`` (or any route this
        fabric does not declare — undeclared routes degrade to Ethernet
        so plans stay portable across fabrics), else a Tier with the
        path's bw/latency/lanes over the slow axis."""
        spec = self.path_named(name)
        if name == "eth" or spec is None:
            return self.slowest
        return Tier(spec.name,
                    leg_axis if leg_axis is not None else self.slowest.axis,
                    leg_size if leg_size is not None else self.slowest.size,
                    spec.bw, spec.latency, spec.lanes)

    def path_pool_lanes(self, name: str) -> float:
        """Total lanes of one slow-tier group on route ``name`` (the
        twin of :attr:`pool_lanes` for an alternative path)."""
        spec = self.path_named(name)
        per = self.slowest.lanes if spec is None else spec.lanes
        return self.members_below(self.depth - 1) * per

    def with_paths(self, *paths: PathSpec) -> "FabricSpec":
        """Fabric with the given alternative slow-leg routes declared."""
        return replace(self, paths=tuple(paths))

    # ---- conversions -------------------------------------------------------
    def as_two_tier(self) -> "TwoTierTopology":
        """Collapse to the legacy two-tier view: all fast tiers become one
        pod (rate of the FASTEST tier, the conservative choice for the
        legacy formulas), the slowest tier becomes the DCN leg."""
        hw = replace(self.hw,
                     ici_bw=self.tiers[0].bw,
                     ici_latency=self.tiers[0].latency,
                     dcn_bw=self.slowest.bw if self.depth > 1 else self.hw.dcn_bw,
                     dcn_latency=self.slowest.latency if self.depth > 1 else self.hw.dcn_latency)
        return TwoTierTopology(
            num_pods=self.slowest.size if self.depth > 1 else 1,
            pod_shape=(self.n_fast,) if self.depth > 1 else (self.tiers[0].size,),
            hw=hw,
            dcn_lanes=self.slowest.lanes if self.depth > 1 else 1.0)

    def replace(self, **kw) -> "FabricSpec":
        return replace(self, **kw)

    def with_slowest_bw(self, bw: float) -> "FabricSpec":
        """Fabric with the slowest tier's per-chip bandwidth overridden."""
        tiers = self.tiers[:-1] + (replace(self.slowest, bw=bw),)
        return replace(self, tiers=tiers)

    def with_mem(self, mem: Optional[MemPoolSpec]) -> "FabricSpec":
        """Fabric with the memory-pool description attached (None
        detaches it — back to the infinite-memory model)."""
        return replace(self, mem=mem)

    # ---- failure / degradation ---------------------------------------------
    def degrade(self, *, pool_lanes: float = 0.0,
                mem_devices: Sequence[str] = (),
                tier_members: Optional[Mapping[str, int]] = None
                ) -> "FabricSpec":
        """The POST-FAILURE fabric — the static twin of the runtime
        failure events (``NicPool.shrink`` / ``MemPool.drop_device`` /
        ``tenant_down``), so the planner can replan on what actually
        survives instead of the healthy spec.

          * ``pool_lanes`` removes that many lanes from the slowest
            tier's consolidated pool (:attr:`pool_lanes` drops by
            exactly that amount; the per-chip ``Tier.lanes`` scales
            down to match);
          * ``mem_devices`` drops the named devices from ``mem``;
          * ``tier_members`` maps a tier name or axis to how many
            members departed (the tier's ``size`` shrinks; at least one
            member must survive).
        """
        tiers = list(self.tiers)
        if pool_lanes:
            if self.depth <= 1:
                raise ValueError("fabric has no slow tier to take lanes from")
            total = self.pool_lanes
            if pool_lanes >= total:
                raise ValueError(
                    f"cannot drop {pool_lanes} of {total} pool lanes: "
                    "at least one lane must survive")
            per = (total - float(pool_lanes)) / self.members_below(self.depth - 1)
            tiers[-1] = replace(tiers[-1], lanes=per)
        for key, k in (tier_members or {}).items():
            for i, t in enumerate(tiers):
                if t.name == key or t.axis == key:
                    if int(k) >= t.size:
                        raise ValueError(
                            f"tier {t.name}: cannot lose {k} of {t.size} "
                            "members")
                    tiers[i] = replace(t, size=t.size - int(k))
                    break
            else:
                raise KeyError(f"no tier named {key!r} in "
                               f"{[t.name for t in self.tiers]}")
        mem = self.mem
        if mem_devices:
            if mem is None:
                raise ValueError("fabric has no memory model to degrade")
            names = set(mem_devices)
            unknown = names - {d.name for d in mem.devices}
            if unknown:
                raise KeyError(f"unknown memory devices: {sorted(unknown)}")
            devs = tuple(d for d in mem.devices if d.name not in names)
            if not devs:
                raise ValueError("cannot drop every memory device")
            mem = replace(mem, devices=devs)
        return replace(self, tiers=tuple(tiers), mem=mem)

    def describe(self) -> str:
        parts = [f"{t.name}[{t.axis}]x{t.size}@{t.bw/1e9:.1f}GB/s"
                 for t in self.tiers]
        return " -> ".join(parts)


def fabric_from_mesh_sizes(sizes: Dict[str, int],
                           hw: Optional[HardwareSpec] = None,
                           dcn_lanes: float = 1.0) -> FabricSpec:
    """Build a FabricSpec from mesh axis sizes using the canonical axis
    naming: "data" (+"model", folded into the fastest tier — TP chips have
    NICs and stripe cross-tier traffic too) = ICI, "host" = rack-level CXL
    fabric, "pod" = inter-rack Ethernet.  Axes absent from ``sizes`` or of
    size 1 are skipped, so the same code path yields 1-, 2- and 3-tier
    fabrics."""
    hw = hw or HardwareSpec()
    tiers = []
    n_ici = sizes.get("data", 1) * sizes.get("model", 1)
    if n_ici > 1:
        tiers.append(Tier("ici", "data", n_ici, hw.ici_bw, hw.ici_latency))
    if sizes.get("host", 1) > 1:
        tiers.append(Tier("cxl", "host", sizes["host"], hw.cxl_bw, hw.cxl_latency))
    if sizes.get("pod", 1) > 1:
        tiers.append(Tier("dcn", "pod", sizes["pod"], hw.dcn_bw, hw.dcn_latency,
                          lanes=dcn_lanes))
    if not tiers:
        tiers = [Tier("ici", "data", 1, hw.ici_bw, hw.ici_latency)]
    return FabricSpec(tiers=tuple(tiers), hw=hw)


# ---------------------------------------------------------------------------
# Two-tier compatibility constructor
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TwoTierTopology:
    """``num_pods`` pods ("racks"), each with ``pod_shape`` chips on ICI.

    Thin compatibility view over the general :class:`FabricSpec` (see
    ``.fabric``).  ``dcn_lanes`` is the NIC-pool multiplicity knob: how many
    DCN "NICs" each chip contributes to the pod's pool (paper's N + M added
    NICs, normalized per chip).  ``striped=False`` models the ToR baseline
    where only a single chip's NIC carries a cross-pod flow.
    """

    num_pods: int = 2
    pod_shape: Tuple[int, ...] = (16, 16)  # (data, model)
    hw: HardwareSpec = field(default_factory=HardwareSpec)
    dcn_lanes: float = 1.0

    @property
    def chips_per_pod(self) -> int:
        n = 1
        for s in self.pod_shape:
            n *= s
        return n

    @property
    def total_chips(self) -> int:
        return self.num_pods * self.chips_per_pod

    @property
    def fabric(self) -> FabricSpec:
        """The equivalent general fabric: one ICI tier + one DCN tier."""
        tiers = [Tier("ici", "data", self.chips_per_pod,
                      self.hw.ici_bw, self.hw.ici_latency)]
        if self.num_pods > 1:
            tiers.append(Tier("dcn", "pod", self.num_pods,
                              self.hw.dcn_bw, self.hw.dcn_latency,
                              lanes=self.dcn_lanes))
        return FabricSpec(tiers=tuple(tiers), hw=self.hw)

    # ---- aggregate tier bandwidths ----------------------------------------
    @property
    def pool_dcn_bw(self) -> float:
        """Aggregate cross-pod bandwidth of the whole NIC pool (per pod)."""
        return self.chips_per_pod * self.hw.dcn_bw * self.dcn_lanes

    @property
    def pool_hbm_bw(self) -> float:
        """Aggregate memory-pool bandwidth (per pod) — absorbs NIC-pool DMA."""
        return self.chips_per_pod * self.hw.hbm_bw

    @property
    def ici_bisection_bw(self) -> float:
        """Bisection bandwidth of the pod's ICI torus (both directions)."""
        # 2D torus bisection: 2 * min_dim wrap links * 2 dirs
        d = min(self.pod_shape) if len(self.pod_shape) > 1 else 1
        return 4.0 * d * self.hw.ici_bw

    def mesh_axis_tier(self, axis: str) -> str:
        """Which physical tier a mesh axis name maps to."""
        return "dcn" if axis == "pod" else "ici"

    def replace(self, **kw) -> "TwoTierTopology":
        return replace(self, **kw)


def as_fabric(topo) -> FabricSpec:
    """Normalize a TwoTierTopology | FabricSpec to a FabricSpec."""
    if isinstance(topo, FabricSpec):
        return topo
    return topo.fabric


def topology_from_mesh_sizes(sizes: Dict[str, int]):
    """Default hardware description for a mesh: an N-tier FabricSpec when
    a rack-level "host" axis is present, else the legacy TwoTierTopology
    (pod_shape = all non-pod axes)."""
    if sizes.get("host", 1) > 1:
        return fabric_from_mesh_sizes(sizes)
    return TwoTierTopology(
        num_pods=sizes.get("pod", 1),
        pod_shape=tuple(s for a, s in sizes.items()
                        if a not in ("pod", "host")) or (1,))


# canonical production topologies per the brief
def production_topology(multi_pod: bool = True) -> TwoTierTopology:
    return TwoTierTopology(num_pods=2 if multi_pod else 1, pod_shape=(16, 16))


def three_tier_fabric(num_pods: int = 2, hosts_per_pod: int = 4,
                      chips_per_host: int = 64,
                      hw: Optional[HardwareSpec] = None,
                      dcn_lanes: float = 1.0,
                      mem: Optional[MemPoolSpec] = None) -> FabricSpec:
    """The ROADMAP's target hierarchy: intra-host ICI ("data") -> rack-level
    CXL fabric ("host") -> inter-rack Ethernet ("pod")."""
    hw = hw or HardwareSpec()
    return FabricSpec(tiers=(
        Tier("ici", "data", chips_per_host, hw.ici_bw, hw.ici_latency),
        Tier("cxl", "host", hosts_per_pod, hw.cxl_bw, hw.cxl_latency),
        Tier("dcn", "pod", num_pods, hw.dcn_bw, hw.dcn_latency,
             lanes=dcn_lanes),
    ), hw=hw, mem=mem)


# the paper's FPGA prototype, for figure reproduction: 2 racks x 2 CNs,
# interconnect:network = 10:1
def paper_prototype_topology(ratio: float = 10.0, dcn_lanes: float = 1.0) -> TwoTierTopology:
    hw = HardwareSpec(ici_bw=50e9).with_ratio(ratio)
    return TwoTierTopology(num_pods=2, pod_shape=(2,), hw=hw, dcn_lanes=dcn_lanes)
