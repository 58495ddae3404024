"""Open-loop serving workloads: who arrives, when, and how big.

The fleet simulator is OPEN-LOOP (the serving-systems sense): sessions
arrive on their own clock — a Poisson process or a recorded trace — and
do NOT slow down when the system backs up, so queueing delay shows up in
the tail instead of silently throttling the offered load (the classic
closed-loop measurement bug).  This module owns that arrival side:

  * :class:`SLOClass` — a named service tier: an arbiter ``priority``
    (mapped onto the NIC/memory pools' weighted max-min machinery) and a
    ``slack`` multiplier turning a session's SOLO price into its
    deadline;
  * :class:`Session` — one inference request: arrival time, prompt and
    output token counts, its SLO class, and a traffic ``kind`` (dense
    all-gather prefill vs MoE all-to-all prefill);
  * :func:`generate_sessions` — the seeded synthetic generator
    (exponential inter-arrivals, lognormal token lengths), reproducible
    bit for bit from ``WorkloadConfig.seed``;
  * :func:`sessions_from_trace` / :func:`load_trace` — replay recorded
    arrivals (JSONL rows) through the same :class:`Session` shape.

Everything here is stdlib-only and fabric-free: turning sessions into
:class:`~repro.sim.fabric_sim.Tenant` programs is ``fleet.py``'s job.

A copy of ``repro.serve_sim.workload`` for the port (the port imports nothing of
``repro``): only its imports differ.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

# the default service tiers: interactive traffic outranks the batch lane
# 4:1 on the arbiters (the weight ratio is the experiment knob, not a
# magic constant) and must finish within 2x its solo price; batch tolerates
# 8x.  Priorities must be > 0 (LaneRequest/MemRequest contract).
DEFAULT_SLO_CLASSES = None  # filled below (dataclass forward ref)


@dataclass(frozen=True)
class SLOClass:
    """One service tier: ``priority`` is the arbiter weight its sessions'
    flows carry (NicPool/MemPool weighted max-min — MUST be > 0), and
    ``slack`` turns a session's solo price into its deadline
    (``deadline = arrival + slack * solo_estimate``)."""

    name: str
    priority: float = 1.0
    slack: float = 4.0

    def __post_init__(self):
        if self.priority <= 0:
            raise ValueError(
                f"SLO class {self.name!r}: priority must be > 0 "
                f"(arbiter weight): {self.priority}")
        if self.slack <= 0:
            raise ValueError(
                f"SLO class {self.name!r}: slack must be > 0: {self.slack}")


DEFAULT_SLO_CLASSES = (
    SLOClass("interactive", priority=4.0, slack=2.0),
    SLOClass("batch", priority=1.0, slack=8.0),
)


@dataclass(frozen=True)
class Session:
    """One inference request as the fleet sees it: ``arrival`` seconds on
    the open-loop clock, ``prompt_tokens`` to prefill, ``output_tokens``
    to decode, its :class:`SLOClass`, and the prefill traffic ``kind``
    (``"dense"`` = all-gather burst, ``"moe"`` = all-to-all dispatch)."""

    uid: int
    arrival: float
    prompt_tokens: int
    output_tokens: int
    slo: SLOClass
    kind: str = "dense"

    def __post_init__(self):
        if self.prompt_tokens < 1 or self.output_tokens < 1:
            raise ValueError(
                f"session {self.uid}: needs >= 1 prompt and output token: "
                f"{self.prompt_tokens} / {self.output_tokens}")
        if self.kind not in ("dense", "moe"):
            raise ValueError(
                f"session {self.uid}: kind must be dense|moe: {self.kind!r}")

    @property
    def name(self) -> str:
        """The tenant-name stem (``s0017`` -> tenants ``s0017p`` /
        ``s0017d``); zero-padded so sorted tenant order is arrival
        order."""
        return f"s{self.uid:04d}"


@dataclass(frozen=True)
class WorkloadConfig:
    """The synthetic generator's knobs.

    ``rate`` is the offered load in sessions/second (Poisson:
    exponential inter-arrivals at mean ``1/rate``); token counts are
    lognormal (the shape every serving trace shows — a body of short
    prompts and a heavy tail) clamped to ``[1, max]``.  ``slo_mix``
    weights the SLO classes by name; ``moe_frac`` of sessions carry MoE
    all-to-all prefill traffic instead of the dense burst.  Everything
    is driven by one ``random.Random(seed)``, so a config is its own
    reproducibility statement."""

    rate: float = 50.0
    sessions: int = 24
    seed: int = 0
    prompt_mean_tokens: float = 512.0
    prompt_sigma: float = 0.6
    prompt_max_tokens: int = 4096
    output_mean_tokens: float = 64.0
    output_sigma: float = 0.5
    output_max_tokens: int = 512
    slo_mix: Tuple[Tuple[str, float], ...] = (("interactive", 0.5),
                                              ("batch", 0.5))
    moe_frac: float = 0.0

    def __post_init__(self):
        if self.rate <= 0 or self.sessions < 1:
            raise ValueError(
                f"need rate > 0 and sessions >= 1: {self.rate}/{self.sessions}")
        if not 0.0 <= self.moe_frac <= 1.0:
            raise ValueError(f"moe_frac must be in [0, 1]: {self.moe_frac}")
        if not self.slo_mix or any(w < 0 for _, w in self.slo_mix) \
                or sum(w for _, w in self.slo_mix) <= 0:
            raise ValueError(f"slo_mix needs positive weights: {self.slo_mix}")


def _lognormal_tokens(rng: random.Random, mean: float, sigma: float,
                      cap: int) -> int:
    """Lognormal token count with the requested ARITHMETIC mean (mu is
    back-solved: E[lognormal] = exp(mu + sigma^2/2)), clamped to
    [1, cap]."""
    import math
    mu = math.log(max(mean, 1.0)) - 0.5 * sigma * sigma
    return max(1, min(cap, int(round(rng.lognormvariate(mu, sigma)))))


def generate_sessions(cfg: WorkloadConfig,
                      classes: Sequence[SLOClass] = DEFAULT_SLO_CLASSES
                      ) -> List[Session]:
    """The seeded open-loop generator: ``cfg.sessions`` sessions with
    exponential inter-arrivals at ``cfg.rate``/s, lognormal token
    counts, SLO classes drawn from ``cfg.slo_mix``, and ``moe_frac`` of
    them carrying MoE prefill.  Same config -> the same session list,
    bit for bit (one ``random.Random(cfg.seed)`` drives every draw in a
    fixed order)."""
    by_name = {c.name: c for c in classes}
    for name, _ in cfg.slo_mix:
        if name not in by_name:
            raise ValueError(
                f"slo_mix names unknown class {name!r}; "
                f"have {sorted(by_name)}")
    rng = random.Random(cfg.seed)
    mix_names = [n for n, _ in cfg.slo_mix]
    mix_wts = [w for _, w in cfg.slo_mix]
    out: List[Session] = []
    t = 0.0
    for uid in range(cfg.sessions):
        t += rng.expovariate(cfg.rate)
        prompt = _lognormal_tokens(rng, cfg.prompt_mean_tokens,
                                   cfg.prompt_sigma, cfg.prompt_max_tokens)
        output = _lognormal_tokens(rng, cfg.output_mean_tokens,
                                   cfg.output_sigma, cfg.output_max_tokens)
        slo = by_name[rng.choices(mix_names, weights=mix_wts, k=1)[0]]
        kind = "moe" if rng.random() < cfg.moe_frac else "dense"
        out.append(Session(uid, t, prompt, output, slo, kind))
    return out


# ---------------------------------------------------------------------------
# Trace-driven arrivals
# ---------------------------------------------------------------------------


def sessions_from_trace(rows: Sequence[Mapping],
                        classes: Sequence[SLOClass] = DEFAULT_SLO_CLASSES
                        ) -> List[Session]:
    """Build sessions from recorded rows (dicts with ``arrival_s``,
    ``prompt_tokens``, ``output_tokens``, optional ``slo`` class name
    and ``kind``) — the trace-driven twin of :func:`generate_sessions`.
    Rows are sorted by arrival; uids are their sorted positions."""
    by_name = {c.name: c for c in classes}
    default = classes[0]
    parsed = sorted(rows, key=lambda r: float(r["arrival_s"]))
    out: List[Session] = []
    for uid, r in enumerate(parsed):
        slo_name = r.get("slo", default.name)
        if slo_name not in by_name:
            raise ValueError(
                f"trace row {uid} names unknown SLO class {slo_name!r}; "
                f"have {sorted(by_name)}")
        out.append(Session(uid, float(r["arrival_s"]),
                           int(r["prompt_tokens"]), int(r["output_tokens"]),
                           by_name[slo_name], str(r.get("kind", "dense"))))
    return out


def load_trace(path: str,
               classes: Sequence[SLOClass] = DEFAULT_SLO_CLASSES
               ) -> List[Session]:
    """Load a JSONL arrival trace (one ``sessions_from_trace`` row per
    line; blank lines and ``#`` comments skipped)."""
    rows: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(json.loads(line))
    return sessions_from_trace(rows, classes)
