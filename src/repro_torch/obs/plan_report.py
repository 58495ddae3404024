"""The planner's candidate sweep as a serializable audit artifact.

``Planner(keep_report=True)`` records EVERY candidate each search prices
— depth × chunks × codec × staging × path split (``_search_section``) and
chunks × path split × staging (``plan_all_to_all``) — with its priced
total and a rejection reason, into a :class:`PlanReport` that serializes
next to ``SyncPlan.to_json``.  The report answers "why this plan":
which shapes were searched, what each candidate cost, and by how much
the winner won (ties resolve to the earlier candidate — the planner's
documented tie-break order).

A copy of ``repro.obs.plan_report`` for the port (the port imports nothing of
``repro``): only its imports differ.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Candidate:
    """One priced candidate of a section search.  ``rejected`` is None
    for the winner, else the reason it lost."""

    total_s: float
    strategy: str
    scatter_depth: int
    chunks: int
    codec: Optional[str] = None
    mid_codec: Optional[str] = None
    staging: Optional[str] = None
    path_split: Optional[Tuple[Tuple[str, float], ...]] = None
    pipelined: bool = False
    describe: str = ""
    rejected: Optional[str] = None


@dataclass(frozen=True)
class SectionReport:
    """One search: every candidate priced for one section (or one
    all-to-all exchange), the winner's index, and the winner's schedule
    as searched (``CommSchedule.to_dict()`` — before any bucket chunk
    adjustment or lane-offset stagger the caller applies afterwards)."""

    name: str
    kind: str  # "section" | "all_to_all"
    shape: Tuple[int, ...]
    candidates: Tuple[Candidate, ...]
    winner: int
    winner_schedule: Optional[dict] = None


@dataclass
class PlanReport:
    sections: List[SectionReport] = field(default_factory=list)

    @staticmethod
    def build_section(name: str, kind: str, shape: Sequence[int],
                      priced: Sequence[Tuple[float, dict, object]]
                      ) -> SectionReport:
        """Assemble one :class:`SectionReport` from the search's priced
        list ``[(total_s, knob dict, schedule)]`` (list order = the
        planner's tie-break order).  The winner is the FIRST candidate
        at the minimum — exactly ``min(...)``'s choice — and every
        other candidate gets its rejection reason."""
        totals = [t for t, _, _ in priced]
        best = min(totals)
        win = totals.index(best)
        cands: List[Candidate] = []
        for i, (total, knobs, sched) in enumerate(priced):
            if i == win:
                reason = None
            elif total > best:
                reason = f"slower: +{(total - best) / max(best, 1e-30):.2%}"
            else:
                reason = "tie: earlier candidate wins"
            cands.append(Candidate(
                total_s=total,
                describe=sched.describe() if sched is not None else "",
                rejected=reason, **knobs))
        winner_sched = priced[win][2]
        return SectionReport(
            name=name, kind=kind, shape=tuple(int(s) for s in shape),
            candidates=tuple(cands), winner=win,
            winner_schedule=(winner_sched.to_dict()
                             if winner_sched is not None else None))

    # ---- serialization -----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps([asdict(s) for s in self.sections], indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PlanReport":
        sections = []
        for s in json.loads(text):
            cands = tuple(Candidate(
                **{**c, "path_split": (tuple((p, f) for p, f
                                             in c["path_split"])
                                       if c.get("path_split") else None)})
                for c in s["candidates"])
            sections.append(SectionReport(
                name=s["name"], kind=s["kind"], shape=tuple(s["shape"]),
                candidates=cands, winner=s["winner"],
                winner_schedule=s.get("winner_schedule")))
        return cls(sections)

    def describe(self) -> str:
        lines = [f"PlanReport: {len(self.sections)} searches"]
        for s in self.sections:
            w = s.candidates[s.winner]
            lines.append(
                f"  {s.name} [{s.kind}] shape={s.shape}: "
                f"{len(s.candidates)} candidates, winner "
                f"#{s.winner} {w.strategy} depth={w.scatter_depth} "
                f"chunks={w.chunks} staging={w.staging} "
                f"split={w.path_split} -> {w.total_s * 1e6:.2f} us")
            for i, c in enumerate(s.candidates):
                if i == s.winner:
                    continue
                lines.append(f"    #{i} {c.strategy} d={c.scatter_depth} "
                             f"c={c.chunks} stg={c.staging} "
                             f"split={c.path_split}: {c.rejected}")
        return "\n".join(lines)


# ---- plan-to-plan diffs (elastic replanning) -------------------------------

# the per-section knobs a replan can flip; ``staging`` lives on the built
# CommSchedule rather than the SyncConfig, so it is diffed separately
_SYNC_KNOBS = ("strategy", "scatter_depth", "chunks", "codec", "mid_codec",
               "pipeline", "path_split")


@dataclass(frozen=True)
class PlanDelta:
    """One knob that changed for one section between two plans."""

    section: str
    knob: str
    before: object
    after: object

    def describe(self) -> str:
        return f"{self.section}: {self.knob} {self.before!r} -> {self.after!r}"


@dataclass(frozen=True)
class PlanDiff:
    """What a replan changed and why.

    ``deltas`` lists every per-section knob flip between sections the two
    plans share (matched by name); ``added``/``removed`` name sections only
    one plan has (shapes appeared/vanished across the replan).  ``reason``
    is the caller's cause — typically the fabric degradation that forced
    the replan.  Totals are the plans' own ``est_total_s`` so the diff
    states the priced cost of the degradation alongside the knob story."""

    reason: str = ""
    deltas: Tuple[PlanDelta, ...] = ()
    added: Tuple[str, ...] = ()
    removed: Tuple[str, ...] = ()
    before_total_s: float = 0.0
    after_total_s: float = 0.0

    @property
    def changed(self) -> bool:
        return bool(self.deltas or self.added or self.removed)

    def describe(self) -> str:
        head = (f"PlanDiff ({self.reason}): " if self.reason
                else "PlanDiff: ")
        head += (f"{len(self.deltas)} knob change(s), "
                 f"est {self.before_total_s * 1e3:.3f} ms -> "
                 f"{self.after_total_s * 1e3:.3f} ms")
        lines = [head]
        lines += [f"  {d.describe()}" for d in self.deltas]
        lines += [f"  + section {n}" for n in self.added]
        lines += [f"  - section {n}" for n in self.removed]
        if not self.changed:
            lines.append("  (no per-section changes — totals repriced only)")
        return "\n".join(lines)


def _section_knobs(section) -> dict:
    knobs = {k: getattr(section.sync, k) for k in _SYNC_KNOBS}
    knobs["staging"] = getattr(section.schedule, "staging", None)
    return knobs


def diff_plans(old, new, reason: str = "") -> PlanDiff:
    """Diff two ``SyncPlan``s (duck-typed: anything with ``.sections``
    carrying ``.name``/``.sync``/``.schedule`` and ``.est_total_s``)
    section-by-section.  ``old`` may be None — every section of ``new``
    then reports as added, which lets callers treat "first plan on a
    degraded fabric" and "replan from a known-good plan" uniformly."""
    new_secs = {s.name: s for s in new.sections}
    old_secs = {} if old is None else {s.name: s for s in old.sections}
    deltas: List[PlanDelta] = []
    for name in sorted(set(old_secs) & set(new_secs)):
        before, after = _section_knobs(old_secs[name]), \
            _section_knobs(new_secs[name])
        for knob in (*_SYNC_KNOBS, "staging"):
            if before[knob] != after[knob]:
                deltas.append(PlanDelta(name, knob, before[knob],
                                        after[knob]))
    return PlanDiff(
        reason=reason,
        deltas=tuple(deltas),
        added=tuple(sorted(set(new_secs) - set(old_secs))),
        removed=tuple(sorted(set(old_secs) - set(new_secs))),
        before_total_s=0.0 if old is None else float(old.est_total_s),
        after_total_s=float(new.est_total_s))
