"""Observability for the port: traces, metrics, audits — the port's copy
of ``repro.obs``.

  * :mod:`repro_torch.obs.trace` — a fabric-simulator run (plus the
    predicted schedule timeline) as Chrome-trace / Perfetto JSON;
  * :mod:`repro_torch.obs.metrics` — the counters/gauges/timers JSONL
    logger of the train and serve loops;
  * :mod:`repro_torch.obs.audit` — the sim↔price drift auditor;
  * :mod:`repro_torch.obs.plan_report` — the planner's candidate sweep
    (``Planner(keep_report=True)``) and ``PlanDiff`` (``Planner.replan``);
  * :mod:`repro_torch.obs.capture` — an observer hook over ``simulate``.

Each is a copy of its ``repro.obs`` original (only the imports differ);
``tests/test_torch_planner.py`` holds them to it.
"""
from repro_torch.obs.audit import (DriftReport, Expectation, LegDrift,
                                   auto_expectations, compare)
from repro_torch.obs.capture import capture, export_observation
from repro_torch.obs.metrics import MetricsLogger, git_sha
from repro_torch.obs.plan_report import Candidate, PlanReport, SectionReport
from repro_torch.obs.trace import to_chrome_trace, write_chrome_trace

__all__ = [
    "Candidate", "DriftReport", "Expectation", "LegDrift", "MetricsLogger",
    "PlanReport", "SectionReport", "auto_expectations", "capture", "compare",
    "export_observation", "git_sha", "to_chrome_trace", "write_chrome_trace",
]
