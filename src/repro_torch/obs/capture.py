"""Capture ``simulate`` calls and export them as trace + drift artifacts.

``capture()`` registers a :func:`repro.sim.fabric_sim.add_observer` hook
for the duration of a ``with`` block and yields the list of
:class:`~repro.sim.fabric_sim.SimObservation` records — one per
``simulate`` call, appended AFTER the result is fully constructed, so
capturing is bitwise non-invasive to the simulation itself.

``export_observation`` turns one observation into the two artifacts the
benchmark harness writes per figure: a Perfetto-loadable
``<name>.trace.json`` (simulated + predicted tracks + pool counters) and
a :class:`~repro.obs.audit.DriftReport` judging every leg against its
contract class.

A copy of ``repro.obs.capture`` for the port (the port imports nothing of
``repro``): only its imports differ.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Iterator, List, Tuple

from repro_torch.obs.audit import DriftReport, auto_expectations, compare
from repro_torch.obs.trace import to_chrome_trace, write_chrome_trace
from repro_torch.sim import fabric_sim
from repro_torch.sim.fabric_sim import SimObservation


@contextmanager
def capture() -> Iterator[List[SimObservation]]:
    """Collect every ``simulate`` call made inside the block.

    >>> with capture() as observations:
    ...     simulate(fab, tenants, cost=cm)
    >>> observations[0].result.makespan
    """
    observations: List[SimObservation] = []
    fabric_sim.add_observer(observations.append)
    try:
        yield observations
    finally:
        fabric_sim.remove_observer(observations.append)


def export_observation(obs: SimObservation, out_dir: str,
                       name: str) -> Tuple[str, DriftReport]:
    """Write ``<out_dir>/<name>.trace.json`` for one captured simulate
    call and return ``(trace_path, drift_report)``.  Expectations are
    derived automatically (:func:`~repro.obs.audit.auto_expectations`);
    the predicted tracks render each expectation's lower-bound
    estimate."""
    expectations = auto_expectations(obs)
    estimates = {k: e.lo for k, e in expectations.items()
                 if e.lo is not None}
    trace = to_chrome_trace(obs.result, estimates=estimates,
                            tenants=obs.tenants)
    path = write_chrome_trace(trace, os.path.join(out_dir,
                                                  f"{name}.trace.json"))
    report = compare(obs.result, expectations, tenants=obs.tenants)
    return path, report
