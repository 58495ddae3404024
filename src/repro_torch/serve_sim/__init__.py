"""Fleet-scale serving simulator: open-loop arrivals driven through the
contended pools (see ``workload`` for the arrival side, ``fleet`` for
the session -> Tenant expansion and the fleet scheduler).

A copy of ``repro.serve_sim`` for the port (the port imports nothing of
``repro``): only its imports differ.
"""
from repro_torch.serve_sim.fleet import (FleetConfig, FleetResult, SessionMetrics,
                                   SessionPlan, decode_schedule, plan_fleet,
                                   prefill_schedule, simulate_fleet,
                                   solo_estimate_s)
from repro_torch.serve_sim.workload import (DEFAULT_SLO_CLASSES, SLOClass, Session,
                                      WorkloadConfig, generate_sessions,
                                      load_trace, sessions_from_trace)

__all__ = [
    "DEFAULT_SLO_CLASSES", "FleetConfig", "FleetResult", "SLOClass",
    "Session", "SessionMetrics", "SessionPlan", "WorkloadConfig",
    "decode_schedule", "generate_sessions", "load_trace", "plan_fleet",
    "prefill_schedule", "sessions_from_trace", "simulate_fleet",
    "solo_estimate_s",
]
