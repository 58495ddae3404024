"""Discrete-event fabric simulation: replay CommSchedules against the
NIC-pool arbiter and the co-simulated memory pool
(``repro.sim.fabric_sim``).

A copy of ``repro.sim`` for the port (the port imports nothing of
``repro``): only its imports differ.
"""
from repro_torch.sim.fabric_sim import LegEvent, SimResult, Tenant, simulate

__all__ = ["LegEvent", "SimResult", "Tenant", "simulate"]
