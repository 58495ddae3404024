"""DFabric core of the port: the copied planner stack (topology, CommSchedule
IR, cost model, planner, NIC- and memory-pool arbiters) and the collectives
that lower its schedules on torch.distributed."""
