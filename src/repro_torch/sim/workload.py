"""Compat shim (port of ``repro/sim/workload.py``) — the workload
subsystem lives in ``repro_torch.workload``.

Imports of ``repro_torch.sim.workload.Task`` etc. keep working; the
legacy object implementation lives in ``repro_torch.workload.legacy``,
and the array-native subsystem — ``TaskBatch``, ``StreamingWorkload``,
the scenario registry, trace replay — in the rest of the
``repro_torch.workload`` package.
"""
from repro_torch.workload.legacy import (Task, Workload, generate_traffic,
                                         make_workload)

__all__ = ["Task", "Workload", "generate_traffic", "make_workload"]
