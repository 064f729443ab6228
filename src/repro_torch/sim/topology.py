"""Network topology (port of ``repro/sim/topology.py``).

Only the latency matrix is carried: ``make_topology`` builds its graphs
with networkx, which the port does not depend on.  Callers build the
matrix themselves (a seeded synthetic one, or the reference's
``make_topology(...).latency``) and ``graph`` stays optional.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class Topology:
    name: str
    n_regions: int
    bandwidth_gbps: float
    latency: np.ndarray          # (R, R) ms, symmetric
    graph: Optional[Any] = None
