"""The paper's baselines (port of ``repro/baselines``): SkyLB, SDIB,
round-robin and reactive OT on the batch contract, and the per-slot MILP."""
from repro_torch.baselines.milp import MilpScheduler
from repro_torch.baselines.reactive_ot import ReactiveOTScheduler
from repro_torch.baselines.rr import RoundRobinScheduler
from repro_torch.baselines.sdib import SDIBScheduler
from repro_torch.baselines.skylb import SkyLBScheduler
