"""Observability, counters tier (port of ``repro/obs``)."""
from repro_torch.obs.counters import Counters
