"""Batch-native scheduler API (port of ``repro/api``; the legacy
``schedule()`` adapter is not ported)."""
from repro_torch.api.contract import BatchDecision, Scheduler
