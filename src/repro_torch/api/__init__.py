"""Batch-native scheduler API (port of ``repro/api``): the ``Scheduler``
contract, ``BatchDecision``, and the legacy ``schedule()`` adapter with
``SlotDecision`` and its converters; the adapter's ``obs_mode="cluster"``
gives a legacy scheduler the object ``Cluster`` view that the frozen
oracle (``sim/reference.py``) reads."""
from repro_torch.api.adapter import (LegacyOnlyView, LegacySchedulerAdapter,
                                     ensure_batch_scheduler)
from repro_torch.api.contract import (BatchDecision, Scheduler, SlotDecision,
                                      batch_to_slot_decision,
                                      schedule_via_batch,
                                      slot_to_batch_decision)

__all__ = [
    "BatchDecision", "Scheduler", "SlotDecision",
    "batch_to_slot_decision", "slot_to_batch_decision", "schedule_via_batch",
    "LegacyOnlyView", "LegacySchedulerAdapter", "ensure_batch_scheduler",
]
