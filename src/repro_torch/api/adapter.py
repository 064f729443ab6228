"""Bridging legacy ``schedule()`` schedulers into the batch contract (port
of ``repro/api/adapter.py``)."""
from __future__ import annotations

from repro_torch.api.contract import (BatchDecision, Scheduler,
                                      slot_to_batch_decision)


class LegacySchedulerAdapter:
    """Wrap a ``schedule(obs, tasks) -> SlotDecision`` scheduler into the
    batch-native contract.

    ``obs_mode="state"`` (default) passes the engine's ``SlotObs``
    through unchanged; ``obs_mode="cluster"`` rebuilds the pre-refactor
    ``RefSlotObs`` (object ``Cluster`` view, ``ClusterState.to_cluster``)
    each slot, so the frozen oracle schedulers of ``sim/reference.py`` can
    be driven by the array engine, as the golden-parity checks do.
    """

    def __init__(self, scheduler, *, obs_mode: str = "state"):
        if not callable(getattr(scheduler, "schedule", None)):
            raise TypeError(
                f"{type(scheduler).__name__} has no schedule() method; "
                "LegacySchedulerAdapter wraps legacy object-path "
                "schedulers only")
        if obs_mode not in ("state", "cluster"):
            raise ValueError(f"unknown obs_mode: {obs_mode!r}")
        self.wrapped = scheduler
        self.obs_mode = obs_mode

    @property
    def name(self) -> str:
        return getattr(self.wrapped, "name", type(self.wrapped).__name__)

    def reset(self) -> None:
        if hasattr(self.wrapped, "reset"):
            self.wrapped.reset()

    def _convert_obs(self, obs):
        if self.obs_mode == "state":
            return obs
        from repro_torch.sim.reference import RefSlotObs
        return RefSlotObs(
            t=obs.t, latency=obs.latency, capacities=obs.capacities,
            total_capacities=obs.total_capacities, queue_s=obs.queue_s,
            queue_tasks=obs.queue_tasks, utilization=obs.utilization,
            power_prices=obs.power_prices, prev_alloc=obs.prev_alloc,
            arrivals_history=obs.arrivals_history,
            cluster=obs.state.to_cluster(), slot_seconds=obs.slot_seconds)

    def schedule_batch(self, obs, batch) -> BatchDecision:
        tasks = batch.to_tasks()
        decision = self.wrapped.schedule(self._convert_obs(obs), tasks)
        return slot_to_batch_decision(decision, batch)


class LegacyOnlyView:
    """Expose ONLY the legacy ``schedule()`` face of a scheduler (its
    ``schedule_batch`` is hidden), so the engine must route it through
    :class:`LegacySchedulerAdapter`."""

    def __init__(self, inner):
        self._inner = inner
        self.name = getattr(inner, "name", type(inner).__name__)

    def reset(self) -> None:
        if hasattr(self._inner, "reset"):
            self._inner.reset()

    def schedule(self, obs, tasks):
        return self._inner.schedule(obs, tasks)


def ensure_batch_scheduler(scheduler, *, force_adapter: bool = False):
    """Normalize any scheduler to the batch contract.

    Batch-native schedulers (``isinstance(s, api.Scheduler)`` and not
    opting out via ``supports_batch = False``) pass through; legacy
    ``schedule()``-only schedulers are wrapped in
    :class:`LegacySchedulerAdapter`; anything implementing neither
    contract raises.  ``force_adapter=True`` routes even a batch-native
    scheduler through its legacy ``schedule()`` method (the engine's
    ``batch_mode=False`` switch).
    """
    native = (isinstance(scheduler, Scheduler)
              and bool(getattr(scheduler, "supports_batch", True)))
    if native and not force_adapter:
        return scheduler
    if isinstance(scheduler, LegacySchedulerAdapter):
        return scheduler                     # already the adapter path
    if callable(getattr(scheduler, "schedule", None)):
        return LegacySchedulerAdapter(scheduler)
    if native:
        raise TypeError(
            f"{type(scheduler).__name__} is batch-native only (no legacy "
            "schedule() method), so the adapter path cannot be forced "
            "for it; drop batch_mode=False / force_adapter")
    raise TypeError(
        f"{type(scheduler).__name__} implements neither the batch-native "
        "scheduler contract (name, reset(), schedule_batch(obs, batch) -> "
        "BatchDecision) nor the legacy schedule(obs, tasks) contract. "
        "Implement schedule_batch, or wrap a legacy scheduler with "
        "repro_torch.api.LegacySchedulerAdapter.")
