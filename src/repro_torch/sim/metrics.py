"""Evaluation metrics (port of ``repro/sim/metrics.py``): response time,
load balance (Eq 11), total cost, switch counts, prediction accuracy
(Eq 12)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def finite_or_nan(x):
    """±inf becomes nan, so every exported value is finite or an explicit
    "no data" nan; finite values pass through bitwise untouched."""
    arr = np.asarray(x, np.float64)
    if np.isinf(arr).any():
        arr = np.where(np.isinf(arr), np.nan, arr)
        return arr if arr.ndim else float(arr)
    return x


def load_balance_coefficient(utils: np.ndarray) -> float:
    """Eq 11: LB = 1 / (1 + CV) over active-server utilizations."""
    if utils.size == 0:
        return 1.0
    mean = float(np.mean(utils))
    if mean <= 1e-9:
        return 1.0
    cv = float(np.std(utils)) / mean
    return 1.0 / (1.0 + cv)


def prediction_accuracy(pred: np.ndarray, actual: np.ndarray,
                        eps: float = 1e-6) -> float:
    """Eq 12: PA = exp(-mean_t |F_pred - F_actual| / (F_actual + eps))."""
    rel = np.abs(pred - actual) / (np.abs(actual) + eps)
    return float(np.exp(-np.mean(rel)))


@dataclasses.dataclass
class MetricsAggregator:
    slot_seconds: float = 45.0

    def __post_init__(self):
        self.response_times: List[float] = []
        self.wait_times: List[float] = []
        self.work_times: List[float] = []
        self.net_times: List[float] = []
        self.queue_by_slot: List[float] = []
        self.lb_by_slot: List[float] = []
        self.power_cost_by_slot: List[float] = []
        self.switch_cost_by_slot: List[float] = []
        self.overhead_by_slot: List[float] = []
        self.switch_count_by_slot: List[int] = []
        self.completed = 0
        self.dropped = 0
        self.completion_slots: List[int] = []
        self.drops_by_slot: Dict[int, int] = {}

    def record_completion(self, task, t: int, *, wait_s: float, work_s: float,
                          net_s: float) -> None:
        """One completion (the per-object oracle's path)."""
        self.completed += 1
        self.response_times.append(wait_s + work_s + net_s)
        self.wait_times.append(wait_s)
        self.work_times.append(work_s)
        self.net_times.append(net_s)
        self.completion_slots.append(t)

    def record_completions(self, t: int, wait_s, work_s, net_s) -> None:
        """Bulk completion record for the engine's grouped apply."""
        wait = np.asarray(finite_or_nan(np.asarray(wait_s, np.float64)),
                          np.float64)
        if wait.size == 0:
            return
        work = np.asarray(finite_or_nan(np.asarray(work_s, np.float64)),
                          np.float64)
        net = np.asarray(finite_or_nan(np.asarray(net_s, np.float64)),
                         np.float64)
        self.completed += int(wait.size)
        self.response_times.extend((wait + work + net).tolist())
        self.wait_times.extend(wait.tolist())
        self.work_times.extend(work.tolist())
        self.net_times.extend(net.tolist())
        self.completion_slots.extend([t] * int(wait.size))

    def record_drop(self, task, t: int) -> None:
        self.record_drops(1, t)

    def record_drops(self, n: int, t: int) -> None:
        n = int(n)
        if n:
            self.dropped += n
            t = int(t)
            self.drops_by_slot[t] = self.drops_by_slot.get(t, 0) + n

    def drops_series(self, n_slots: int) -> np.ndarray:
        """(n_slots,) dense per-slot drop counts (zeros where none)."""
        out = np.zeros(n_slots, np.int64)
        for t, n in self.drops_by_slot.items():
            if 0 <= t < n_slots:
                out[t] = n
        return out

    def record_slot(self, t: int, *, utils: np.ndarray, power_cost: float,
                    switch_cost: float, overhead_s: float, n_switches: int,
                    queue_tasks: float) -> None:
        self.lb_by_slot.append(load_balance_coefficient(utils))
        self.power_cost_by_slot.append(power_cost)
        self.switch_cost_by_slot.append(switch_cost)
        self.overhead_by_slot.append(overhead_s)
        self.switch_count_by_slot.append(n_switches)
        self.queue_by_slot.append(queue_tasks)

    def summary(self) -> Dict[str, float]:
        # zero completions read as "no data" (nan), never a perfect 0.0 s
        nan = float("nan")
        rt = np.array(self.response_times) if self.response_times else None
        out = {
            "mean_response_s": float(rt.mean()) if rt is not None else nan,
            "p50_response_s": float(np.percentile(rt, 50)) if rt is not None else nan,
            "p95_response_s": float(np.percentile(rt, 95)) if rt is not None else nan,
            "p99_response_s": float(np.percentile(rt, 99)) if rt is not None else nan,
            "mean_wait_s": float(np.mean(self.wait_times)) if self.wait_times else nan,
            "mean_work_s": float(np.mean(self.work_times)) if self.work_times else nan,
            "mean_net_s": float(np.mean(self.net_times)) if self.net_times else nan,
            "load_balance": float(np.mean(self.lb_by_slot)) if self.lb_by_slot else 1.0,
            "power_cost_total": float(np.sum(self.power_cost_by_slot)),
            "switch_cost_total": float(np.sum(self.switch_cost_by_slot)),
            "operational_overhead": float(np.sum(self.overhead_by_slot))
            / max(len(self.overhead_by_slot), 1) / self.slot_seconds,
            "model_switches": int(np.sum(self.switch_count_by_slot)),
            "completed": self.completed,
            "dropped": self.dropped,
            "completion_rate": self.completed
            / max(self.completed + self.dropped, 1),
            "mean_queue_tasks": float(np.mean(self.queue_by_slot))
            if self.queue_by_slot else 0.0,
        }
        return {k: (finite_or_nan(v) if isinstance(v, float) else v)
                for k, v in out.items()}
