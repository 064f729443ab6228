"""Theoretical machinery of Appendix A (port of ``repro/core/theory.py``):
K0 estimation (Thm 2), Lipschitz constants via finite differences
(Appendix B), and the Thm-3 advantage condition
(1 - 1/s)/eps > (L_R + beta*L_P) / (alpha*K0).  Host numpy, but for the
reactive OT plans, which are one (T, R) launch of the Sinkhorn kernel."""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.ot import slot_routing_probs


def estimate_k0(switch_costs: np.ndarray) -> float:
    """K0 = E[||A_t - A_{t-1}||_F^2] of a memoryless (reactive) method
    (Thm 2: converges to a method-independent constant)."""
    return float(np.mean(switch_costs))


def estimate_k0_from_reactive(n_regions: int, traffic: np.ndarray,
                              capacity: np.ndarray, power_cost: np.ndarray,
                              latency: np.ndarray, reg: float = 0.05, *,
                              device="cuda") -> float:
    """Analytic route: run per-slot OT plans over a traffic trace and
    measure consecutive-plan switching cost (the reactive upper-bound
    method of Thm 1)."""
    probs = slot_routing_probs(traffic, capacity, power_cost, latency,
                               reg=reg, device=resolve_device(device)
                               ).cpu().numpy()
    deltas = np.sum((probs[1:] - probs[:-1]) ** 2, axis=(1, 2))
    return float(deltas.mean())


def estimate_lipschitz(cost_fn: Callable[[np.ndarray], float],
                       a0: np.ndarray, *, eps: float = 1e-3,
                       n_probes: int = 16, seed: int = 0) -> float:
    """L ~ max |cost(A + dA) - cost(A)| / ||dA||_F by finite differences
    over random row-stochastic-preserving perturbations."""
    rng = np.random.default_rng(seed)
    base = cost_fn(a0)
    best = 0.0
    for _ in range(n_probes):
        d = rng.standard_normal(a0.shape)
        d -= d.mean(axis=1, keepdims=True)      # keep rows sum-preserving
        d *= eps / max(np.linalg.norm(d), 1e-12)
        a1 = np.clip(a0 + d, 1e-9, None)
        a1 = a1 / a1.sum(axis=1, keepdims=True)
        dn = np.linalg.norm(a1 - a0)
        if dn < 1e-12:
            continue
        best = max(best, abs(cost_fn(a1) - base) / dn)
    return best


@dataclasses.dataclass
class AdvantageCondition:
    """Thm 3 bookkeeping."""
    k0: float
    l_r: float
    l_p: float
    alpha: float = 1.0
    beta: float = 1.0

    def _rhs(self) -> float:
        return (self.l_r + self.beta * self.l_p) / (self.alpha * self.k0)

    def holds(self, eps: float, s: float) -> bool:
        if s <= 1.0 or eps <= 0.0:
            return False
        return (1.0 - 1.0 / s) / eps > self._rhs()

    def min_s(self, eps: float) -> float:
        """Smallest switching-improvement factor s that satisfies Thm 3 at
        deviation eps."""
        x = self._rhs() * eps
        if x >= 1.0:
            return float("inf")
        return 1.0 / (1.0 - x)

    def max_eps(self, s: float) -> float:
        """Largest OT deviation eps tolerable at switching factor s."""
        if s <= 1.0:
            return 0.0
        return (1.0 - 1.0 / s) / self._rhs()

    def upper_bound_cost(self, per_slot_ot_cost: float, n_slots: int
                         ) -> float:
        """Corollary 1: reactive lower bound on total expected cost."""
        return per_slot_ot_cost * n_slots + self.alpha * self.k0 * (n_slots - 1)
