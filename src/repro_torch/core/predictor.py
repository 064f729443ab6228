"""Demand forecast for the macro layer (port of the EMA part of
``repro/core/predictor.py``; the learned MLP predictor is not ported)."""
from __future__ import annotations

import numpy as np

K_HIST = 5                    # slots of history the macro layer keeps


class EmaPredictor:
    """Exponential moving average of recent arrival distributions (the
    forecast TORTA uses without a trained predictor).  Host numpy, as in
    the reference."""

    def __init__(self, n_regions: int, alpha: float = 0.4):
        self.alpha = alpha
        self.state = np.full((n_regions,), 1.0 / n_regions)

    def update(self, arrivals: np.ndarray) -> None:
        tot = arrivals.sum()
        if tot > 0:
            self.state = (1 - self.alpha) * self.state + \
                self.alpha * arrivals / tot

    def predict(self) -> np.ndarray:
        return self.state / self.state.sum()
