"""Demand predictor (Appendix B), port of ``repro/core/predictor.py``: an
MLP over K = 5 slots of (U, Q, H) history, and the EMA forecast.

Input  : concat of the last K slots' per-region features -> (K * 3R,)
Hidden : 512 -> 256, ReLU
Output : R-dim softmax, the predicted *distribution* of next-slot arrivals.
Training minimizes MSE against the realized normalized arrivals plus L2
(lambda = 1e-4) on the weights, with the port's Adam
(``optim/adam.py``), on ``device``; the minibatch order comes from
``np.random.default_rng(seed)`` as in the reference, so both see the same
batches.  ``make_dataset`` and the EMA forecast stay host numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import Mlp, he_init
from repro_torch.optim.adam import Adam, apply_updates

K_HIST = 5                    # slots of history the macro layer keeps
HIDDEN = (512, 256)


class Predictor(Mlp):
    """(..., K, 3R) history -> (..., R) softmax distribution."""

    def __init__(self, n_regions: int, device):
        super().__init__([K_HIST * 3 * n_regions, *HIDDEN, n_regions],
                         device)

    def forward(self, hist: torch.Tensor) -> torch.Tensor:
        x = super().forward(hist.reshape(*hist.shape[:-2], -1))
        return torch.softmax(x, dim=-1)


def init_predictor(gen: torch.Generator, n_regions: int) -> Predictor:
    return he_init(Predictor(n_regions, gen.device), gen)


def predict(net: Predictor, hist: torch.Tensor) -> torch.Tensor:
    """hist: (..., K, 3R) -> (..., R) softmax distribution."""
    return net(hist)


def loss_fn(net: Predictor, hist: torch.Tensor, target: torch.Tensor,
            l2: float = 1e-4) -> torch.Tensor:
    pred = predict(net, hist)
    mse = torch.mean(torch.sum(torch.square(pred - target), dim=-1))
    reg = sum(torch.sum(torch.square(layer.weight)) for layer in net.layers)
    return mse + l2 * reg


@dataclasses.dataclass
class PredictorTrainer:
    n_regions: int
    lr: float = 1e-3
    seed: int = 0
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.net = init_predictor(
            torch.Generator(device=self.device).manual_seed(self.seed),
            self.n_regions)
        self.opt = Adam(lr=self.lr)
        self.opt_state = self.opt.init(list(self.net.parameters()))

    def step(self, hist: torch.Tensor, target: torch.Tensor
             ) -> torch.Tensor:
        """One Adam step on a minibatch; returns its loss, on ``device``."""
        params = list(self.net.parameters())
        loss = loss_fn(self.net, hist, target)
        grads = torch.autograd.grad(loss, params)
        updates, self.opt_state = self.opt.update(grads, self.opt_state,
                                                  params)
        apply_updates(params, updates)
        return loss.detach()

    def fit(self, hist: np.ndarray, target: np.ndarray, *, epochs: int = 50,
            batch: int = 64) -> list:
        """hist: (N, K, 3R); target: (N, R) normalized arrivals.  Returns
        the mean loss of each epoch (one read from ``device`` an epoch)."""
        n = hist.shape[0]
        rng = np.random.default_rng(self.seed)
        h = torch.as_tensor(np.asarray(hist, np.float32), device=self.device)
        y = torch.as_tensor(np.asarray(target, np.float32),
                            device=self.device)
        losses = []
        for _ in range(epochs):
            order = torch.as_tensor(rng.permutation(n), device=self.device)
            ep = torch.zeros((), dtype=torch.float64, device=self.device)
            for i in range(0, n, batch):
                idx = order[i:i + batch]
                ep += self.step(h[idx], y[idx]).double() * len(idx)
            losses.append(float(ep) / n)
        return losses

    @torch.no_grad()
    def __call__(self, hist: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(hist, np.float32), device=self.device)
        return predict(self.net, x).cpu().numpy()


def make_dataset(arrivals: np.ndarray, util: np.ndarray, queue: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Build (hist, target) pairs from slot-level traces.

    arrivals/util/queue: (T, R).  hist feature per slot = [U, Q, H] where H
    is the normalized arrival distribution; one strided view over the
    slot axis."""
    t_total, r = arrivals.shape
    h = arrivals / np.maximum(arrivals.sum(1, keepdims=True), 1e-9)
    feats = np.concatenate([util, queue / np.maximum(queue.max(), 1.0), h],
                           axis=1)                       # (T, 3R)
    n = t_total - 1 - K_HIST                 # windows feats[t-K:t]
    if n <= 0:
        return np.asarray([], np.float32), np.asarray([], np.float32)
    xs = np.lib.stride_tricks.sliding_window_view(
        feats, K_HIST, axis=0)[:n]           # (n, 3R, K) strided view
    return (np.ascontiguousarray(xs.transpose(0, 2, 1)).astype(np.float32),
            h[K_HIST + 1:t_total].astype(np.float32))


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
