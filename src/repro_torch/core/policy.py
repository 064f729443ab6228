"""PPO policy/value networks (Appendix B architecture), port of
``repro/core/policy.py``.

Policy: MLP (256, 512, 256) + ReLU; outputs Beta(alpha, beta) parameters
for every element of the R x R allocation matrix (softplus + 1 so
alpha, beta > 1: unimodal Betas).  Sampled raw matrices are row-normalized
into allocation actions; log-probs and entropy are computed on the raw
Beta samples.  Value: the same trunk -> scalar.

Random draws come from an explicit ``torch.Generator`` on the operands'
device (``torch.distributions`` takes none): a Beta draw is X / (X + Y)
of two standard-gamma draws.  Their bits differ from ``jax.random``'s,
their distributions do not.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

HIDDEN = (256, 512, 256)


class Mlp(nn.Module):
    """``x @ w + b`` layers with ReLU between them (the reference's
    ``_mlp``); ``nn.Linear.weight`` holds the reference's ``w``
    transposed."""

    def __init__(self, dims: Sequence[int], device):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, i, o, device=device)
            for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


def he_init(mlp: Mlp, gen: torch.Generator) -> Mlp:
    """He-normal weights (std sqrt(2 / fan-in)) and zero biases, drawn
    from ``gen`` on its device layer by layer, in place."""
    with torch.no_grad():
        for layer in mlp.layers:
            o, i = layer.weight.shape
            layer.weight.copy_(torch.randn((o, i), generator=gen,
                                           device=gen.device)
                               * (2.0 / i) ** 0.5)
            layer.bias.zero_()
    return mlp


class PolicyNet(nn.Module):
    """The ``policy`` MLP (obs -> 2 R^2 Beta parameters) and the ``value``
    MLP (obs -> 1)."""

    def __init__(self, obs_dim: int, n_regions: int, device):
        super().__init__()
        self.n_regions = n_regions
        self.policy = Mlp([obs_dim, *HIDDEN, 2 * n_regions * n_regions],
                          device)
        self.value = Mlp([obs_dim, *HIDDEN, 1], device)


def init_policy(gen: torch.Generator, obs_dim: int, n_regions: int
                ) -> PolicyNet:
    net = PolicyNet(obs_dim, n_regions, gen.device)
    he_init(net.policy, gen)
    he_init(net.value, gen)
    with torch.no_grad():
        # small final layer -> near-uniform Beta(~1.5, ~1.5) at init
        net.policy.layers[-1].weight.mul_(0.01)
    return net


def beta_params(net: PolicyNet, obs: torch.Tensor, n_regions: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    out = net.policy(obs)
    a, b = torch.chunk(out, 2, dim=-1)
    shape = (*obs.shape[:-1], n_regions, n_regions)
    # torch's softplus returns x past x = 20 where the reference takes
    # logaddexp(x, 0); the two differ there by less than float32's ulp
    alpha = (F.softplus(a) + 1.0).reshape(shape)
    beta = (F.softplus(b) + 1.0).reshape(shape)
    return alpha, beta


def value(net: PolicyNet, obs: torch.Tensor) -> torch.Tensor:
    return net.value(obs)[..., 0]


def sample_action(net: PolicyNet, obs: torch.Tensor, gen: torch.Generator,
                  n_regions: int) -> Dict[str, torch.Tensor]:
    alpha, beta = beta_params(net, obs, n_regions)
    x = torch._standard_gamma(alpha, generator=gen)
    y = torch._standard_gamma(beta, generator=gen)
    raw = torch.clamp(x / (x + y), 1e-4, 1 - 1e-4)
    act = raw / raw.sum(-1, keepdim=True)
    return {"raw": raw, "action": act,
            "log_prob": beta_log_prob(alpha, beta, raw).sum((-2, -1)),
            "value": value(net, obs)}


def mean_action(net: PolicyNet, obs: torch.Tensor, n_regions: int
                ) -> torch.Tensor:
    alpha, beta = beta_params(net, obs, n_regions)
    m = alpha / (alpha + beta)
    return m / m.sum(-1, keepdim=True)


def betaln(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log B(a, b), computed in float64 and rounded once: in float32,
    lgamma(a) + lgamma(b) - lgamma(a + b) cancels badly once a + b
    reaches the hundreds, which a trained policy reaches."""
    a64, b64 = a.double(), b.double()
    out = torch.lgamma(a64) + torch.lgamma(b64) - torch.lgamma(a64 + b64)
    return out.to(a.dtype)


def beta_log_prob(alpha, beta, x):
    x = torch.clamp(x, 1e-6, 1 - 1e-6)
    return ((alpha - 1) * torch.log(x) + (beta - 1) * torch.log1p(-x)
            - betaln(alpha, beta))


def beta_entropy(alpha, beta):
    return (betaln(alpha, beta)
            - (alpha - 1) * torch.digamma(alpha)
            - (beta - 1) * torch.digamma(beta)
            + (alpha + beta - 2) * torch.digamma(alpha + beta))
