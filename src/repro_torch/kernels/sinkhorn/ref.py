"""Plain PyTorch version of the Sinkhorn kernel (float32, the Pallas
formula of ``repro/kernels/sinkhorn/kernel.py:_kernel``).  The CPU path
of :func:`repro_torch.kernels.sinkhorn.ops.sinkhorn_plan`, and the
yardstick the CUDA kernel is held to on the card."""
from __future__ import annotations

import torch


def sinkhorn_ref(mu: torch.Tensor, nu: torch.Tensor, cost: torch.Tensor, *,
                 reg: float = 0.05, n_iters: int = 100) -> torch.Tensor:
    """mu, nu: (B, R); cost: (B, R, R) -> transport plans (B, R, R)."""
    mu, nu, cost = (a.to(torch.float32) for a in (mu, nu, cost))
    logmu = torch.log(torch.clamp(mu, min=1e-30))
    lognu = torch.log(torch.clamp(nu, min=1e-30))
    mk = -cost / reg
    f = torch.zeros_like(mu)
    g = torch.zeros_like(nu)
    for _ in range(n_iters):
        t1 = mk + g[:, None, :] / reg
        m1 = t1.amax(-1)
        f = reg * (logmu - (m1 + torch.log(
            torch.exp(t1 - m1[..., None]).sum(-1))))
        t2 = mk + f[:, :, None] / reg
        m2 = t2.amax(1)
        g = reg * (lognu - (m2 + torch.log(
            torch.exp(t2 - m2[:, None, :]).sum(1))))
    return torch.exp(mk + (f[:, :, None] + g[:, None, :]) / reg)
