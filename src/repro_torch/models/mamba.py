"""Mamba-1 selective-state-space block, the counterpart of
``repro/models/mamba.py``.

Prefill runs the scan through the ``selective_scan`` kernel, which also
returns the last state for the decode cache; under grad (training) it
takes the kernel's autograd path, whose backward is the
``selective_scan_bwd`` kernel.  Decode keeps an O(1)
recurrent state ``(B, d_inner, d_state)`` plus the last ``d_conv - 1`` raw
inputs of the depthwise conv, and is a one-token recurrence in plain
torch, as in the reference.

On a mesh the inner dim (``d_inner``) is split over ``model``, heads-free
so the split is exact: ``in_proj`` (both halves, ``[x | z]``, each split
on its own), the conv, ``dt_proj`` and the scan's per-channel operands
are the rank's channels, and the scan kernel and the decode recurrence
run on them; ``x_proj`` and ``out_proj`` are row-parallel, their partial
sums all-reduced (``x_proj``'s ``dt_rank + 2N`` columns before
``dt_proj``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig, SSMConfig
from repro_torch.kernels.selective_scan import autograd as scan_autograd
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.models.params import ParamDesc
from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import DEFAULT_RULES, AxisRules, P


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, s.d_state, s.d_conv, dt_rank


def mamba_param_descs(cfg: ArchConfig,
                      rules: AxisRules = DEFAULT_RULES) -> Dict:
    d = cfg.d_model
    d_in, n, d_conv, dt_rank = _dims(cfg)
    tp = rules.tensor_axis
    return {
        "in_proj": ParamDesc((d, 2 * d_in), pspec=P(None, tp), parts=2),
        "conv_w": ParamDesc((d_conv, d_in), "conv", pspec=P(None, tp)),
        "conv_b": ParamDesc((d_in,), "zeros", pspec=P(tp)),
        "x_proj": ParamDesc((d_in, dt_rank + 2 * n), pspec=P(tp, None)),
        "dt_proj": ParamDesc((dt_rank, d_in), pspec=P(None, tp)),
        "dt_bias": ParamDesc((d_in,), "dt_bias", pspec=P(tp)),
        "a_log": ParamDesc((d_in, n), "a_log", pspec=P(tp, None)),
        "d_skip": ParamDesc((d_in,), "ones", pspec=P(tp)),
        "out_proj": ParamDesc((d_in, d), pspec=P(tp, None)),
    }


def _ssm_inputs(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                rules: AxisRules = DEFAULT_RULES):
    """x: (..., d_in) post-conv activations -> (dt, B, C) float32 with
    dt: (..., d_in), B/C: (..., N)."""
    _, n, _, dt_rank = _dims(cfg)
    proj = C.all_reduce_sum(x @ p["x_proj"], rules, rules.tensor_axis)
    dt, b, c = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    return dt.float(), b.float(), c.float()


def _causal_conv(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S. x: (B, S, d_in)."""
    d_conv = p["conv_w"].shape[0]
    xp = F.pad(x, (0, 0, d_conv - 1, 0))
    # stack shifted views: sum_k w[k] * x[s - (d_conv-1) + k]
    s = x.shape[1]
    out = sum(xp[:, k:k + s] * p["conv_w"][k] for k in range(d_conv))
    return F.silu(out + p["conv_b"])


def mamba_forward(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                  return_state: bool = False,
                  rules: AxisRules = DEFAULT_RULES):
    """Full-sequence scan. x: (B, S, D) -> (B, S, D)[, (h_last, conv_state)].
    Under grad (grad mode on and an operand of the scan requiring grad)
    the scan goes through :func:`scan_autograd.selective_scan_grad`, the
    same forward with its backward kernel; otherwise straight to
    :func:`scan_ops.selective_scan`."""
    xz = x @ p["in_proj"]
    xi_raw, z = xz.chunk(2, dim=-1)                      # (B,S,d_in)
    xi = _causal_conv(p, xi_raw)
    dt, bm, cm = _ssm_inputs(p, xi, cfg, rules)          # f32
    a = -torch.exp(p["a_log"].float())                   # (d_in, N)
    scan = scan_ops.selective_scan
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, bm, cm, xi, a, p["d_skip"])):
        scan = scan_autograd.selective_scan_grad
    y, h_last = scan(dt, bm, cm, xi.float(), a, p["d_skip"])
    y = y.to(x.dtype) * F.silu(z)
    out = C.all_reduce_sum(y @ p["out_proj"], rules, rules.tensor_axis)
    if not return_state:
        return out
    d_conv = p["conv_w"].shape[0]
    # raw (pre-conv) inputs of the last d_conv-1 steps feed the decode ring
    s = xi_raw.shape[1]
    need = d_conv - 1
    if s >= need:
        conv_state = xi_raw[:, s - need:]
    else:
        conv_state = F.pad(xi_raw, (0, 0, need - s, 0))
    return out, (h_last, conv_state)


def mamba_state_shapes(cfg: ArchConfig, batch: int) -> Dict:
    """Shapes of one Mamba layer's decode state: the SSM state ``h`` and
    the conv window of the last ``d_conv - 1`` raw inputs."""
    d_in, n, d_conv, _ = _dims(cfg)
    return {"h": (batch, d_in, n), "conv": (batch, d_conv - 1, d_in)}


def mamba_decode_step(p: Dict, x: torch.Tensor, h: torch.Tensor,
                      conv: torch.Tensor, cfg: ArchConfig,
                      rules: AxisRules = DEFAULT_RULES
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token. x: (B, 1, D); h: (B, d_in, N) f32; conv: (B, d_conv-1, d_in).
    Returns (out (B,1,D), h', conv')."""
    xz = (x @ p["in_proj"])[:, 0]
    xi, z = xz.chunk(2, dim=-1)                          # (B, d_in)
    # conv holds the last d_conv-1 raw inputs in order
    window = torch.cat([conv, xi[:, None]], dim=1)       # (B, d_conv, d_in)
    xc = torch.einsum("bki,ki->bi", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)
    dt, bm, cm = _ssm_inputs(p, xc, cfg, rules)          # (B,d_in),(B,N),(B,N)
    a = -torch.exp(p["a_log"].float())
    abar = torch.exp(dt[..., None] * a)                  # (B, d_in, N)
    bx = (dt * xc.float())[..., None] * bm[:, None, :]
    h = abar * h + bx
    y = torch.einsum("bin,bn->bi", h, cm)
    y = y + p["d_skip"].float() * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = C.all_reduce_sum(y @ p["out_proj"], rules, rules.tensor_axis)
    return out[:, None], h, window[:, 1:]
