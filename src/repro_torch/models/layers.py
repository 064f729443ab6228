"""Primitive layers: norms, activations, RoPE and attention.

Plain functions over explicit parameter dicts, in the reference's layouts
(``repro/models/layers.py``): attention takes q as (B, S, H, hd) and k, v
as (B, S, KH, hd), with head h = (h // G, h % G).  Causal self-attention
goes through the ``flash_prefill`` kernel and decode attention through
the ``flash_decode`` kernel.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_decode.ops import decode_attention  # noqa: F401
from repro_torch.kernels.flash_prefill.ops import prefill_attention

# the reference model's mask value; the kernels use -1e30, as the Pallas
# kernels do
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def _wide(x: torch.Tensor) -> torch.Tensor:
    """At least float32, as the reference computes norms and RoPE (float64
    stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = _wide(x)
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(x.dtype)).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    dt = x.dtype
    x = _wide(x)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(x.dtype) + bias.to(x.dtype)).to(dt)


def norm(x: torch.Tensor, p: dict, kind: str, eps: float) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


def act_fn(name: str):
    gelu = functools.partial(F.gelu, approximate="tanh")
    return {"silu": F.silu, "gelu": gelu, "gelu_glu": gelu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    xw = _wide(x)
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (hd/2,)
    ang = positions[..., None].to(xw.dtype) * freqs          # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = xw.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_rows(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Rows ``positions`` (integers, any shape) of the float32 sinusoidal
    table, each computed as the table computes it: (..., dim)."""
    pos = positions.to(torch.float32)[..., None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=positions.device)
                    * (-math.log(10000.0) / dim))
    ang = pos * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).flatten(-2)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """The (length, dim) table: sin at even columns, cos at odd."""
    return sinusoidal_rows(torch.arange(length, device=device), dim)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: Optional[torch.Tensor] = None,
                  k_pos: Optional[torch.Tensor] = None, *,
                  causal: bool = True, window: Optional[int] = None,
                  prefix_len: int = 0,
                  k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd) -> (B, Sq, H, hd).

    The route follows the call's arguments.  Causal self-attention over a
    whole sequence (no positions given, so both are ``arange(S)``; no
    prefix, no key mask), the decoder's prefill, goes through the
    ``flash_prefill`` kernel: straight to it when no gradient is wanted
    (serving), and under grad (the train step) through its autograd
    path, the kernel's forward with an explicit backward
    (``kernels/flash_prefill/autograd.py``).  Everything else is the plain version of
    the reference's masking: on the serving path that is whisper's
    non-causal attention (its encoder's self-attention and the prefill's
    cross-attention) and paligemma's prefill under the prefix-LM mask
    (its ``prefix_len`` image positions attend to each other both ways),
    which the reference computes in XLA too, its Pallas ``flash_prefill``
    being causal only.  A non-causal or prefix mode of the kernel is a
    later speed-up.
    """
    if (q_pos is None and k_pos is None and causal and not prefix_len
            and k_valid is None):
        return prefill_attention(q, k, v, window=window)
    return _attention_plain(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, prefix_len=prefix_len,
                            k_valid=k_valid)


def _attention_plain(q, k, v, q_pos, k_pos, *, causal, window, prefix_len,
                     k_valid) -> torch.Tensor:
    """The reference's ``gqa_attention`` in one block (no chunking), in
    float32 (float64 for float64 operands)."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device)
    if k_pos is None:
        k_pos = torch.arange(sk, device=q.device)
    qp, kp = q_pos[:, None], k_pos[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        c = kp <= qp
        if prefix_len:
            c = c | (kp < prefix_len)
        ok &= c
    if window is not None:
        w = kp > (qp - window)
        if prefix_len:
            w = w | (kp < prefix_len)
        ok &= w
    if k_valid is not None:
        ok &= k_valid[None, :]
    qr = q.reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", _wide(qr), _wide(k)) * hd ** -0.5
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, _wide(v))
    return o.reshape(b, sq, h, hd).to(q.dtype)
