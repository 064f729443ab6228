"""Attention sublayer: QKV projections, RoPE and the KV cache (including
the rotating sliding-window cache), the counterpart of
``repro/models/attention.py``.  Cross-attention waits for whisper's
slice."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       gqa_attention)
from repro_torch.models.params import ParamDesc


def attn_param_descs(cfg: ArchConfig) -> Dict:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": ParamDesc((d, h, hd)),
        "wk": ParamDesc((d, kh, hd)),
        "wv": ParamDesc((d, kh, hd)),
        "wo": ParamDesc((h, hd, d), scale=1.0),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamDesc((h, hd), "zeros")
        p["bk"] = ParamDesc((kh, hd), "zeros")
        p["bv"] = ParamDesc((kh, hd), "zeros")
    return p


def _project_qkv(p: Dict, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _out_proj(p: Dict, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def attn_forward(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ArchConfig):
    """Full-sequence (prefill) causal self-attention with RoPE and the
    config's window, through the ``flash_prefill`` kernel; positions:
    (S,), ``arange(S)`` on every path of the port.  Returns (out, (k, v)),
    k after RoPE, for the decode cache (the reference's returns out, and
    its ``Model._attn`` both)."""
    q, k, v = _project_qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = gqa_attention(q, k, v, window=cfg.sliding_window)
    return _out_proj(p, o), (k, v)


# ---------------------------------------------------------------------------
# KV cache (decode): fixed-size, optionally rotating (sliding window)
# ---------------------------------------------------------------------------


def kv_cache_len(cfg: ArchConfig, seq_len: int) -> int:
    win = cfg.sliding_window
    return min(seq_len, win) if win else seq_len


def attn_decode_step(p: Dict, x: torch.Tensor, pos: torch.Tensor,
                     kc: torch.Tensor, vc: torch.Tensor, cfg: ArchConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. x: (B, 1, D); pos: (B,) absolute position of the
    new token; kc/vc: (B, C, KH, hd).  Writes the new K/V into slot
    ``pos % C`` of kc/vc in place (the reference returns new arrays) and
    returns (out, kc, vc)."""
    b, c = x.shape[0], kc.shape[1]
    q, k, v = _project_qkv(p, x)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    # torch.remainder is floor-mod like jnp's %: pos = -1 (an empty batch
    # slot) writes slot C - 1 and sees no valid position
    slot = torch.remainder(pos, c)                 # rotating when C < seq
    rows = torch.arange(b, device=x.device)
    kc[rows, slot] = k[:, 0].to(kc.dtype)
    vc[rows, slot] = v[:, 0].to(vc.dtype)
    # absolute position held by each slot: largest p' <= pos with p' % C == slot_idx
    idx = torch.arange(c, device=x.device)[None, :]
    cache_pos = pos[:, None] - torch.remainder(pos[:, None] - idx, c)
    win = cfg.sliding_window
    if win is not None:
        cache_pos = torch.where(cache_pos > pos[:, None] - win, cache_pos, -1)
    o = decode_attention(q, kc, vc, pos, cache_pos)
    return _out_proj(p, o), kc, vc
