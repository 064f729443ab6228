"""Attention sublayer: QKV projections, RoPE, the KV cache (including
the rotating sliding-window cache) and encoder-decoder cross-attention,
the counterpart of ``repro/models/attention.py``."""
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
                 cfg: ArchConfig, *, causal: bool = True,
                 use_rope: bool = True, prefix_len: int = 0):
    """Full-sequence self-attention; positions: (S,), ``arange(S)`` on
    every path of the port.  Causal (the decoder's prefill, with the
    config's window, through the ``flash_prefill`` kernel; with a
    ``prefix_len`` > 0, paligemma's prefix-LM mask, the plain version) or
    not (whisper's encoder, no window, the plain version); RoPE unless
    ``use_rope`` is off (whisper's absolute positions).  Returns
    (out, (k, v)), k after RoPE, for the decode cache (the reference's
    ``attn_forward`` returns out, its ``Model._attn`` both)."""
    q, k, v = _project_qkv(p, x)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = gqa_attention(q, k, v, causal=causal,
                      window=cfg.sliding_window if causal else None,
                      prefix_len=prefix_len)
    return _out_proj(p, o), (k, v)


def _project_q(p: Dict, x: torch.Tensor) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    return q + p["bq"] if "bq" in p else q


def cross_attn_cache(p: Dict, kv_src: torch.Tensor) -> Dict:
    """Cross-attention K/V of the encoder output, computed once a request:
    {"k", "v"}, each (B, src_len, KH, hd)."""
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"])
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return {"k": k, "v": v}


def cross_attn_forward(p: Dict, x: torch.Tensor,
                       cache: Dict) -> torch.Tensor:
    """Encoder-decoder cross-attention (no RoPE, no causal mask): every
    decoder position attends to every encoder position.  Takes the
    encoder's K/V as :func:`cross_attn_cache` gives them (the reference's
    takes the encoder output and projects it again, in a prefill that
    also builds the decode cache)."""
    o = gqa_attention(_project_q(p, x), cache["k"], cache["v"],
                      causal=False)
    return _out_proj(p, o)


def cross_attn_decode(p: Dict, x: torch.Tensor,
                      cache: Dict) -> torch.Tensor:
    """One decode step's cross-attention over the cached encoder K/V,
    every source position valid, through the ``flash_decode`` kernel.
    x: (B, 1, D); cache: :func:`cross_attn_cache`'s, read only."""
    q = _project_q(p, x)
    b, src_len = x.shape[0], cache["k"].shape[1]
    pos = torch.full((b,), src_len, dtype=torch.int32, device=x.device)
    cache_pos = torch.arange(src_len, device=x.device).expand(b, src_len)
    o = decode_attention(q, cache["k"], cache["v"], pos, cache_pos)
    return _out_proj(p, o)


# ---------------------------------------------------------------------------
# KV cache (decode): fixed-size, optionally rotating (sliding window)
# ---------------------------------------------------------------------------


def kv_cache_len(cfg: ArchConfig, seq_len: int) -> int:
    win = cfg.sliding_window
    return min(seq_len, win) if win else seq_len


def attn_decode_step(p: Dict, x: torch.Tensor, pos: torch.Tensor,
                     kc: torch.Tensor, vc: torch.Tensor, cfg: ArchConfig, *,
                     use_rope: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. x: (B, 1, D); pos: (B,) absolute position of the
    new token; kc/vc: (B, C, KH, hd).  Writes the new K/V into slot
    ``pos % C`` of kc/vc in place (the reference returns new arrays) and
    returns (out, kc, vc)."""
    b, c = x.shape[0], kc.shape[1]
    q, k, v = _project_qkv(p, x)
    if use_rope:
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
