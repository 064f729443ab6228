"""Attention sublayer: QKV projections, RoPE, the KV cache (including
the rotating sliding-window cache) and encoder-decoder cross-attention,
the counterpart of ``repro/models/attention.py``.

On a mesh the parameters are this rank's shards of the reference's
layouts (:func:`attn_param_descs`):

- heads over ``model`` (Megatron), where the heads divide it: Q (and
  K/V where the KV heads divide too) are column-parallel, their product
  local; attention runs on the local heads through the same kernels;
  ``wo`` is row-parallel, its partial sums all-reduced over ``model``.
  Where K/V stay whole on every rank, the rank's Q heads read the KV
  heads :func:`local_kv_heads` names;
- ``d_model`` over ``model`` for few-head configs: each rank's slice of
  the input's columns gives partial Q/K/V, all-reduced; attention then
  runs on every head on every rank, and ``wo``'s column blocks give the
  output's, all-gathered.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       gqa_attention)
from repro_torch.models.params import ParamDesc
from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import DEFAULT_RULES, AxisRules, P


def _sharding(cfg: ArchConfig, rules: AxisRules) -> Tuple[bool, Optional[str]]:
    """(Q heads sharded over the tensor axis, the KV heads' axis or None)
    as the reference decides them."""
    tp = rules.tensor_axis
    q_ok = (rules.mesh is None or rules.divisible(cfg.num_heads, tp)) \
        and rules.seq_axis is None
    kv_tp = tp if (rules.mesh is None or rules.divisible(
        cfg.num_kv_heads, tp)) and rules.seq_axis is None else None
    return q_ok, kv_tp


def attn_layout(cfg: ArchConfig, rules: AxisRules) -> bool:
    """True for the heads layout, False for the d-sharded one."""
    return _sharding(cfg, rules)[0]


def attn_param_descs(cfg: ArchConfig, rules: AxisRules = DEFAULT_RULES, *,
                     cross: bool = False) -> Dict:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    tp = rules.tensor_axis
    # head-sharded QKV forces activation replication when activations are
    # sequence-sharded: the reference takes the d-sharded layout there
    q_ok, kv_tp = _sharding(cfg, rules)
    if q_ok:
        # megatron: shard Q heads over model; KV heads when divisible
        p = {
            "wq": ParamDesc((d, h, hd), pspec=P(None, tp, None)),
            "wk": ParamDesc((d, kh, hd), pspec=P(None, kv_tp, None)),
            "wv": ParamDesc((d, kh, hd), pspec=P(None, kv_tp, None)),
            "wo": ParamDesc((h, hd, d), scale=1.0, pspec=P(tp, None, None)),
        }
        bq = P(tp, None)
    else:
        # few-head models (whisper h=12, paligemma h=8 on 16-way TP):
        # shard the d_model contraction dim instead
        p = {
            "wq": ParamDesc((d, h, hd), pspec=P(tp, None, None)),
            "wk": ParamDesc((d, kh, hd), pspec=P(tp, None, None)),
            "wv": ParamDesc((d, kh, hd), pspec=P(tp, None, None)),
            "wo": ParamDesc((h, hd, d), scale=1.0, pspec=P(None, None, tp)),
        }
        bq = P(None, None)
    if cfg.qkv_bias:
        p["bq"] = ParamDesc((h, hd), "zeros", pspec=bq)
        p["bk"] = ParamDesc((kh, hd), "zeros", pspec=P(kv_tp, None))
        p["bv"] = ParamDesc((kh, hd), "zeros", pspec=P(kv_tp, None))
    return p


def local_kv_heads(cfg: ArchConfig, rules: AxisRules
                   ) -> Union[None, slice, torch.Tensor]:
    """Which of the whole K/V's heads this rank's Q heads read, where Q is
    head-sharded over the tensor axis and K/V are not: the contiguous KV
    heads of its Q heads' groups (G kept), the one KV head its Q heads
    all share (G = its Q heads), or else one KV head per Q head (an
    index, G = 1).  None where no selection is needed."""
    q_ok, kv_tp = _sharding(cfg, rules)
    n = rules.axis_size(rules.tensor_axis)
    if not q_ok or kv_tp is not None or n == 1:
        return None
    hl, g = cfg.num_heads // n, cfg.num_heads // cfg.num_kv_heads
    first = C.axis_index(rules, rules.tensor_axis) * hl
    if hl % g == 0:
        return slice(first // g, (first + hl) // g)
    if g % hl == 0:
        return slice(first // g, first // g + 1)
    return torch.arange(first, first + hl) // g


def _kv(t: torch.Tensor, sel) -> torch.Tensor:
    """K or V (B, S, KH, hd) restricted to the heads ``sel`` names."""
    if sel is None:
        return t
    if isinstance(sel, slice):
        return t[:, :, sel]
    return t.index_select(2, sel.to(t.device))


def _d_slice(x: torch.Tensor, rules: AxisRules) -> torch.Tensor:
    """This rank's block of ``x``'s last (d_model) dim, in the d-sharded
    layout."""
    n = rules.axis_size(rules.tensor_axis)
    if n == 1:
        return x
    w = x.shape[-1] // n
    return x.narrow(-1, C.axis_index(rules, rules.tensor_axis) * w, w)


def _proj(x: torch.Tensor, w: torch.Tensor, b, rules: AxisRules,
          heads: bool) -> torch.Tensor:
    """x @ w (+ b): local in the heads layout, partial sums all-reduced
    in the d-sharded one."""
    if heads:
        y = torch.einsum("bsd,dhk->bshk", x, w)
    else:
        y = C.all_reduce_sum(torch.einsum("bsd,dhk->bshk", _d_slice(x, rules),
                                          w), rules, rules.tensor_axis)
    return y if b is None else y + b


def _project_qkv(p: Dict, x: torch.Tensor, rules: AxisRules = DEFAULT_RULES,
                 heads: bool = True):
    q = _proj(x, p["wq"], p.get("bq"), rules, heads)
    k = _proj(x, p["wk"], p.get("bk"), rules, heads)
    v = _proj(x, p["wv"], p.get("bv"), rules, heads)
    return q, k, v


def _out_proj(p: Dict, o: torch.Tensor, rules: AxisRules = DEFAULT_RULES,
              heads: bool = True) -> torch.Tensor:
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    if heads:
        return C.all_reduce_sum(y, rules, rules.tensor_axis)
    return C.all_gather(y, rules, rules.tensor_axis, -1)


def attn_forward(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ArchConfig, *, causal: bool = True,
                 use_rope: bool = True, prefix_len: int = 0,
                 rules: AxisRules = DEFAULT_RULES):
    """Full-sequence self-attention; positions: (S,), ``arange(S)`` on
    every path of the port.  Causal (the decoder's prefill, with the
    config's window, through the ``flash_prefill`` kernel; with a
    ``prefix_len`` > 0, paligemma's prefix-LM mask, the plain version) or
    not (whisper's encoder, no window, the plain version); RoPE unless
    ``use_rope`` is off (whisper's absolute positions).  Returns
    (out, (k, v)), k after RoPE, for the decode cache (the reference's
    ``attn_forward`` returns out, its ``Model._attn`` both); on a mesh
    k, v are the rank's (its KV heads, or all of them where they are not
    sharded)."""
    heads = attn_layout(cfg, rules)
    q, k, v = _project_qkv(p, x, rules, heads)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    sel = local_kv_heads(cfg, rules)
    o = gqa_attention(q, _kv(k, sel), _kv(v, sel), causal=causal,
                      window=cfg.sliding_window if causal else None,
                      prefix_len=prefix_len)
    return _out_proj(p, o, rules, heads), (k, v)


def _project_q(p: Dict, x: torch.Tensor, rules: AxisRules,
               heads: bool) -> torch.Tensor:
    return _proj(x, p["wq"], p.get("bq"), rules, heads)


def cross_attn_cache(p: Dict, kv_src: torch.Tensor,
                     cfg: ArchConfig, rules: AxisRules) -> Dict:
    """Cross-attention K/V of the encoder output, computed once a request:
    {"k", "v"}, each (B, src_len, KH, hd) (on a mesh the rank's KV
    heads)."""
    heads = attn_layout(cfg, rules)
    return {"k": _proj(kv_src, p["wk"], p.get("bk"), rules, heads),
            "v": _proj(kv_src, p["wv"], p.get("bv"), rules, heads)}


def cross_attn_forward(p: Dict, x: torch.Tensor, cache: Dict,
                       cfg: ArchConfig, rules: AxisRules) -> torch.Tensor:
    """Encoder-decoder cross-attention (no RoPE, no causal mask): every
    decoder position attends to every encoder position.  Takes the
    encoder's K/V as :func:`cross_attn_cache` gives them (the reference's
    takes the encoder output and projects it again, in a prefill that
    also builds the decode cache)."""
    heads = attn_layout(cfg, rules)
    sel = local_kv_heads(cfg, rules)
    o = gqa_attention(_project_q(p, x, rules, heads), _kv(cache["k"], sel),
                      _kv(cache["v"], sel), causal=False)
    return _out_proj(p, o, rules, heads)


def cross_attn_decode(p: Dict, x: torch.Tensor, cache: Dict,
                      cfg: ArchConfig, rules: AxisRules) -> torch.Tensor:
    """One decode step's cross-attention over the cached encoder K/V,
    every source position valid, through the ``flash_decode`` kernel.
    x: (B, 1, D); cache: :func:`cross_attn_cache`'s, read only."""
    heads = attn_layout(cfg, rules)
    sel = local_kv_heads(cfg, rules)
    q = _project_q(p, x, rules, heads)
    b, src_len = x.shape[0], cache["k"].shape[1]
    pos = torch.full((b,), src_len, dtype=torch.int32, device=x.device)
    cache_pos = torch.arange(src_len, device=x.device).expand(b, src_len)
    o = decode_attention(q, _kv(cache["k"], sel), _kv(cache["v"], sel), pos,
                         cache_pos)
    return _out_proj(p, o, rules, heads)


# ---------------------------------------------------------------------------
# KV cache (decode): fixed-size, optionally rotating (sliding window)
# ---------------------------------------------------------------------------


def kv_cache_len(cfg: ArchConfig, seq_len: int) -> int:
    win = cfg.sliding_window
    return min(seq_len, win) if win else seq_len


def attn_decode_step(p: Dict, x: torch.Tensor, pos: torch.Tensor,
                     kc: torch.Tensor, vc: torch.Tensor, cfg: ArchConfig, *,
                     use_rope: bool = True, rules: AxisRules = DEFAULT_RULES
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. x: (B, 1, D); pos: (B,) absolute position of the
    new token; kc/vc: (B, C, KH, hd), on a mesh the rank's heads of the
    cache.  Writes the new K/V into slot ``pos % C`` of kc/vc in place
    (the reference returns new arrays) and returns (out, kc, vc)."""
    b, c = x.shape[0], kc.shape[1]
    heads = attn_layout(cfg, rules)
    q, k, v = _project_qkv(p, x, rules, heads)
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
    sel = local_kv_heads(cfg, rules)
    o = decode_attention(q, _kv(kc, sel), _kv(vc, sel), pos, cache_pos)
    return _out_proj(p, o, rules, heads), kc, vc
