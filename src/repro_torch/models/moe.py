"""Mixture-of-experts FFN, the counterpart of ``repro/models/moe.py``'s
mesh-less path: a router, top-k routing with the Switch balance loss, and
sort-based dispatch with a per-expert capacity (picks over it are dropped;
a batch of at most 512 picks, a decode tick, drops none).

Which picks reach which expert is the reference's to the pick: the top-k
keeps the lower expert id first on ties (a stable descending sort, as
``lax.top_k``), the picks are sorted by expert id with a stable sort of
their token-major flat index, and a pick is kept iff its expert is local
and its rank among that expert's picks is under the capacity.

The reference fills a zero-padded (experts, capacity, D) buffer and
multiplies all of it.  Here each local expert multiplies only its kept
rows: the padded rows add exactly zero to the output, and at a decode
tick they are nearly all of the buffer (qwen3-moe: 32 picks against a
(128, 32, 4096) buffer, ~155 GFLOP a layer in float32).  That takes the
per-expert counts on the host, one read a layer.  Each expert adds its
rows into the output with its own ``index_add_``: within one expert no
token repeats (its k picks are distinct experts), so the sums are made in
expert order, the same on every run and device.  The grouped products
are plain matrix products, as in the reference (XLA there, not Pallas).

The two ``shard_map`` branches of the reference's ``moe_ffn`` (expert- and
tensor-parallel) wait for the sharding slice; ``moe_ffn_local`` already
takes their ``expert_offset`` / ``local_experts``.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig, MoEConfig
from repro_torch.models.params import ParamDesc


def moe_param_descs(cfg: ArchConfig) -> Dict:
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    return {
        "router": ParamDesc((d, e)),
        "w_gate": ParamDesc((e, d, f)),
        "w_up": ParamDesc((e, d, f)),
        "w_down": ParamDesc((e, f, d)),
    }


def _routing(router: torch.Tensor, x: torch.Tensor, m: MoEConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (t, D) -> (weights (t, k), experts (t, k) int64, aux scalar)."""
    logits = (x @ router).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :m.top_k], idx[:, :m.top_k]
    vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)  # renormalize
    # Switch-style load-balance aux: E * sum_e f_e * p_e
    e = m.num_experts
    me = probs.mean(0)                                   # (E,)
    fe = torch.bincount(idx.reshape(-1), minlength=e).float()
    fe = fe / fe.sum().clamp_min(1.0)
    aux = e * torch.sum(fe * me)
    return vals.to(x.dtype), idx, aux


def capacity_of(tk: int, m: MoEConfig,
                capacity: Optional[int] = None) -> int:
    """Picks an expert takes of ``tk``: all of them up to 512 picks, else
    ``capacity_factor`` times an even share (at least 8)."""
    if capacity is None:
        capacity = tk if tk <= 512 else max(
            8, int(tk / m.num_experts * m.capacity_factor))
    return min(capacity, tk)


def dispatch(experts: torch.Tensor, c: int, *, expert_offset: int = 0,
             local_experts: int) -> Tuple[torch.Tensor, ...]:
    """The reference's sort-based dispatch of the (t, k) picks ``experts``
    under capacity ``c``: (order, the picks' flat token-major indices
    sorted stably by expert id; the sorted picks' expert ids; keep,
    whether each is computed: its expert is local and its rank among
    that expert's picks is under ``c``)."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    rank = torch.arange(flat.numel(), device=flat.device) - \
        torch.searchsorted(sorted_e, sorted_e, side="left")
    le_idx = sorted_e - expert_offset
    keep = (le_idx >= 0) & (le_idx < local_experts) & (rank < c)
    return order, sorted_e, keep


def moe_ffn_local(p: Dict, x: torch.Tensor, m: MoEConfig, act,
                  *, expert_offset: int = 0,
                  local_experts: Optional[int] = None,
                  capacity: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert FFN on local tokens for experts
    [expert_offset, expert_offset + local_experts).

    x: (t, D).  Returns (y (t, D), the contribution of the local experts
    only, and the aux load-balance loss).  ``p``'s expert tensors hold
    the local experts first, as the reference's do."""
    e, k = m.num_experts, m.top_k
    le = local_experts if local_experts is not None else p["w_gate"].shape[0]
    weights, experts, aux = _routing(p["router"], x, m)
    c = capacity_of(experts.numel(), m, capacity)
    order, sorted_e, keep = dispatch(
        experts, c, expert_offset=expert_offset, local_experts=le)
    src_tok = torch.div(order, k, rounding_mode="floor")
    w_sorted = weights.reshape(-1)[order]
    # picks and kept picks of each expert (dropped ones counted at e): an
    # expert's kept picks are the first of its run in ``order``
    counts, kept = torch.stack([
        torch.bincount(sorted_e, minlength=e),
        torch.bincount(torch.where(keep, sorted_e, e),
                       minlength=e + 1)[:e]]).tolist()
    starts = itertools.accumulate(counts, initial=0)
    y = torch.zeros_like(x)
    for g, (s0, n) in enumerate(zip(starts, kept)):
        if n == 0:
            continue
        j = g - expert_offset
        tok = src_tok[s0:s0 + n]
        h = x.index_select(0, tok)
        h = act(h @ p["w_gate"][j]) * (h @ p["w_up"][j])
        y.index_add_(0, tok, (h @ p["w_down"][j]) * w_sorted[s0:s0 + n, None])
    return y, aux


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ArchConfig, act
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux), every expert local (the reference's
    mesh-less branch)."""
    b, s, d = x.shape
    y, aux = moe_ffn_local(p, x.reshape(-1, d), cfg.moe, act)
    return y.reshape(b, s, d), aux
