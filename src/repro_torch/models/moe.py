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

On a mesh :func:`moe_ffn` runs the reference's ``shard_map`` bodies,
tokens split over the data axes and whole over ``model``:

- expert-parallel (the experts divide ``model``): each rank routes its
  tokens, computes its ``E / model`` experts' contribution
  (``expert_offset = rank * le``) and the contributions are all-reduced
  over ``model``; FSDP-split expert weights are all-gathered over
  ``data`` first;
- tensor-parallel experts (they do not divide it): each rank holds an
  F-slice of every expert, exact because the nonlinearity is elementwise
  over F, and the partial down-projections are all-reduced;
- the decode-scale 2-D body (expert-parallel, FSDP, at most 2048 tokens,
  one data axis, F divisible by it): the weights stay split (experts
  over ``model``, F over ``data``); the tokens are all-gathered over
  ``data``, the contributions all-reduced over ``(data, model)`` and
  each rank keeps its block.

Dispatch never crosses data shards outside the 2-D body, so capacities
are counted on a rank's tokens, as the reference counts them; the
balance loss is averaged over the data axes.  :data:`BODIES` counts the
bodies run.
"""
from __future__ import annotations

import collections
import itertools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig, MoEConfig
from repro_torch.models.params import ParamDesc
from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import (DEFAULT_RULES, AxisRules, P,
                                        batch_axes)

# bodies of :func:`moe_ffn` run: "local" (every expert, this rank's
# tokens), "gathered" (every expert, the tokens gathered over the data
# axes), "expert", "tensor", "2d"
BODIES: collections.Counter = collections.Counter()


def _expert_parallel(cfg: ArchConfig, rules: AxisRules) -> bool:
    return rules.mesh is None or rules.divisible(cfg.moe.num_experts,
                                                 rules.expert_axis)


def _expert_fsdp(cfg: ArchConfig, rules: AxisRules) -> Optional[str]:
    """``"data"`` where FSDP splits the expert-parallel weights' F over
    it."""
    if _expert_parallel(cfg, rules) and rules.fsdp and rules.divisible(
            cfg.moe.d_ff_expert, "data"):
        return "data"
    return None


def moe_param_descs(cfg: ArchConfig, rules: AxisRules = DEFAULT_RULES) -> Dict:
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    ep = rules.expert_axis
    if _expert_parallel(cfg, rules):
        # FSDP storage sharding of the big expert tensors over data when asked
        dspec = _expert_fsdp(cfg, rules)
        w_in = P(ep, None, dspec)
        w_out = P(ep, dspec, None)
    else:
        w_in = P(None, None, ep)
        w_out = P(None, ep, None)
    return {
        "router": ParamDesc((d, e), pspec=P(None, None)),
        "w_gate": ParamDesc((e, d, f), pspec=w_in),
        "w_up": ParamDesc((e, d, f), pspec=w_in),
        "w_down": ParamDesc((e, f, d), pspec=w_out),
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


def _body(cfg: ArchConfig, rules: AxisRules, tokens: int) -> str:
    """The body :func:`moe_ffn` runs for ``tokens`` tokens in all (over
    the data axes), as the reference picks it."""
    if rules.mesh is None or rules.axis_size(rules.expert_axis) == 1:
        return "gathered" if rules.axis_size(batch_axes(rules)) > 1 \
            else "local"
    if not _expert_parallel(cfg, rules):
        return "tensor"
    if (rules.fsdp and tokens <= 2048
            and isinstance(batch_axes(rules), str)
            and rules.divisible(cfg.moe.d_ff_expert, "data")):
        return "2d"
    return "expert"


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ArchConfig, act,
            rules: AxisRules = DEFAULT_RULES, *, batch_split: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux).  Without a mesh (or with a ``model``
    axis of 1) every expert is local; on a mesh ``x`` is this rank's
    block of the batch where ``batch_split``, else the whole batch, and
    the reference's ``shard_map`` bodies run (module docstring)."""
    m = cfg.moe
    b, s, d = x.shape
    ba = batch_axes(rules)
    n_data = rules.axis_size(ba)
    ep = rules.expert_axis
    body = _body(cfg, rules, b * s * (n_data if batch_split else 1))
    BODIES[body] += 1
    if body == "local":
        y, aux = moe_ffn_local(p, x.reshape(-1, d), m, act)
        return y.reshape(b, s, d), aux
    if body == "gathered":
        # the reference routes the whole (global) batch here: gather it
        x_all = C.all_gather(x, rules, ba, 0) if batch_split else x
        y, aux = moe_ffn_local(p, x_all.reshape(-1, d), m, act)
        y = y.reshape(x_all.shape)
        if batch_split:
            y = y[C.axis_index(rules, ba) * b:][:b]
        return y, aux
    ep_size = rules.axis_size(ep)
    le = m.num_experts // ep_size if body != "tensor" else m.num_experts
    offset = C.axis_index(rules, ep) * le if body != "tensor" else 0
    if body == "2d":
        # weights stay (experts x model, F x data) resident; the tiny
        # token batch is gathered instead
        x_all = C.all_gather(x, rules, ba, 0)
        t = x_all.shape[0] * s
        y, aux = moe_ffn_local(p, x_all.reshape(t, d), m, act,
                               expert_offset=offset, local_experts=le)
        y = C.all_reduce_sum(y, rules, (ba, ep))   # F-parts + expert groups
        y = y[C.axis_index(rules, ba) * (t // n_data):][:t // n_data]
    else:
        pl = dict(p)
        fs = _expert_fsdp(cfg, rules)
        if fs is not None:
            pl["w_gate"] = C.all_gather(p["w_gate"], rules, fs, 2)
            pl["w_up"] = C.all_gather(p["w_up"], rules, fs, 2)
            pl["w_down"] = C.all_gather(p["w_down"], rules, fs, 1)
        y, aux = moe_ffn_local(pl, x.reshape(b * s, d), m, act,
                               expert_offset=offset, local_experts=le)
        y = C.all_reduce_sum(y, rules, ep)
    aux = C.all_reduce_sum(aux, rules, ba) / n_data   # pmean over data
    return y.reshape(b, s, d), aux


def body_collectives(cfg: ArchConfig, rules: AxisRules, b: int, s: int,
                     itemsize: int, *, batch_split: bool
                     ) -> List[C.Collective]:
    """The collectives :func:`moe_ffn` calls on a rank's (b, s, D) block,
    in order (``collectives.step_collectives`` reads them)."""
    m, d = cfg.moe, cfg.d_model
    ba, ep = batch_axes(rules), rules.expert_axis
    n_data = rules.axis_size(ba)
    out: List[C.Collective] = []

    def add(op, axis, shape, size=itemsize):
        if rules.axis_size(axis) > 1:
            out.append(C.Collective(op, axis, tuple(shape),
                                    size * int(torch.Size(shape).numel())))
    body = _body(cfg, rules, b * s * (n_data if batch_split else 1))
    if body == "local":
        return out
    if body == "gathered":
        if batch_split:
            add("all_gather", ba, (b * n_data, s, d))
        return out
    le = m.num_experts // rules.axis_size(ep) if body != "tensor" \
        else m.num_experts
    f = m.d_ff_expert
    if body == "2d":
        add("all_gather", ba, (b * n_data, s, d))
        add("all_reduce", (ba, ep), (b * n_data * s, d))
    else:
        if _expert_fsdp(cfg, rules) is not None:
            add("all_gather", "data", (le, d, f))
            add("all_gather", "data", (le, d, f))
            add("all_gather", "data", (le, f, d))
        add("all_reduce", ep, (b * s, d))
    add("all_reduce", ba, (), 4)
    return out
