"""Plain PyTorch version of the multi-region greedy kernel.

A Python loop over the task axis doing whole-(R, S_pad) torch ops per
step, in the op order of the reference's scan body
(``repro/core/micro_jax.py:_scan_assign_multi_impl``) and of the CUDA
kernel: float64 scores, the f32 embedding dot as a left-to-right sum,
ring entries summed newest first, the Eq-10 decay from the operand
table, first-index argmax.  With a ``static`` operand the Eq 7-9 part and
the warm bonus come from it, as in the kernel's static variant.  The CPU
path of ``ops.greedy_assign`` and the yardstick the kernel is held to
(bitwise) on the card.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.core.micro_state import EMPTY

if TYPE_CHECKING:
    from repro_torch.kernels.greedy_assign.ops import GreedyInputs


def greedy_assign_ref(x: "GreedyInputs"):
    """Same contract as ``ops.greedy_assign``."""
    c = x.consts
    r, n_pad = x.t_mids.shape
    dev = x.t_mids.device
    f64 = dict(dtype=torch.float64, device=dev)
    zero, half, one = (torch.tensor(v, **f64) for v in (0.0, 0.5, 1.0))
    neg_inf, warm_part = torch.tensor(-float("inf"), **f64), torch.tensor(0.4, **f64)
    ar = torch.arange(r, device=dev)
    e_dim = x.l_emb.shape[3]
    keep_k = x.l_mids.shape[2]
    cap = 16.0 * x.slot_s
    proj = x.proj0.clone()
    lm, ls, le, ln = (a.clone() for a in (x.l_mids, x.l_slots, x.l_emb,
                                          x.l_nrm))
    out = torch.full((r, n_pad), -1, dtype=torch.int32, device=dev)
    for i in range(n_pad):
        mid_i = x.t_mids[:, i]
        kind_i = x.t_kinds[:, i]
        mem_i = x.t_mem[:, i]
        work_i = x.t_work[:, i]
        emb_i = x.t_emb[:, i]                                # (R, E)
        norm_i = x.t_norms[:, i]
        has_i = x.t_has[:, i]

        # Eq-10 locality of this task vs every server's ring
        dots = le[..., 0] * emb_i[:, None, None, 0]           # f32
        for e in range(1, e_dim):
            dots = dots + le[..., e] * emb_i[:, None, None, e]
        denom = norm_i[:, None, None] * ln                    # f32
        ok = has_i[:, None, None] & (denom > 1e-9)
        sim = c.w_model * (mid_i[:, None, None] == lm).to(torch.float64)
        safe = torch.where(ok, denom.to(torch.float64), one)
        sim = sim + torch.where(ok, c.w_embed * dots.to(torch.float64) / safe,
                                zero)
        age = torch.clamp(x.t - ls, 0, x.decay.shape[0] - 1).long()
        contrib = torch.where(lm != EMPTY, sim / x.decay[age], zero)
        loc = contrib[..., 0]
        for k in range(1, keep_k):
            loc = loc + contrib[..., k]

        if x.static is not None:
            static = (x.static[:, i] + c.w_loc * loc) + 0.0
        else:
            # static Eq 7-9 row and warm bonus
            cc = torch.clamp(x.tflops / x.t_demand[:, i, None], max=1.0)
            m = torch.clamp(x.mem_s / torch.clamp(mem_i, min=1e-9)[:, None],
                            max=1.0)
            tm = torch.where(x.kind_s == kind_i[:, None], one, half)
            base = c.w_hw * (cc * m * tm) + c.w_load * x.load
            warm = torch.where(
                x.cur_model == mid_i[:, None], one,
                torch.where((x.warm_srv == mid_i[:, None, None]).any(-1),
                            warm_part, zero))
            static = (base + c.w_loc * loc) + c.w_warm * warm
        eligible = (x.active & (x.mem_s >= mem_i[:, None]) & (proj <= cap)
                    & (x.n_real > i)[:, None])
        any_e = eligible.any(dim=1)
        q = proj / x.slot_s
        sc = (static - (0.8 * q + 0.4 * q * q)) \
            - (0.3 * (work_i[:, None] / x.speed) / x.slot_s)
        best = torch.argmax(torch.where(eligible, sc, neg_inf), dim=1)

        # projected-queue push: work/speed + switch seconds at the choice
        cur_b = x.cur_model[ar, best]
        warm_b = (x.warm_srv[ar, best] == mid_i[:, None]).any(-1)
        scale_b = x.switch_scale[ar, best]
        sw = torch.where(cur_b == mid_i, zero,
                         torch.where(warm_b, scale_b * c.warm_hit_s,
                                     scale_b * c.model_switch_s))
        add = work_i / x.speed[ar, best] + sw
        proj[ar, best] = proj[ar, best] + torch.where(any_e, add, zero)

        # ring push on each region's chosen server (newest first)
        rowm, rows_, rowe, rown = lm[ar, best], ls[ar, best], le[ar, best], \
            ln[ar, best]
        nm = torch.cat([mid_i[:, None], rowm[:, :-1]], dim=1)
        ns = torch.cat([torch.full_like(rows_[:, :1], x.t), rows_[:, :-1]],
                       dim=1)
        ne = torch.cat([torch.where(has_i[:, None], emb_i, 0.0)[:, None],
                        rowe[:, :-1]], dim=1)
        nn = torch.cat([torch.where(has_i, x.t_note[:, i], 0.0)[:, None],
                        rown[:, :-1]], dim=1)
        hold = ~any_e
        lm[ar, best] = torch.where(hold[:, None], rowm, nm)
        ls[ar, best] = torch.where(hold[:, None], rows_, ns)
        le[ar, best] = torch.where(hold[:, None, None], rowe, ne)
        ln[ar, best] = torch.where(hold[:, None], rown, nn)
        out[:, i] = torch.where(any_e, best.to(torch.int32), -1)
    return out, (lm, ls, le, ln)
