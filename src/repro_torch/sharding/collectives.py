"""The collectives of the sharded model, the port's stand-in for those
XLA inserts into the reference's GSPMD program, each over a named mesh
axis (or a tuple of axes) of the rules' bound mesh:

- :func:`all_reduce_sum`: a row-parallel product's partial sums, a
  vocab-sharded lookup, the MoE bodies' ``psum`` and ``pmean``;
- :func:`all_gather`: a vocab-sharded head's logits, an FSDP weight, the
  decode-scale MoE body's tokens.

Both are the identity on an axis of size 1, so the unsharded model calls
them at no cost.  Both are the backend's own collectives (``gloo`` on
the CPU in the tests and with several ranks on one card in
``chip_smoke.py``, where it takes CUDA tensors for both).

Inside ``with tally() as records:`` every collective that moves data
appends a :class:`Collective` (op, axes, shape, bytes of its result) to
``records``; outside, nothing is recorded.
:func:`step_collectives` gives the same list for a step from the config,
the run shape and the rules alone, for the dry run's collective term
(``launch/roofline.py``); ``link_bytes`` turns either into the bytes a
device sends over its links, at the ring costs the reference's HLO
analysis uses.  With :data:`TIMING` on, each collective waits for the
card before and after and adds its wall time to ``TIMING.seconds``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.sharding.specs import AxisRules, spec_axes

AxisName = Union[str, Tuple[str, ...]]


class Collective(NamedTuple):
    op: str                      # "all_reduce" | "all_gather"
    axis: AxisName
    shape: Tuple[int, ...]       # of the result
    nbytes: int


_TALLY: Optional[List[Collective]] = None


@contextlib.contextmanager
def tally():
    """Record the collectives called inside the ``with`` into the list it
    yields."""
    global _TALLY
    outer, _TALLY = _TALLY, []
    try:
        yield _TALLY
    finally:
        _TALLY = outer


def _record(op: str, axis: AxisName, y: torch.Tensor) -> None:
    if _TALLY is not None:
        _TALLY.append(Collective(op, axis, tuple(y.shape),
                                 y.numel() * y.element_size()))


@dataclasses.dataclass
class _Timing:
    on: bool = False
    seconds: float = 0.0


TIMING = _Timing()


def axis_index(rules: AxisRules, axis: AxisName) -> int:
    """This rank's index along ``axis`` (0 without a bound mesh)."""
    if rules.mesh is None or not rules.mesh.bound:
        return 0
    return rules.mesh.index(spec_axes(axis))


def _group(rules: AxisRules, axis: AxisName):
    mesh = rules.mesh
    if not mesh.bound:
        raise RuntimeError(f"a collective over {axis!r} needs a mesh bound "
                           f"to ranks (launch.mesh.init_mesh); this one is "
                           f"abstract")
    return mesh.group(spec_axes(axis))


def _check_no_grad(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "a collective of the sharded model has no backward: the "
            "sharded train step is a later slice")


def _run(x: torch.Tensor, call) -> None:
    """``call()``, timed between syncs of ``x``'s card when
    :data:`TIMING` is on."""
    if not TIMING.on:
        call()
        return
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    call()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    TIMING.seconds += time.perf_counter() - t0


def all_reduce_sum(x: torch.Tensor, rules: AxisRules,
                   axis: AxisName) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis``, a new tensor."""
    if rules.axis_size(axis) == 1:
        return x
    _check_no_grad(x)
    group = _group(rules, axis)
    y = x.clone(memory_format=torch.contiguous_format)
    _record("all_reduce", axis, y)
    _run(y, lambda: dist.all_reduce(y, group=group))
    return y


def all_gather(x: torch.Tensor, rules: AxisRules, axis: AxisName,
               dim: int) -> torch.Tensor:
    """The ranks' blocks along ``axis`` concatenated on ``dim`` in their
    order along it (a contiguous-block sharded dim made whole).  The
    group's ranks come in that order: a tuple axis names its axes in the
    mesh's order, as every partition spec does."""
    n = rules.axis_size(axis)
    if n == 1:
        return x
    _check_no_grad(x)
    group = _group(rules, axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    _run(x, lambda: dist.all_gather(parts, x, group=group))
    out = torch.cat(parts, dim)
    _record("all_gather", axis, out)
    return out


def link_bytes(records, rules: AxisRules) -> float:
    """Bytes each device sends over its links for ``records``, at ring
    cost: an all-reduce of ``b`` bytes over ``n`` ranks 2 b (n - 1) / n,
    an all-gather of a ``b``-byte result b (n - 1) / n (the reference's
    ``launch/hlo_analysis.py`` factors)."""
    total = 0.0
    for c in records:
        n = rules.axis_size(c.axis)
        frac = (n - 1) / n
        total += (2.0 if c.op == "all_reduce" else 1.0) * c.nbytes * frac
    return total


def summary(records, rules: AxisRules) -> dict:
    """{op: {"count", "bytes", "link_bytes"}} of ``records``."""
    out: dict = {}
    for c in records:
        s = out.setdefault(c.op, {"count": 0, "bytes": 0, "link_bytes": 0.0})
        s["count"] += 1
        s["bytes"] += c.nbytes
        s["link_bytes"] += link_bytes([c], rules)
    return out


# --------------------------------------------------------------------------
# The analytic count of a step's collectives
# --------------------------------------------------------------------------


def step_collectives(cfg, shape, rules: AxisRules, *,
                     dtype: torch.dtype = torch.bfloat16,
                     cache_len: Optional[int] = None) -> List[Collective]:
    """The collectives one step of ``shape`` calls on every rank under
    ``rules``, in call order, as :func:`tally` records them: a prefill
    (``make_prefill_step``: the forward with a cache of ``cache_len``,
    default the sequence's, and the last position's logits) or a decode
    step (``shape.seq_len`` is the cache's length), activations and
    weights in ``dtype``.  Raises for a train step (the sharded train
    step is a later slice) and for the rules the model refuses
    (``models.model.check_runnable``)."""
    from repro_torch.models import attention as A
    from repro_torch.models import mamba as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.blocks import fsdp_axis
    from repro_torch.models.model import check_runnable, vocab_axis
    from repro_torch.sharding.place import batch_block_size, batch_sharded
    if shape.mode == "train":
        raise NotImplementedError("step_collectives: the sharded train "
                                  "step is a later slice")
    decode = shape.mode == "decode"
    check_runnable(cfg, rules, shape.global_batch,
                   cache_len or shape.seq_len)
    out: List[Collective] = []
    el = torch.empty((), dtype=dtype).element_size()
    tp = rules.tensor_axis
    d, hd, h, kh = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads
    heads = A.attn_layout(cfg, rules)

    def add(op, axis, shp):
        if rules.axis_size(axis) > 1:
            out.append(Collective(op, axis, tuple(shp),
                                  el * int(torch.Size(shp).numel())))

    def proj(n, nh):
        """A Q/K/V projection of ``n`` positions to ``nh`` heads: partial
        sums in the d-sharded layout."""
        if not heads:
            add("all_reduce", tp, (b, n, nh, hd))

    def out_proj(n):
        add("all_reduce" if heads else "all_gather", tp, (b, n, d))

    def mlp(n):
        fs = fsdp_axis(cfg, rules)
        if fs is not None:
            fl = cfg.d_ff // rules.axis_size(tp)
            if cfg.act in ("silu", "gelu_glu"):
                add("all_gather", fs, (d, fl))
            add("all_gather", fs, (d, fl))
            add("all_gather", fs, (fl, d))
        add("all_reduce", tp, (b, n, d))

    b = batch_block_size(rules, shape.global_batch)
    split = batch_sharded(rules, shape.global_batch)
    s = 1 if decode else shape.seq_len
    s_text = s if decode or cfg.vision is None \
        else s - cfg.vision.num_patches
    if vocab_axis(cfg, rules) is not None:
        add("all_reduce", tp, (b, s_text, d))
    src = cfg.encoder.src_len if cfg.encoder is not None else 0
    if src and not decode:
        for _ in range(cfg.encoder.num_layers):
            proj(src, h), proj(src, kh), proj(src, kh)
            out_proj(src)
            mlp(src)
    _, n_state, _, dt_rank = M._dims(cfg)
    lead = (b,) if decode else (b, s)
    for _ in range(cfg.num_layers // len(cfg.layer_period)):
        for i, kind in enumerate(cfg.layer_period):
            if kind == "attn":
                proj(s, h), proj(s, kh), proj(s, kh)
                out_proj(s)
                if src:
                    if not decode:          # the cross K/V, then Q
                        proj(src, kh), proj(src, kh)
                    proj(s, h)
                    out_proj(s)
            else:
                add("all_reduce", tp, lead + (dt_rank + 2 * n_state,))
                add("all_reduce", tp, lead + (d,))
            if cfg.layer_uses_moe(i):
                out.extend(MOE.body_collectives(cfg, rules, b, s, el,
                                                batch_split=split))
            elif cfg.d_ff:
                mlp(s)
    if vocab_axis(cfg, rules) is not None:
        add("all_gather", tp, (b, 1, cfg.vocab))
    return out
