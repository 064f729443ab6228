"""Roofline terms of one step on H100s, the port's counterpart of
``repro/launch/roofline.py``.

    compute term    = FLOPs per device / PEAK_FLOPS[precision]
    memory term     = HBM bytes per device / HBM_BW
    collective term = link bytes per device / LINK_BW

The FLOPs and bytes are the reference's analytic model, formula for
formula (bf16 weights, its activation passes): for the same ``(cfg,
shape, chips, model_par, fsdp)`` ``analytic_costs`` and ``model_flops``
give the reference's numbers to the last bit.  MODEL_FLOPS = 6·N·D
(train) or 2·N·D (inference), N = active params, D = tokens processed.
Only the peaks differ: those of one H100 SXM5 below, where the reference
has a TPU's.  ``mfu`` divides a step's model FLOPs by its measured time
at a precision's peak.

The reference reads the collective bytes from XLA's HLO
(``launch/hlo_analysis.py``, which has no counterpart); here ``build``
takes them from the caller: the dry run counts a sharded step's
collectives analytically (``sharding.collectives.step_collectives``,
held equal to what a real run records) and turns them into link bytes
at the reference's ring costs.  ``LINK_BW`` is NVLink 4's rate on the
H100 SXM datasheet, not a measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.configs import (ArchConfig, RunShape, active_param_count,
                                 param_count)

# NVIDIA H100 SXM5 datasheet, dense (no sparsity), at the 700 W limit.
# float64: 67 TFLOP/s is the tensor cores' (DMMA) rate; the CUDA cores'
# float64 rate is 34 TFLOP/s.  float32: the CUDA cores (TF32 off); tf32:
# the tensor cores.
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
    "float64": 67e12,
}
HBM_BW = 3.35e12          # bytes/s, HBM3
# NVLink 4, NVIDIA's H100 SXM datasheet: 900 GB/s a GPU, both directions
# together; a ring sends one way, so 450 GB/s of it
LINK_BW = 450e9


# ---------------------------------------------------------------------------
# Analytic FLOP / HBM-byte model (the reference's, term by term)
# ---------------------------------------------------------------------------


def _attn_kv_sum(s_q: int, s_kv: int, window) -> float:
    """sum over query positions of attended KV length (causal)."""
    if window is None or window >= s_kv:
        return s_q * (s_kv + s_kv - s_q + 1) / 2 if s_q < s_kv else \
            s_kv * (s_kv + 1) / 2
    w = window
    if s_q >= s_kv:  # full causal over s_kv with window
        if s_kv <= w:
            return s_kv * (s_kv + 1) / 2
        return w * (w + 1) / 2 + (s_kv - w) * w
    return s_q * min(w, s_kv)


def analytic_costs(cfg: ArchConfig, shape: RunShape, chips: int,
                   model_par: int, *, fsdp: bool = False) -> Dict[str, float]:
    d = cfg.d_model
    b, s = shape.global_batch, shape.seq_len
    mode = shape.mode
    decode = mode == "decode"
    tokens = b * (1 if decode else s)
    n_total = param_count(cfg)
    n_active = active_param_count(cfg)
    data_shards = max(chips // model_par, 1)

    # ---- FLOPs (global) ----
    embed_params = cfg.vocab * d
    lin = 2.0 * (n_active - embed_params) * tokens
    n_attn = sum(1 for i in range(cfg.num_layers) if cfg.block_kind(i) == "attn")
    n_mamba = cfg.num_layers - n_attn
    h, hd = max(cfg.num_heads, 1), cfg.hd
    s_q = 1 if decode else s
    s_kv = min(s, cfg.sliding_window) if (decode and cfg.sliding_window) else s
    kv_sum = _attn_kv_sum(s_q, s_kv, cfg.sliding_window)
    attn = 4.0 * h * hd * kv_sum * n_attn * b
    cross = 0.0
    if cfg.encoder is not None:
        src = cfg.encoder.src_len
        if not decode:
            # encoder self-attn + decoder cross-attn + encoder linears
            enc_tok = b * src
            enc_lin = cfg.encoder.num_layers * (4 * d * h * hd + 3 * d * cfg.d_ff)
            cross += 2.0 * enc_lin * enc_tok
            cross += 4.0 * h * hd * src * src * cfg.encoder.num_layers * b
        cross += 4.0 * h * hd * s_q * src * cfg.num_layers * b
    ssm = 0.0
    if n_mamba and cfg.ssm:
        d_in = cfg.ssm.expand * d
        per_tok = 9.0 * d_in * cfg.ssm.d_state + 2.0 * cfg.ssm.d_conv * d_in
        ssm = per_tok * n_mamba * tokens
    flops = lin + attn + cross + ssm
    if mode == "train":
        flops *= 3.0  # fwd + 2x bwd

    # ---- HBM bytes (per device) ----
    p2 = 2.0 * n_total / model_par            # local bf16 weights (post-AG)
    if cfg.moe is not None and decode:
        # decode touches ~tokens*topk experts of E
        m = cfg.moe
        touched = min(1.0, b * m.top_k / m.num_experts * 1.5)
        n_moe_layers = sum(1 for i in range(cfg.num_layers)
                           if cfg.layer_uses_moe(i))
        expert_bytes = 2.0 * n_moe_layers * m.num_experts * 3 * d * \
            m.d_ff_expert / model_par
        p2 = p2 - expert_bytes * (1.0 - touched)
    tok_local = tokens / data_shards if b % data_shards == 0 or not decode \
        else tokens / min(data_shards, max(b, 1))
    tok_local = max(tok_local, tokens / chips)
    act_passes = {"train": 30.0, "prefill": 12.0, "decode": 12.0}[mode]
    act = act_passes * cfg.num_layers * tok_local * d * 2.0
    logits = tok_local * cfg.vocab / model_par * 2.0 * (3 if mode == "train" else 1)
    cache = 0.0
    if mode in ("decode", "prefill"):
        c_len = min(s, cfg.sliding_window) if cfg.sliding_window else s
        kh = max(cfg.num_kv_heads, 1)
        kv_total = 2.0 * n_attn * b * c_len * kh * hd * 2.0
        if cfg.ssm and n_mamba:
            kv_total += n_mamba * b * (cfg.ssm.expand * d) * cfg.ssm.d_state * 4.0
        cache = kv_total / chips * (1.0 if decode else 1.0)
    if mode == "train":
        opt_shards = model_par * (data_shards if fsdp else 1)
        params_traffic = 3.0 * p2 + 20.0 * n_total / opt_shards
    else:
        params_traffic = p2
    bytes_dev = params_traffic + act + logits + cache
    return {"flops_total": flops, "flops_per_device": flops / chips,
            "bytes_per_device": bytes_dev,
            "flops_linear": lin, "flops_attn": attn + cross, "flops_ssm": ssm,
            "bytes_params": params_traffic, "bytes_act": act + logits,
            "bytes_cache": cache}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float
    precision: str = "bfloat16"
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flop_frac: float = 0.0

    def finalize(self, precision: str = "bfloat16") -> "Roofline":
        """The three terms at ``precision``'s peak (a key of
        ``PEAK_FLOPS``), the largest of them, and the model FLOPs' share
        of all FLOPs."""
        self.precision = precision
        self.compute_s = self.flops_per_device / PEAK_FLOPS[precision]
        self.memory_s = self.bytes_per_device / HBM_BW
        self.collective_s = self.collective_bytes_per_device / LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        total = self.flops_per_device * self.chips
        self.useful_flop_frac = self.model_flops / total if total else 0.0
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def model_flops(cfg: ArchConfig, shape: RunShape) -> float:
    n_active = active_param_count(cfg)
    tokens = shape.global_batch * (1 if shape.mode == "decode" else shape.seq_len)
    mult = 6 if shape.mode == "train" else 2
    return float(mult) * n_active * tokens


def build(arch: str, shape: RunShape, mesh_name: str, chips: int,
          cfg: ArchConfig, *, model_par: int = 1, fsdp: bool = False,
          precision: str = "bfloat16",
          collective_bytes: float = 0.0) -> Roofline:
    """The roofline of one step of ``shape`` on ``chips`` cards
    (``model_par`` of them tensor-parallel), at ``precision``'s peak;
    ``collective_bytes`` is what each card sends over its links in the
    step (0: no collective term)."""
    ac = analytic_costs(cfg, shape, chips, model_par, fsdp=fsdp)
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=float(ac["flops_per_device"]),
        bytes_per_device=float(ac["bytes_per_device"]),
        collective_bytes_per_device=float(collective_bytes),
        model_flops=model_flops(cfg, shape),
    ).finalize(precision)


def mfu(cfg: ArchConfig, shape: RunShape, step_s: float, *, chips: int = 1,
        precision: str = "bfloat16") -> float:
    """Model-FLOP utilisation of a step of ``shape`` that took ``step_s``
    seconds on ``chips`` cards: ``model_flops`` over what the cards' peak
    at ``precision`` could do in that time."""
    return model_flops(cfg, shape) / (step_s * chips * PEAK_FLOPS[precision])
