"""Block assembly: the dense FFN and one "period group" of sublayers, the
counterpart of ``repro/models/blocks.py``.  The FFN of a position where
``cfg.layer_uses_moe`` is the mixture of experts (``models/moe.py``).

On a mesh the dense FFN is Megatron's: ``w_gate``/``w_up`` are
column-parallel over ``model`` (the hidden's F dim), ``w_down``
row-parallel, its partial sums all-reduced; under FSDP their ``d_model``
dim is also split over ``data`` and all-gathered before use."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import act_fn, norm
from repro_torch.models.params import ParamDesc
from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import DEFAULT_RULES, AxisRules, P


def fsdp_axis(cfg: ArchConfig, rules: AxisRules) -> Optional[str]:
    """``"data"`` where FSDP splits the dense FFN's weights over it."""
    return "data" if (rules.fsdp and rules.divisible(cfg.d_ff, "data")) \
        else None


def mlp_param_descs(cfg: ArchConfig, rules: AxisRules = DEFAULT_RULES) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    tp = rules.tensor_axis
    fs = fsdp_axis(cfg, rules)
    if cfg.act in ("silu", "gelu_glu"):
        return {
            "w_gate": ParamDesc((d, f), pspec=P(fs, tp)),
            "w_up": ParamDesc((d, f), pspec=P(fs, tp)),
            "w_down": ParamDesc((f, d), pspec=P(tp, fs)),
        }
    return {
        "w_up": ParamDesc((d, f), pspec=P(fs, tp)),
        "b_up": ParamDesc((f,), "zeros", pspec=P(tp)),
        "w_down": ParamDesc((f, d), pspec=P(tp, fs)),
        "b_down": ParamDesc((d,), "zeros", pspec=P(None)),
    }


def mlp_forward(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                rules: AxisRules = DEFAULT_RULES) -> torch.Tensor:
    act = act_fn(cfg.act)
    fs = fsdp_axis(cfg, rules)

    def weight(name: str, dim: int) -> torch.Tensor:
        w = p[name]
        return w if fs is None else C.all_gather(w, rules, fs, dim)
    if "w_gate" in p:
        h = act(x @ weight("w_gate", 0)) * (x @ weight("w_up", 0))
    else:
        h = act(x @ weight("w_up", 0) + p["b_up"])
    y = C.all_reduce_sum(h @ weight("w_down", 1), rules, rules.tensor_axis)
    if "b_down" in p:
        y = y + p["b_down"]
    return y


def norm_descs(cfg: ArchConfig) -> Dict:
    d = {"scale": ParamDesc((cfg.d_model,), "ones")}
    if cfg.norm_kind == "layernorm":
        d["bias"] = ParamDesc((cfg.d_model,), "zeros")
    return d


def sublayer_descs(cfg: ArchConfig, rules: AxisRules = DEFAULT_RULES, *,
                   with_cross: bool) -> Dict[str, Dict]:
    """Param descriptors for one period of sublayers: keys "pos{i}" ->
    {"mixer_norm", "mixer", ["cross_norm", "cross"], ["ffn_norm", "ffn"]}
    (cross at attention positions of an encoder-decoder; ffn absent when
    d_ff == 0 and the position has no experts)."""
    out = {}
    for i, kind in enumerate(cfg.layer_period):
        sub: Dict[str, Any] = {"mixer_norm": norm_descs(cfg)}
        if kind == "attn":
            sub["mixer"] = attn_mod.attn_param_descs(cfg, rules)
            if with_cross:
                sub["cross_norm"] = norm_descs(cfg)
                sub["cross"] = attn_mod.attn_param_descs(cfg, rules,
                                                         cross=True)
        else:
            sub["mixer"] = mamba_mod.mamba_param_descs(cfg, rules)
        if cfg.layer_uses_moe(i):
            sub["ffn_norm"] = norm_descs(cfg)
            sub["ffn"] = moe_mod.moe_param_descs(cfg, rules)
        elif cfg.d_ff:
            sub["ffn_norm"] = norm_descs(cfg)
            sub["ffn"] = mlp_param_descs(cfg, rules)
        out[f"pos{i}"] = sub
    return out


def apply_ffn(sub: Dict, x: torch.Tensor, cfg: ArchConfig, pos_idx: int,
              rules: AxisRules = DEFAULT_RULES, *, batch_split: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual FFN sublayer at period position ``pos_idx``. Returns
    (x, aux); aux (the MoE balance loss) is 0 without experts.  On a
    mesh ``batch_split`` says whether ``x`` is this rank's block of a
    batch split over the data axes (the MoE bodies read it)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" not in sub:
        return x, aux
    h = norm(x, sub["ffn_norm"], cfg.norm_kind, cfg.norm_eps)
    if cfg.layer_uses_moe(pos_idx):
        y, aux = moe_mod.moe_ffn(sub["ffn"], h, cfg, act_fn(cfg.act), rules,
                                 batch_split=batch_split)
    else:
        y = mlp_forward(sub["ffn"], h, cfg, rules)
    return x + y, aux
