"""Block assembly: the dense FFN and one "period group" of sublayers, the
counterpart of ``repro/models/blocks.py``.  The FFN of a position where
``cfg.layer_uses_moe`` is the mixture of experts (``models/moe.py``)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import act_fn, norm
from repro_torch.models.params import ParamDesc


def mlp_param_descs(cfg: ArchConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act in ("silu", "gelu_glu"):
        return {
            "w_gate": ParamDesc((d, f)),
            "w_up": ParamDesc((d, f)),
            "w_down": ParamDesc((f, d)),
        }
    return {
        "w_up": ParamDesc((d, f)),
        "b_up": ParamDesc((f,), "zeros"),
        "w_down": ParamDesc((f, d)),
        "b_down": ParamDesc((d,), "zeros"),
    }


def mlp_forward(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    act = act_fn(cfg.act)
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_up"] + p["b_up"])
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return y


def norm_descs(cfg: ArchConfig) -> Dict:
    d = {"scale": ParamDesc((cfg.d_model,), "ones")}
    if cfg.norm_kind == "layernorm":
        d["bias"] = ParamDesc((cfg.d_model,), "zeros")
    return d


def sublayer_descs(cfg: ArchConfig, *, with_cross: bool
                   ) -> Dict[str, Dict]:
    """Param descriptors for one period of sublayers: keys "pos{i}" ->
    {"mixer_norm", "mixer", ["cross_norm", "cross"], ["ffn_norm", "ffn"]}
    (cross at attention positions of an encoder-decoder; ffn absent when
    d_ff == 0 and the position has no experts)."""
    out = {}
    for i, kind in enumerate(cfg.layer_period):
        sub: Dict[str, Any] = {"mixer_norm": norm_descs(cfg)}
        if kind == "attn":
            sub["mixer"] = attn_mod.attn_param_descs(cfg)
            if with_cross:
                sub["cross_norm"] = norm_descs(cfg)
                sub["cross"] = attn_mod.attn_param_descs(cfg)
        else:
            sub["mixer"] = mamba_mod.mamba_param_descs(cfg)
        if cfg.layer_uses_moe(i):
            sub["ffn_norm"] = norm_descs(cfg)
            sub["ffn"] = moe_mod.moe_param_descs(cfg)
        elif cfg.d_ff:
            sub["ffn_norm"] = norm_descs(cfg)
            sub["ffn"] = mlp_param_descs(cfg)
        out[f"pos{i}"] = sub
    return out


def apply_ffn(sub: Dict, x: torch.Tensor, cfg: ArchConfig, pos_idx: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual FFN sublayer at period position ``pos_idx``. Returns
    (x, aux); aux (the MoE balance loss) is 0 without experts."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" not in sub:
        return x, aux
    h = norm(x, sub["ffn_norm"], cfg.norm_kind, cfg.norm_eps)
    if cfg.layer_uses_moe(pos_idx):
        y, aux = moe_mod.moe_ffn(sub["ffn"], h, cfg, act_fn(cfg.act))
    else:
        y = mlp_forward(sub["ffn"], h, cfg)
    return x + y, aux
