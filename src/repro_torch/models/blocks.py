"""Block assembly: the dense FFN and one "period group" of sublayers, the
counterpart of ``repro/models/blocks.py``.  Mixture-of-experts layers
(``repro/models/moe.py``) are not ported yet: a config with ``moe``
raises."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
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


def sublayer_descs(cfg: ArchConfig) -> Dict[str, Dict]:
    """Param descriptors for one period of sublayers: keys "pos{i}" ->
    {"mixer_norm", "mixer", ["ffn_norm", "ffn"]} (ffn absent when
    d_ff == 0)."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts layers (repro/models/moe.py) are "
            f"not ported yet (ROADMAP queue 1)")
    out = {}
    for i, kind in enumerate(cfg.layer_period):
        sub: Dict[str, Any] = {"mixer_norm": norm_descs(cfg)}
        if kind == "attn":
            sub["mixer"] = attn_mod.attn_param_descs(cfg)
        else:
            sub["mixer"] = mamba_mod.mamba_param_descs(cfg)
        if cfg.d_ff:
            sub["ffn_norm"] = norm_descs(cfg)
            sub["ffn"] = mlp_param_descs(cfg)
        out[f"pos{i}"] = sub
    return out


def apply_ffn(sub: Dict, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual FFN sublayer. Returns (x, aux); aux (the MoE balance loss)
    is 0 without experts."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" not in sub:
        return x, aux
    h = norm(x, sub["ffn_norm"], cfg.norm_kind, cfg.norm_eps)
    return x + mlp_forward(sub["ffn"], h, cfg), aux
