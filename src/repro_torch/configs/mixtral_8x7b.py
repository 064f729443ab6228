"""Mixtral-8x7B — MoE 8 experts top-2, GQA kv=8, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=0,                       # every FFN is MoE
    vocab=32000,
    head_dim=128,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    moe_every=1,
    sliding_window=4096,          # Mixtral SWA
    rope_theta=1e6,
    source="arXiv:2401.04088",
)
