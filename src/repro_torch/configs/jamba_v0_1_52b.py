"""Jamba-v0.1-52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2 on
every other layer. Period-8 grouping: position 0 attention, 1-7 Mamba; MoE on
odd positions (simplified offsets vs published, ratio faithful).
[arXiv:2403.19887]"""
from repro_torch.configs import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,                   # dense FFN on non-MoE layers
    vocab=65536,
    layer_period=("attn",) + ("mamba",) * 7,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    moe_every=2,
    moe_offset=1,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887",
)
