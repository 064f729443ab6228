"""Qwen3-MoE-235B-A22B — 128 experts top-8, GQA kv=4, head_dim 128.
[hf:Qwen/Qwen3-30B-A3B family scaling]"""
from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=0,
    vocab=151936,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    moe_every=1,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)
