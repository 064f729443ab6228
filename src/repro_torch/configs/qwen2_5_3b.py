"""Qwen2.5-3B — dense GQA kv=2 with QKV bias. [hf:Qwen/Qwen2.5-0.5B family]"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B",
)
