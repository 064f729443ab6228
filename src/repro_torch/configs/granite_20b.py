"""Granite-20B code model — llama-arch dense, MQA (kv=1). [arXiv:2405.04324]"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    arch_type="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,               # MQA
    d_ff=24576,
    vocab=49152,
    rope_theta=10000.0,
    source="arXiv:2405.04324",
)
