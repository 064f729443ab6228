"""Falcon-Mamba-7B — pure Mamba-1 SSM, attention-free. [arXiv:2410.05355]"""
from repro_torch.configs import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                       # mamba blocks have no separate FFN
    vocab=65024,
    layer_period=("mamba",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2410.05355",
)
