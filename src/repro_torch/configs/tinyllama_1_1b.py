"""TinyLlama-1.1B — llama2-arch small, GQA kv=4. [arXiv:2401.02385]"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    source="arXiv:2401.02385",
)
