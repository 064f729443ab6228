"""Whisper-small — encoder-decoder audio model; conv/mel frontend is a STUB
(input_specs supplies precomputed frame embeddings (B, 1500, 768)).
[arXiv:2212.04356]"""
from repro_torch.configs import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,                # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,              # MHA
    d_ff=3072,
    vocab=51865,
    encoder=EncoderConfig(num_layers=12, src_len=1500),
    norm_kind="layernorm",
    act="gelu",
    qkv_bias=True,
    source="arXiv:2212.04356",
)
