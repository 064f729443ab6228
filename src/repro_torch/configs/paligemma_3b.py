"""PaliGemma-3B — SigLIP vision frontend (STUB: input_specs supplies
precomputed patch embeddings) + Gemma-2B decoder. [arXiv:2407.07726]"""
from repro_torch.configs import ArchConfig, VisionStubConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    arch_type="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,               # gemma-2b MQA
    d_ff=16384,
    vocab=257216,
    head_dim=256,                 # gemma head dim
    vision=VisionStubConfig(num_patches=256, embed_dim=1152),
    act="gelu_glu",               # gemma GeGLU
    source="arXiv:2407.07726",
)
