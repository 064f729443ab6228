"""Architecture registry of the port: a copy of the reference's
``configs`` package (the port imports nothing of it).

Each architecture has one module ``repro_torch/configs/<id>.py`` exporting
``CONFIG: ArchConfig`` with the published dimensions (source cited in the
module docstring).  ``get_config(name)`` returns it; ``reduced(cfg)``
returns the small variant of the same family that the CPU tests run;
``param_count`` / ``active_param_count`` count a config's parameters
analytically; ``RunShape`` / ``SHAPES`` are the dry run's four input
shapes (``launch/dryrun.py``).
``tests/test_torch_contract.py`` pins every config, field by field, to
the reference's.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # fraction of extra buffer per expert in sort-based dispatch
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # load-balance aux loss weight (Switch/Mixtral style)
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default: ceil(d_model/16)


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). Frontend is stubbed:
    inputs are precomputed conv/mel frame embeddings of shape (B, src_len, d)."""
    num_layers: int
    src_len: int = 1500  # whisper: 30s audio -> 1500 frames after conv stride 2


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM frontend stub: precomputed SigLIP patch embeddings (B, num_patches, d)."""
    num_patches: int = 256
    embed_dim: int = 1152  # SigLIP-So400m width; projected to d_model


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int          # 0 for attention-free
    num_kv_heads: int
    d_ff: int               # dense-MLP hidden (0 if none)
    vocab: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    # layer pattern: for hybrids, a repeating period of block kinds.
    # kinds: "attn" | "mamba". MoE placement handled by moe_every.
    layer_period: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    moe_every: int = 1       # apply MoE FFN on layers where (idx % moe_every == moe_offset)
    moe_offset: int = 0
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStubConfig] = None
    sliding_window: Optional[int] = None   # tokens; None = full attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"           # silu (swiglu) | gelu (plain mlp)
    tie_embeddings: bool = False
    max_position: int = 1 << 20
    source: str = ""            # citation

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_period)

    @property
    def has_mamba(self) -> bool:
        return any(k == "mamba" for k in self.layer_period)

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode is natively sub-quadratic in memory:
        attention-free, or every attn layer has a sliding window."""
        if self.is_attention_free:
            return True
        return self.sliding_window is not None

    def block_kind(self, idx: int) -> str:
        return self.layer_period[idx % len(self.layer_period)]

    def layer_uses_moe(self, idx: int) -> bool:
        return self.moe is not None and (idx % self.moe_every == self.moe_offset)


@dataclass(frozen=True)
class RunShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": RunShape("train_4k", 4096, 256, "train"),
    "prefill_32k": RunShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": RunShape("decode_32k", 32768, 128, "decode"),
    "long_500k": RunShape("long_500k", 524288, 1, "decode"),
}


ARCH_IDS = [
    "mixtral-8x7b",
    "granite-20b",
    "whisper-small",
    "falcon-mamba-7b",
    "llama3-8b",
    "qwen3-moe-235b-a22b",
    "paligemma-3b",
    "tinyllama-1.1b",
    "qwen2.5-3b",
    "jamba-v0.1-52b",
]

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
    return mod.CONFIG


def list_archs() -> Sequence[str]:
    return list(ARCH_IDS)


def with_sliding_window_variant(cfg: ArchConfig,
                                window: int = 4096) -> ArchConfig:
    """The config with a sliding window of ``window`` tokens (unchanged
    where its own window is as short): full-attention archs run at
    long_500k this way."""
    if cfg.sliding_window is not None and cfg.sliding_window <= window:
        return cfg
    return replace(cfg, sliding_window=window, name=cfg.name + "+swa")


def reduced(cfg: ArchConfig, *, layers: int = 2, d_model: int = 256,
            heads: int = 4, vocab: int = 512) -> ArchConfig:
    """Reduced variant of the same family for CPU smoke tests."""
    kv = max(1, min(cfg.num_kv_heads, heads) if cfg.num_kv_heads else 0)
    if cfg.num_heads == 0:
        heads, kv = 0, 0
    moe = None
    if cfg.moe is not None:
        moe = replace(cfg.moe, num_experts=min(4, cfg.moe.num_experts),
                      top_k=min(2, cfg.moe.top_k), d_ff_expert=2 * d_model)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = replace(ssm, d_state=8)
    enc = None
    if cfg.encoder is not None:
        enc = replace(cfg.encoder, num_layers=min(2, cfg.encoder.num_layers),
                      src_len=16)
    vis = None
    if cfg.vision is not None:
        vis = replace(cfg.vision, num_patches=8, embed_dim=64)
    # keep the layer period structure but cap total layers at one full period
    period = cfg.layer_period
    n_layers = max(layers, len(period)) if len(period) > 1 else layers
    return replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=n_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=2 * d_model if cfg.d_ff else 0,
        vocab=vocab,
        head_dim=None,
        moe=moe,
        ssm=ssm,
        encoder=enc,
        vision=vis,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
    )


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (embedding + layers + head)."""
    d = cfg.d_model
    n = 0
    n += cfg.vocab * d                      # token embedding
    if not cfg.tie_embeddings:
        n += cfg.vocab * d                  # lm head
    for i in range(cfg.num_layers):
        kind = cfg.block_kind(i)
        n += d  # pre-norm scale
        if kind == "attn":
            hd = cfg.hd
            n += d * cfg.num_heads * hd          # q
            n += 2 * d * cfg.num_kv_heads * hd   # k, v
            n += cfg.num_heads * hd * d          # o
            if cfg.qkv_bias:
                n += (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
        else:  # mamba
            s = cfg.ssm or SSMConfig()
            d_in = s.expand * d
            dt_rank = s.dt_rank or -(-d // 16)
            n += d * 2 * d_in                    # in_proj (x, z)
            n += s.d_conv * d_in                 # conv1d
            n += d_in * (dt_rank + 2 * s.d_state)  # x_proj
            n += dt_rank * d_in + d_in           # dt_proj
            n += d_in * s.d_state + d_in         # A_log, D
            n += d_in * d                        # out_proj
        # FFN
        n += d  # post-norm scale
        if cfg.layer_uses_moe(i):
            m = cfg.moe
            n += d * m.num_experts               # router
            n += m.num_experts * 3 * d * m.d_ff_expert
        elif cfg.d_ff:
            mult = 3 if cfg.act in ("silu", "gelu_glu") else 2
            n += mult * d * cfg.d_ff
    n += d  # final norm
    if cfg.encoder is not None:
        e = cfg.encoder
        for _ in range(e.num_layers):
            n += 2 * d
            hd = cfg.hd
            n += d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
            n += cfg.num_heads * hd * d
            mult = 3 if cfg.act in ("silu", "gelu_glu") else 2
            n += mult * d * cfg.d_ff
        n += d
        # decoder cross-attention (one per decoder layer)
        for i in range(cfg.num_layers):
            hd = cfg.hd
            n += d + d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
            n += cfg.num_heads * hd * d
    if cfg.vision is not None:
        n += cfg.vision.embed_dim * d  # projector
    return n


def active_param_count(cfg: ArchConfig) -> int:
    """Params active per token (MoE: top_k of num_experts)."""
    if cfg.moe is None:
        return param_count(cfg)
    total = param_count(cfg)
    m = cfg.moe
    n_moe_layers = sum(1 for i in range(cfg.num_layers)
                       if cfg.layer_uses_moe(i))
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    expert_params = n_moe_layers * m.num_experts * per_expert
    active_expert = n_moe_layers * m.top_k * per_expert
    return total - expert_params + active_expert
