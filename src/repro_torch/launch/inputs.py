"""``input_specs()`` / ``cache_specs()``: ``meta``-device stand-ins for
every input of a step, per (architecture x run shape), the port's
counterparts of ``repro/launch/inputs.py``.  Nothing is allocated: a
``meta`` tensor has a shape and a dtype and no storage.

The reference returns a pair (shape structs, ``PartitionSpec`` trees);
this module returns the first half, with the same keys.  The partition
specs come with the port's sharding tier, which is not ported yet.

Modality frontends are stubbed, as in the reference: whisper receives
precomputed conv/mel frame embeddings, paligemma precomputed SigLIP patch
embeddings, both as correctly shaped inputs of ``dtype``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import ArchConfig, RunShape
from repro_torch.models.model import cache_shapes


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: RunShape, *,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """The step's ``batch`` argument: ``tokens`` (and ``labels`` to train)
    as int32, paligemma's ``patches`` and whisper's ``frames`` (not to
    decode) in ``dtype``.  A vision prefix takes its positions out of the
    sequence's."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, torch.Tensor] = {}
    s_text = S
    if cfg.vision is not None:
        s_text = S - cfg.vision.num_patches
        specs["patches"] = _meta(
            (B, cfg.vision.num_patches, cfg.vision.embed_dim), dtype)
    if cfg.encoder is not None and shape.mode != "decode":
        specs["frames"] = _meta((B, cfg.encoder.src_len, cfg.d_model), dtype)
    if shape.mode == "train":
        specs["tokens"] = _meta((B, s_text), torch.int32)
        specs["labels"] = _meta((B, s_text), torch.int32)
    elif shape.mode == "prefill":
        specs["tokens"] = _meta((B, s_text), torch.int32)
    else:  # decode: one new token; the cache is a separate argument
        specs["tokens"] = _meta((B, 1), torch.int32)
    return specs


def cache_specs(cfg: ArchConfig, shape: RunShape, *,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """The decode cache of ``shape``'s batch and sequence length."""
    return cache_shapes(cfg, shape.global_batch, shape.seq_len, dtype=dtype)
