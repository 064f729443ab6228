"""``input_specs()`` / ``cache_specs()``: ``meta``-device stand-ins for
every input of a step, per (architecture x run shape), the port's
counterparts of ``repro/launch/inputs.py``.  Nothing is allocated: a
``meta`` tensor has a shape and a dtype and no storage.

The reference returns a pair (shape structs, ``PartitionSpec`` trees);
here ``input_specs`` / ``cache_specs`` give the first half and
``input_pspecs`` / ``cache_pspecs`` the second, with the same keys.

Modality frontends are stubbed, as in the reference: whisper receives
precomputed conv/mel frame embeddings, paligemma precomputed SigLIP patch
embeddings, both as correctly shaped inputs of ``dtype``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ArchConfig, RunShape
from repro_torch.models import model as model_mod
from repro_torch.models.model import cache_shapes
from repro_torch.sharding.place import batch_sharded
from repro_torch.sharding.specs import AxisRules, P, batch_axes


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


def _batch_spec(rules: AxisRules, batch: int) -> Optional[Any]:
    """The batch dim's spec: the data axes where the batch divides them,
    else replicated (the reference's ``_batch_spec``)."""
    return batch_axes(rules) if batch_sharded(rules, batch) else None


def input_pspecs(cfg: ArchConfig, shape: RunShape,
                 rules: AxisRules) -> Dict[str, P]:
    """The partition specs of :func:`input_specs`' inputs."""
    bs = _batch_spec(rules, shape.global_batch)
    specs = {k: P(bs, None, None) for k in input_specs(cfg, shape)
             if k in ("patches", "frames")}
    specs["tokens"] = P(bs, None)
    if shape.mode == "train":
        specs["labels"] = P(bs, None)
    return specs


def cache_pspecs(cfg: ArchConfig, shape: RunShape,
                 rules: AxisRules) -> Dict[str, P]:
    """The partition specs of :func:`cache_specs`' cache."""
    return model_mod.cache_pspecs(cfg, rules, shape.global_batch,
                                  shape.seq_len)
