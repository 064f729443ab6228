"""Step functions of the serving path: prefill and greedy decode, the
counterparts of ``make_prefill_step`` and ``make_serve_step`` in
``repro/serving/steps.py``.  The model holds its parameters, so the steps
take none.  Sampled decode and the train step are not ported yet
(ROADMAP queue 1)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.model import Model


def _model_inputs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch's inputs besides the tokens: whisper's ``frames``.
    paligemma's ``patches`` raise until the vision prefix is ported."""
    if "patches" in batch:
        raise NotImplementedError("a batch with patches (paligemma's "
                                  "vision prefix) is not ported yet "
                                  "(ROADMAP queue 1)")
    return {"frames": batch["frames"]} if "frames" in batch else {}


def make_prefill_step(model: Model, cache_len: Optional[int] = None):
    def prefill_step(batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, _, cache = model.forward(
            batch["tokens"], return_cache=True, cache_len=cache_len,
            last_logit_only=True, **_model_inputs(batch))
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(model: Model, *, greedy: bool = True):
    """One decode step: cache + current token -> next token + cache."""
    if not greedy:
        raise NotImplementedError("sampled decode is not ported yet "
                                  "(ROADMAP queue 1)")

    def serve_step(cache: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]):
        logits, cache = model.decode_step(cache, batch["tokens"])
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return {"next_token": nxt, "logits": logits}, cache

    return serve_step
