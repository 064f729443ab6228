"""Step functions of the serving path: prefill, and greedy or sampled
decode, the counterparts of ``make_prefill_step`` and ``make_serve_step``
in ``repro/serving/steps.py``.  The model holds its parameters, so the
steps take none.  The train step is not ported yet (ROADMAP queue 1)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.serving import sampling


def _model_inputs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch's inputs besides the tokens: paligemma's ``patches``,
    whisper's ``frames``."""
    return {k: batch[k] for k in ("patches", "frames") if k in batch}


def make_prefill_step(model: Model, cache_len: Optional[int] = None):
    def prefill_step(batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, _, cache = model.forward(
            batch["tokens"], return_cache=True, cache_len=cache_len,
            last_logit_only=True, **_model_inputs(batch))
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(model: Model, *, greedy: bool = True,
                    temperature: float = 1.0):
    """One decode step: cache + current token -> next token + cache.
    Greedy takes the argmax; otherwise the token is drawn as the
    reference draws it, ``categorical(fold_in(PRNGKey(0), pos[0]),
    logits / temperature)`` with ``pos`` the cache's after the step
    (:mod:`repro_torch.serving.sampling`)."""
    def serve_step(cache: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]):
        logits, cache = model.decode_step(cache, batch["tokens"])
        if greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            nxt = sampling.categorical(sampling.serve_key(cache["pos"]),
                                       logits / temperature)
        return {"next_token": nxt.to(torch.int32), "logits": logits}, cache

    return serve_step
