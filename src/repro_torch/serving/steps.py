"""Step functions of the LM: train, prefill, and greedy or sampled decode,
the counterparts of ``make_train_step``, ``make_prefill_step`` and
``make_serve_step`` in ``repro/serving/steps.py``.  The model holds its
parameters, so the steps take none.  The serving steps build no autograd
graph: the parameters are frozen, and the train step enables their
gradients for its own call only.  Under grad, causal self-attention
takes the ``flash_prefill`` kernel's autograd path
(``kernels/flash_prefill/autograd.py``) and a Mamba layer's scan the
``selective_scan`` kernel's (``kernels/selective_scan/autograd.py``),
whose backward is the ``selective_scan_bwd`` kernel."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adam import Adam, AdamState
from repro_torch.serving import sampling


def lm_loss(logits: torch.Tensor, labels: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross entropy.  labels: (B, S) int, -1 = ignore;
    logits: (B, S, V), ``logits[:, t]`` predicting ``labels[:, t]``.
    Returns (mean loss over the kept labels, their count, at least 1),
    both tensors on the logits' device, in float32 (float64 for float64
    logits)."""
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(lf.dtype)
    nll = (lse - ll) * mask
    denom = mask.sum().clamp_min(1.0)
    return nll.sum() / denom, denom


def _model_inputs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch's inputs besides the tokens: paligemma's ``patches``,
    whisper's ``frames``."""
    return {k: batch[k] for k in ("patches", "frames") if k in batch}


def _full_labels(model: Model, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """The labels aligned with the model's output: a vision prefix's P
    positions get the ignore label -1 before the text's."""
    labels = batch["labels"]
    if model.cfg.vision is not None and "patches" in batch:
        pre = torch.full((labels.shape[0], batch["patches"].shape[1]), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pre, labels], dim=1)
    return labels


def train_grads(model: Model, batch: Dict[str, torch.Tensor],
                aux_weight: float = 0.01
                ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The gradients of ``loss + aux_weight * moe_aux`` on ``batch``
    (``tokens``, ``labels`` and the model's other inputs) with respect to
    ``list(model.parameters())``, in that order, and the metrics
    ``{"loss", "moe_aux", "tokens"}`` as tensors on the model's device.
    The parameters require grad for this call only."""
    params = list(model.parameters())
    try:
        with torch.enable_grad():
            for p in params:
                p.requires_grad_(True)
            logits, aux, _ = model(batch["tokens"], **_model_inputs(batch))
            loss, denom = lm_loss(logits, _full_labels(model, batch))
            total = loss + aux_weight * aux
            grads = torch.autograd.grad(total, params, allow_unused=True)
    finally:
        for p in params:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    return grads, {"loss": loss.detach(), "moe_aux": aux.detach(),
                   "tokens": denom}


def make_train_step(model: Model, optimizer: Adam, aux_weight: float = 0.01):
    """One optimizer step on a batch: :func:`train_grads`, then
    ``optimizer.update_in_place``: ``update`` and ``apply_updates`` into
    the model's parameters, the same bits, with the gradients and the
    state's moments updated in place (16 B a float32 parameter, not 32).
    The model holds its parameters, so the step
    takes ``(opt_state, batch)`` and returns ``(opt_state, metrics)``;
    ``opt_state`` is ``optimizer.init(list(model.parameters()))``.  The
    gradients are in the parameters' registration order, which
    ``clip_by_global_norm`` sums in."""
    params = list(model.parameters())

    def train_step(opt_state: AdamState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[AdamState, Dict[str, torch.Tensor]]:
        grads, metrics = train_grads(model, batch, aux_weight)
        return optimizer.update_in_place(grads, opt_state, params), metrics

    return train_step


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
