"""Continuous-batching model servers driven by a routing callback, the
counterpart of ``repro/serving/serve_loop.py``.

Each replica hosts one model at a time with a fixed-slot decode batch;
admission runs a real prefill and splices the request's KV/SSM cache into
a free slot; every tick advances one decode step for the whole batch
(empty slots included).  Model switches take ``switch_ticks`` ticks and
wait until the batch has drained.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    id: int
    model: str
    prompt: np.ndarray             # (S,) int32
    max_new: int = 16
    submit_tick: int = 0
    first_token_tick: Optional[int] = None
    done_tick: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)


class Replica:
    """One model server: fixed decode-slot batch + per-slot request state.
    ``models`` maps a model name to a :class:`Model` on ``device``."""

    def __init__(self, models: Dict[str, Model], *, max_batch: int = 4,
                 cache_len: int = 128, switch_ticks: int = 2,
                 device="cuda"):
        self.device = resolve_device(device)
        self.models = models
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.switch_ticks = switch_ticks
        self.current: Optional[str] = None
        self.switch_remaining = 0
        self.cache: Optional[Dict[str, torch.Tensor]] = None
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.tokens = np.zeros((max_batch, 1), np.int32)
        self.n_switches = 0
        self.finished: List[Request] = []

    def _ensure_model(self, name: str) -> bool:
        """Returns True when the model is loaded and ready."""
        if self.switch_remaining > 0:
            return False                       # switch in flight: no preempt
        if self.current == name:
            return True
        if any(s is not None for s in self.slots):
            return False                       # drain before switching
        self.current = name
        self.n_switches += 1
        self.switch_remaining = self.switch_ticks
        self.cache = self.models[name].init_cache(
            self.max_batch, self.cache_len, dtype=torch.float32)
        return False

    def has_free_slot(self) -> bool:
        return any(s is None for s in self.slots)

    def admit(self, req: Request, tick: int) -> bool:
        if not self._ensure_model(req.model):
            return False
        if not self.has_free_slot():
            return False
        slot = self.slots.index(None)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                                 device=self.device)
        _, _, one = self.models[req.model].forward(
            prompt, return_cache=True, cache_len=self.cache_len)
        # splice the request's cache into this slot: batch at axis 2 of the
        # stacked (G, n, B, ...) caches, at axis 0 of pos
        for key, big in self.cache.items():
            if key == "pos":
                big[slot] = one[key][0]
            else:
                big[:, :, slot] = one[key][:, :, 0]
        self.slots[slot] = req
        self.tokens[slot, 0] = int(req.prompt[-1])
        return True

    def step(self, tick: int) -> None:
        if self.switch_remaining > 0:
            self.switch_remaining -= 1
            return
        if self.current is None or all(s is None for s in self.slots):
            return
        logits, self.cache = self.models[self.current].decode_step(
            self.cache, torch.as_tensor(self.tokens, device=self.device))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            if req.first_token_tick is None:
                req.first_token_tick = tick
            req.output.append(int(nxt[b]))
            self.tokens[b, 0] = int(nxt[b])
            if len(req.output) >= req.max_new:
                req.done_tick = tick
                self.finished.append(req)
                self.slots[b] = None


class ServingCluster:
    """Regions x replicas, scheduled per tick by a routing callback.  Model
    ``i`` of ``model_names`` is the reduced config (2 layers, d_model 128,
    vocab 256) with weights drawn from a generator seeded ``seed + i``."""

    def __init__(self, n_regions: int, replicas_per_region: int,
                 model_names: List[str], *, seed: int = 0,
                 max_batch: int = 4, cache_len: int = 128, device="cuda"):
        dev = resolve_device(device)
        self.models: Dict[str, Model] = {}
        for i, name in enumerate(model_names):
            cfg = reduced(get_config(name), layers=2, d_model=128, vocab=256)
            gen = torch.Generator(device=dev).manual_seed(seed + i)
            self.models[name] = Model(cfg, device=dev, generator=gen)
        self.regions: List[List[Replica]] = [
            [Replica(self.models, max_batch=max_batch, cache_len=cache_len,
                     device=dev)
             for _ in range(replicas_per_region)]
            for _ in range(n_regions)]
        self.pending: List[Request] = []
        self.done: List[Request] = []
        self.tick = 0

    def submit(self, req: Request) -> None:
        req.submit_tick = self.tick
        self.pending.append(req)

    def run_tick(self, router) -> None:
        """router(request, regions) -> (region, replica_idx) or None."""
        still = []
        for req in self.pending:
            tgt = router(req, self.regions)
            ok = False
            if tgt is not None:
                ridx, pidx = tgt
                ok = self.regions[ridx][pidx].admit(req, self.tick)
            if not ok:
                still.append(req)
        self.pending = still
        for region in self.regions:
            for rep in region:
                rep.step(self.tick)
                if rep.finished:
                    self.done.extend(rep.finished)
                    rep.finished.clear()
        self.tick += 1

    def stats(self) -> Dict[str, float]:
        lats = [r.done_tick - r.submit_tick for r in self.done
                if r.done_tick is not None]
        ttft = [r.first_token_tick - r.submit_tick for r in self.done
                if r.first_token_tick is not None]
        switches = sum(rep.n_switches for reg in self.regions for rep in reg)
        return {"completed": len(self.done),
                "pending": len(self.pending),
                "mean_latency_ticks": float(np.mean(lats)) if lats else 0.0,
                "mean_ttft_ticks": float(np.mean(ttft)) if ttft else 0.0,
                "model_switches": switches}
