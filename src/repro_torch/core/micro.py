"""Micro-level allocation (§V-C), port of ``repro/core/micro.py``: dynamic
server activation (Eq 6) + greedy task-server matching by compatibility
score (Eqs 7-10) + task buffering.

Four backends, as in the reference:

* ``"fused"`` (the port's default): ONE multi-region greedy per slot
  (``core/micro_torch.assign_scan_all``, the ``greedy_assign`` kernel on
  the card) with the locality rings of all regions kept on the device;
* ``"jax"``: the same kernel one region at a time
  (``micro_torch.assign_scan``), the region's rings in a host
  ``LocalityState``; with ``fused=True`` its static score comes from the
  ``fused_score`` kernel (float32);
* ``"pallas"``: the host greedy walk, its hw+load matrix from the
  ``compat_score`` kernel (float32, read back as float64);
* ``"numpy"``: the same walk with the float64 ``hw_load_matrix_np``, the
  route's plain form.

The Eq-6 activation targets stay host arithmetic, as in the reference.
So do the scalar Eq 7-10 functions (``score`` and its terms,
``LocalityTracker``), the float64 oracle of the batched matrix that the
frozen per-object reference (``sim/reference.py``) scores with, and the
object-path entry ``MicroAllocator.assign_region``, which sorts and packs
``Task`` objects for the same per-region core as ``assign_batch``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.micro_state import LocalityState
from repro_torch.core.micro_torch import (DeviceRings, assign_scan,
                                          assign_scan_all)
from repro_torch.kernels.compat_score import score_matrix
from repro_torch.obs import runtime as obs_rt
from repro_torch.sim.state import ACTIVE, MODEL_NAMES, ClusterState, model_id

W_HW, W_LOAD, W_LOC = 0.4, 0.4, 0.2      # Eq 7 weights
W_WARM = 2.0                             # same-model (no-switch) bonus
W_MODEL, W_EMBED = 0.7, 0.3              # Eq 10 similarity weights
LOC_DECAY = 0.5                          # lambda in Eq 10

# compute requirement proxy: task kind maps to a tflops demand (Eq 8)
DEMAND_TFLOPS = {"compute": 200.0, "memory": 100.0, "lightweight": 60.0}
KIND_ORDER = ("compute", "memory", "lightweight")
_KIND_IDX = {k: i for i, k in enumerate(KIND_ORDER)}
_DEMAND_BY_KIND = np.array([DEMAND_TFLOPS[k] for k in KIND_ORDER])

# model-id -> lexicographic rank of the model name, so the greedy order
# (deadline, model name, -work) is one np.lexsort over ids
_MODEL_RANK = np.empty(len(MODEL_NAMES), np.int64)
_MODEL_RANK[np.argsort(np.array(MODEL_NAMES))] = np.arange(len(MODEL_NAMES))

# server-feature "capacity" channel fed to the compat_score kernel: the
# kernel computes load = exp(-4*(util+queue)/cap), so cap=4 reduces it to
# this module's Eq 9 form exp(-(util+queue))
KERNEL_LOAD_CAP = 4.0


def target_active_servers(queue_tasks: float, predicted: float,
                          avg_capacity: float, n_servers: int, *,
                          sigma: float = 1.0, headroom: float = 2.0) -> int:
    """Eq 6: N_target = min(S_r, ceil((Q + F + sigma*sqrt(F)) / C_avg)),
    scaled by ``headroom``."""
    f = max(predicted, 0.0)
    need = (queue_tasks + f + sigma * math.sqrt(f)) / max(avg_capacity, 1e-9)
    return int(min(n_servers, max(1, math.ceil(headroom * need))))


# ---------------------------------------------------------------------------
# scalar Eq 7-10 reference (host float64; the oracle of the batched path,
# scored by sim/reference.py)
# ---------------------------------------------------------------------------


def hw_compatibility(task, srv) -> float:
    """Eq 8: min(1, compute ratio) * min(1, memory ratio) * type match."""
    demand = DEMAND_TFLOPS[task.kind]
    c = min(1.0, srv.tflops / demand)
    m = min(1.0, srv.mem_gb / max(task.mem_gb, 1e-9))
    type_match = 1.0 if srv.kind == task.kind else 0.5
    return c * m * type_match


def load_compatibility(srv, slot_s: float) -> float:
    """Eq 9: exp(-(util + queue)), the queue as slot-time occupancy."""
    q_norm = srv.queue_s / max(slot_s, 1e-9)
    return math.exp(-(srv.util + q_norm))


@dataclasses.dataclass
class RecentTask:
    model: Optional[str]         # None for history entries with mid < 0
    embed: Optional[np.ndarray]
    slot: int
    # derived facts the column form reads (the scalar form recomputes them)
    mid: int = -1
    norm: float = 0.0
    uid: int = -1                # tracker-unique id (the cache key)


class LocalityTracker:
    """Recent-task history per (region, server) for Eq 10, newest first."""

    def __init__(self, keep: int = 4):
        self.keep = keep
        self.recent: Dict[Tuple[int, int], List[RecentTask]] = {}
        self._uid = 0

    def note(self, key: Tuple[int, int], task, t: int) -> None:
        self.note_fields(key, model_id(task.model), task.embed, t)

    def note_fields(self, key: Tuple[int, int], mid: int,
                    embed: Optional[np.ndarray], t: int) -> None:
        """Record an entry by model id and embedding row."""
        lst = self.recent.setdefault(key, [])
        norm = np.linalg.norm(embed) if embed is not None else 0.0
        self._uid += 1
        lst.insert(0, RecentTask(MODEL_NAMES[mid] if mid >= 0 else None,
                                 embed, t, mid=mid, norm=norm,
                                 uid=self._uid))
        del lst[self.keep:]

    def locality(self, key: Tuple[int, int], task, t: int) -> float:
        total = 0.0
        for rt in self.recent.get(key, ()):
            sim = W_MODEL * (1.0 if rt.model == task.model else 0.0)
            if task.embed is not None and rt.embed is not None:
                denom = (np.linalg.norm(task.embed) * np.linalg.norm(rt.embed))
                if denom > 1e-9:
                    sim += W_EMBED * float(task.embed @ rt.embed) / denom
            total += sim / math.exp(LOC_DECAY * min(max(t - rt.slot, 0), 40))
        return total

    def locality_column(self, key: Tuple[int, int], mids: np.ndarray,
                        embeds: np.ndarray, norms: np.ndarray,
                        has_embed: np.ndarray, t: int,
                        cache: Optional[dict] = None) -> np.ndarray:
        """(N,) Eq-10 locality of every task against one server's
        history, :meth:`locality` over a column in the same order.
        ``cache`` memoizes each entry's contribution within one slot,
        keyed by its uid."""
        recent = self.recent.get(key)
        n = len(mids)
        if not recent:
            return np.zeros(n)
        col = np.zeros(n)
        for rt in recent:
            contrib = cache.get(rt.uid) if cache is not None else None
            if contrib is None:
                sim = W_MODEL * (mids == rt.mid).astype(np.float64)
                if rt.embed is not None and has_embed.any():
                    denom = norms * rt.norm
                    ok = has_embed & (denom > 1e-9)
                    dots = embeds @ rt.embed
                    safe = np.where(ok, denom, 1.0)
                    sim = sim + np.where(
                        ok, W_EMBED * dots.astype(np.float64) / safe, 0.0)
                contrib = sim / math.exp(
                    LOC_DECAY * min(max(t - rt.slot, 0), 40))
                if cache is not None:
                    cache[rt.uid] = contrib
            col += contrib
        return col


def score(task, srv, key: Tuple[int, int], t: int, slot_s: float,
          loc: LocalityTracker) -> float:
    """Eq 7 plus the warm-model bonus (a same-model hit skips the whole
    Fig-3 switch pipeline)."""
    warm = 1.0 if srv.current_model == task.model else (
        0.4 if task.model in srv.warm_models else 0.0)
    return (W_HW * hw_compatibility(task, srv)
            + W_LOAD * load_compatibility(srv, slot_s)
            + W_LOC * loc.locality(key, task, t)
            + W_WARM * warm)


def task_feature_matrix(tasks: Sequence) -> np.ndarray:
    """(N, 8) float64 of ``Task`` objects: [demand_tflops, mem_gb, kind
    one-hot x3, 0, 0, 0]."""
    n = len(tasks)
    f = np.zeros((n, 8))
    for i, t in enumerate(tasks):
        f[i, 0] = DEMAND_TFLOPS[t.kind]
        f[i, 1] = t.mem_gb
        f[i, 2 + _KIND_IDX[t.kind]] = 1.0
    return f


def task_feature_arrays(kind_id: np.ndarray,
                        mem_gb: np.ndarray) -> np.ndarray:
    """(N, 8) float64: [demand_tflops, mem_gb, kind one-hot x3, 0, 0, 0]."""
    n = len(kind_id)
    f = np.zeros((n, 8))
    kid = kind_id.astype(np.int64)
    f[:, 0] = _DEMAND_BY_KIND[kid]
    f[:, 1] = mem_gb
    f[np.arange(n), 2 + kid] = 1.0
    return f


def server_feature_matrix(state: ClusterState, sl: slice,
                          slot_s: float) -> np.ndarray:
    """(S, 8) float64: [tflops, mem_gb, kind one-hot x3, util, queue_norm,
    KERNEL_LOAD_CAP]."""
    s = sl.stop - sl.start
    f = np.zeros((s, 8))
    f[:, 0] = state.tflops[sl]
    f[:, 1] = state.mem_gb[sl]
    f[np.arange(s), 2 + state.kind_id[sl].astype(np.int64)] = 1.0
    f[:, 5] = state.util[sl]
    f[:, 6] = state.queue_s[sl] / max(slot_s, 1e-9)
    f[:, 7] = KERNEL_LOAD_CAP
    return f


def hw_load_matrix_np(task_feats: np.ndarray,
                      server_feats: np.ndarray) -> np.ndarray:
    """(N, S) float64 W_HW*hw + W_LOAD*load, in the numpy oracle's op
    order (the float64 form of the ``compat_score`` kernel)."""
    demand = task_feats[:, 0][:, None]
    mem_t = task_feats[:, 1][:, None]
    tflops = server_feats[:, 0][None, :]
    mem_s = server_feats[:, 1][None, :]
    c = np.minimum(1.0, tflops / demand)
    m = np.minimum(1.0, mem_s / np.maximum(mem_t, 1e-9))
    kind_t = np.argmax(task_feats[:, 2:5], axis=1)
    kind_s = np.argmax(server_feats[:, 2:5], axis=1)
    type_match = np.where(kind_t[:, None] == kind_s[None, :], 1.0, 0.5)
    hw = c * m * type_match
    load = np.exp(-(server_feats[:, 5] + server_feats[:, 6]))[None, :]
    return W_HW * hw + W_LOAD * load


def hw_load_matrix(task_feats: np.ndarray, server_feats: np.ndarray, *,
                   backend: str = "numpy", device="cuda") -> np.ndarray:
    """(N, S) float64 W_HW*hw + W_LOAD*load.  ``backend="pallas"`` runs it
    through the ``compat_score`` kernel on ``device`` (float32, no
    locality operand), read back and widened to float64."""
    if backend == "pallas":
        dev = resolve_device(device)

        def f32(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)
        return score_matrix(f32(task_feats), f32(server_feats)).cpu() \
            .numpy().astype(np.float64)
    if backend == "numpy":
        return hw_load_matrix_np(task_feats, server_feats)
    raise ValueError(f"unknown micro backend: {backend!r}")


def batched_score_matrix(task_feats: np.ndarray, server_feats: np.ndarray,
                         locality: np.ndarray, *, backend: str = "numpy",
                         device="cuda") -> np.ndarray:
    """One (N, S) Eq 7-10 static score matrix: W_HW*hw + W_LOAD*load +
    W_LOC*locality, the locality added on the host."""
    return hw_load_matrix(task_feats, server_feats, backend=backend,
                          device=device) + W_LOC * locality


def _task_arrays(batch, sidx: np.ndarray, work: np.ndarray) -> dict:
    """The greedy's per-task arrays for ``TaskBatch`` rows ``sidx``, already
    in greedy order (``work`` is ``batch.work_s[sidx]``)."""
    embeds = batch.embeds[sidx]
    norms = np.linalg.norm(embeds, axis=1)
    return dict(mem_t=batch.mem_gb[sidx], work=work,
                mids=batch.model_idx[sidx].astype(np.int16),
                kind_ids=batch.kind_id[sidx], embeds=embeds,
                # a zero row is TaskBatch's encoding of "no embedding"
                has_embed=norms > 0.0, norms=norms)


class MicroAllocator:
    """Urgency-first greedy matching (Algorithm 1, Phase 2) on
    ``device``: every region of a slot in one greedy (``"fused"``), or one
    region at a time through ``assign_batch`` (the other backends), the
    region's rings then kept as a host ``LocalityState``."""

    KEEP = 4                      # locality history depth

    def __init__(self, sigma: float = 1.0, headroom: float = 2.0, *,
                 backend: str = "fused", fused: bool = False,
                 device="cuda"):
        if backend not in ("numpy", "pallas", "jax", "fused"):
            raise ValueError(f"unknown micro backend: {backend!r}")
        self.sigma = sigma
        self.headroom = headroom
        self.backend = backend
        self.fused = fused
        self.device = resolve_device(device)
        self.reset()

    def reset(self) -> None:
        self._loc: Dict[int, LocalityState] = {}
        self._dev_rings: Optional[DeviceRings] = None
        self._dev_region_sizes = None
        self._uid = 0

    def locality_state(self, ridx: int) -> Optional[LocalityState]:
        """The region's rings as host arrays (None before first use).  For
        the fused backend an export of the device rings (uids
        synthesized)."""
        if self._dev_rings is not None:
            return self._dev_rings.region_state(
                ridx, self._dev_region_sizes[ridx])
        return self._loc.get(ridx)

    def locality_tracker(self) -> LocalityTracker:
        """All regions' history as one ``LocalityTracker`` (interop and
        debugging; scores are exactly equivalent).  The fused route's
        device rings are read back from the device once."""
        tracker = LocalityTracker(keep=self.KEEP)
        rings = self._dev_rings
        if rings is not None:
            host = DeviceRings(*(t.cpu() for t in (
                rings.mids, rings.slots, rings.embeds, rings.norms)))
            for ridx in range(host.mids.shape[0]):
                host.region_state(
                    ridx, self._dev_region_sizes[ridx]).to_tracker(
                        ridx, tracker)
            return tracker
        for ridx, lstate in sorted(self._loc.items()):
            lstate.to_tracker(ridx, tracker)
        return tracker

    def _state_for(self, ridx: int, n_servers: int,
                   edim: int) -> LocalityState:
        lstate = self._loc.get(ridx)
        if lstate is None or lstate.n_servers != n_servers:
            lstate = LocalityState.empty(n_servers, self.KEEP, max(edim, 1))
        elif lstate.embed_dim < edim:
            lstate = lstate.grown(edim)
        self._loc[ridx] = lstate
        return lstate

    def _ensure_dev_rings(self, n_regions: int, s_pad: int,
                          edim: int) -> DeviceRings:
        """Device rings (grown in the embed channel on demand, reset when
        the fleet shape moves)."""
        rings = self._dev_rings
        if rings is None or rings.mids.shape[:2] != (n_regions, s_pad):
            rings = DeviceRings.empty(n_regions, s_pad, self.KEEP,
                                      max(edim, 1), self.device)
        elif rings.embed_dim < edim:
            rings = rings.grown(edim)
        self._dev_rings = rings
        return rings

    def activation_target(self, obs, ridx: int, predicted: float) -> int:
        st = obs.state
        sl = st.region_slice(ridx)
        caps = st.capacity[sl]
        avg_cap = float(np.mean(caps)) if caps.size else 1.0
        return target_active_servers(
            float(obs.queue_tasks[ridx]), predicted, avg_cap,
            sl.stop - sl.start, sigma=self.sigma, headroom=self.headroom)

    def activation_targets(self, obs, pred_inbound: np.ndarray) -> np.ndarray:
        """All regions' Eq-6 targets as one ``(R,)`` array."""
        r = obs.state.n_regions
        out = np.empty(r, np.int64)
        for j in range(r):
            out[j] = self.activation_target(obs, j, float(pred_inbound[j]))
        return out

    def assign_region(self, obs, ridx: int, tasks: List
                      ) -> Dict[int, Optional[Tuple[int, int]]]:
        """Object-path entry: sorts ``Task`` objects by (deadline, model,
        -work), packs them into arrays and runs the region through the
        backend's core; returns ``{task id: (ridx, server) or None}``."""
        if not tasks:
            return {}
        with obs_rt.span("micro.assign"):
            ordered = sorted(tasks,
                             key=lambda tk: (tk.deadline_slot, tk.model,
                                             -tk.work_s))
            edim = next((tk.embed.shape[0] for tk in ordered
                         if tk.embed is not None), 1)
            embeds = np.stack([tk.embed if tk.embed is not None
                               else np.zeros(edim, np.float32)
                               for tk in ordered])
            servers = self._assign_core(
                obs, ridx,
                mem_t=np.array([tk.mem_gb for tk in ordered]),
                work=np.array([tk.work_s for tk in ordered]),
                mids=np.array([model_id(tk.model) for tk in ordered],
                              np.int16),
                kind_ids=np.array([_KIND_IDX[tk.kind] for tk in ordered],
                                  np.int8),
                embeds=embeds,
                has_embed=np.array([tk.embed is not None
                                    for tk in ordered]),
                norms=np.linalg.norm(embeds, axis=1))
        return {tk.id: ((ridx, int(s)) if s >= 0 else None)
                for tk, s in zip(ordered, servers)}

    def assign_batch_all(self, obs, batch, region_of: np.ndarray) -> np.ndarray:
        """Assign EVERY routed row of the slot's ``TaskBatch`` in one
        multi-region greedy.  ``region_of`` is the phase-1 target region
        per row (-1 = unrouted); returns the server-in-region per row
        (-1 = buffer)."""
        region_of = np.asarray(region_of)
        out = np.full(len(batch), -1, np.int32)
        rows = np.flatnonzero(region_of >= 0)
        if rows.size == 0:
            return out
        self._dev_region_sizes = obs.state.region_sizes()
        with obs_rt.span("micro.assign"):
            # one global sort: region-major, then each region's greedy
            # order (deadline, model name, -work)
            work = batch.work_s[rows]
            order = np.lexsort((-work, _MODEL_RANK[batch.model_idx[rows]],
                                batch.deadline_slot[rows],
                                region_of[rows]))
            sidx = rows[order]
            out[sidx] = assign_scan_all(self, obs, region_of[sidx],
                                        **_task_arrays(batch, sidx,
                                                       work[order]))
        return out

    def assign_batch(self, obs, ridx: int, batch,
                     idx: np.ndarray) -> np.ndarray:
        """Assign rows ``idx`` of a ``TaskBatch`` to region ``ridx``;
        returns the server-in-region per row of ``idx`` (-1 = buffer)."""
        idx = np.asarray(idx)
        if idx.size == 0:
            return np.zeros(0, np.int32)
        with obs_rt.span("micro.assign"):
            work = batch.work_s[idx]
            # greedy order: (deadline, model name, -work)
            order = np.lexsort((-work, _MODEL_RANK[batch.model_idx[idx]],
                                batch.deadline_slot[idx]))
            out = np.full(idx.size, -1, np.int32)
            out[order] = self._assign_core(
                obs, ridx, **_task_arrays(batch, idx[order], work[order]))
        return out

    def _assign_core(self, obs, ridx: int, *, mem_t: np.ndarray,
                     work: np.ndarray, mids: np.ndarray,
                     kind_ids: np.ndarray, embeds: np.ndarray,
                     has_embed: np.ndarray,
                     norms: np.ndarray) -> np.ndarray:
        """One region's pre-sorted tasks through the allocator's backend;
        returns per-task server index within the region (-1 = buffer)."""
        st = obs.state
        sl = st.region_slice(ridx)
        active = st.state[sl] == ACTIVE
        n = len(work)
        out = np.full(n, -1, np.int32)
        if n == 0 or not active.any():
            return out
        arrays = dict(mem_t=mem_t, work=work, mids=mids, kind_ids=kind_ids,
                      embeds=embeds, has_embed=has_embed, norms=norms)
        if self.backend == "fused":
            # the per-region API on the fused greedy and device rings
            self._dev_region_sizes = st.region_sizes()
            return assign_scan_all(self, obs, np.full(n, ridx, np.int64),
                                   **arrays)
        lstate = self._state_for(ridx, sl.stop - sl.start, embeds.shape[1])
        if self.backend == "jax":
            return assign_scan(self, obs, ridx, lstate, **arrays)
        return self._walk(obs, sl, lstate, active, **arrays)

    def _walk(self, obs, sl: slice, lstate: LocalityState,
              active: np.ndarray, *, mem_t, work, mids, kind_ids, embeds,
              has_embed, norms) -> np.ndarray:
        """The host greedy walk (``backend="numpy"|"pallas"``): one
        (N, S) static matrix, then tasks urgency-first, each placed on its
        best eligible server, whose projected queue, ring and score column
        are updated before the next task."""
        st = obs.state
        slot_s = obs.slot_seconds
        n = len(work)
        out = np.full(n, -1, np.int32)
        mem_s = st.mem_gb[sl]
        speed = np.maximum(st.tflops[sl] / 112.0, 0.1)
        cur = st.current_model[sl]

        tf = task_feature_arrays(kind_ids, mem_t)
        sf = server_feature_matrix(st, sl, slot_s)
        loc_cache: dict = {}
        loc0 = np.stack([lstate.column(
            i, mids, embeds, norms, has_embed, obs.t, cache=loc_cache)
            for i in range(sl.stop - sl.start)], axis=1)
        hwl = hw_load_matrix(tf, sf, backend=self.backend,
                             device=self.device)
        base = hwl + W_LOC * loc0

        warm_hit = st.warm_hit_matrix(mids, sl)
        warm = np.where(cur[None, :] == mids[:, None], 1.0,
                        np.where(warm_hit, 0.4, 0.0))
        static = base + W_WARM * warm
        exec_pen = 0.3 * (work[:, None] / speed[None, :]) / slot_s

        mem_ok = mem_s[None, :] >= mem_t[:, None]
        proj = st.queue_s[sl].astype(np.float64)
        for i in range(n):
            eligible = active & mem_ok[i] & (proj <= 16.0 * slot_s)
            if not eligible.any():
                continue                       # buffer (§V-C2 buffering)
            # projected wait penalty, superlinear so warm-model stickiness
            # never holds a backlogged server
            q_slots = proj / slot_s
            sc = (static[i] - (0.8 * q_slots + 0.4 * q_slots * q_slots)
                  ) - exec_pen[i]
            sc = np.where(eligible, sc, -np.inf)
            best = int(np.argmax(sc))
            g = sl.start + best
            proj[best] += work[i] / speed[best] \
                + st.switch_cost(g, int(mids[i]))
            self._uid += 1
            lstate.note(best, int(mids[i]),
                        embeds[i] if has_embed[i] else None,
                        obs.t, self._uid)
            # refresh this server's column so later tasks see the
            # just-placed history
            new_col = lstate.column(best, mids, embeds, norms, has_embed,
                                    obs.t, cache=loc_cache)
            static[:, best] = (hwl[:, best] + W_LOC * new_col) \
                + W_WARM * warm[:, best]
            out[i] = best
        return out
