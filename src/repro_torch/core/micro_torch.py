"""The micro greedy on the device (port of ``repro/core/micro_jax.py``).

Two routes share one operand builder and the hand-written kernel
``kernels/greedy_assign`` (its plain version on the CPU):

* :func:`assign_scan_all` (``backend="fused"``, ``micro_jax.py:290-567``):
  ONE greedy covers every region of the slot; tasks are padded to an
  ``(R, N_pad)`` bucket, servers to ``(R, S_pad)``.  The locality rings
  of all regions live on the device as :class:`DeviceRings` and are
  carried across slots; the slot's one device-to-host sync is the
  assignment readback.
* :func:`assign_scan` (``backend="jax"``, ``micro_jax.py:158-262``): one
  region at a time (R = 1), its rings kept in the host ``LocalityState``
  the host walk also uses, uploaded per call and written back with fresh
  uids.  With ``fused=True`` the static score, warm bonus included, comes
  from the ``fused_score`` kernel (float32, widened to float64 on the
  device) and the greedy runs its static variant.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.micro_state import EMPTY, LocalityState
from repro_torch.kernels.compat_score import fused_score
from repro_torch.kernels.greedy_assign import (MAX_AGE, GreedyInputs,
                                               ScoreConsts, greedy_assign)
from repro_torch.obs import runtime as obs_rt
from repro_torch.sim.cluster import MODEL_SWITCH_S
from repro_torch.sim.state import _WARM_HIT_S, ACTIVE


def bucket(n: int) -> int:
    """Pad size for the task axis: powers of two below 256, multiples of
    256 above."""
    if n <= 16:
        return 16
    if n < 256:
        return 1 << (n - 1).bit_length()
    return 256 * (-(-n // 256))


@dataclasses.dataclass
class DeviceRings:
    """Locality rings of ALL regions as stacked device tensors, carried
    across slots.  Padded server rows stay EMPTY (never eligible)."""

    mids: torch.Tensor       # (R, S_pad, K) int32
    slots: torch.Tensor      # (R, S_pad, K) int32
    embeds: torch.Tensor     # (R, S_pad, K, E) float32
    norms: torch.Tensor      # (R, S_pad, K) float32

    @property
    def embed_dim(self) -> int:
        return self.embeds.shape[3]

    @classmethod
    def empty(cls, n_regions: int, s_pad: int, keep: int, embed_dim: int,
              device: torch.device) -> "DeviceRings":
        shape = (n_regions, s_pad, keep)
        return cls(
            mids=torch.full(shape, EMPTY, dtype=torch.int32, device=device),
            slots=torch.zeros(shape, dtype=torch.int32, device=device),
            embeds=torch.zeros(shape + (embed_dim,), dtype=torch.float32,
                               device=device),
            norms=torch.zeros(shape, dtype=torch.float32, device=device))

    def grown(self, embed_dim: int) -> "DeviceRings":
        """Same history, embedding channel zero-padded to ``embed_dim``."""
        if embed_dim <= self.embed_dim:
            return self
        return dataclasses.replace(self, embeds=torch.nn.functional.pad(
            self.embeds, (0, embed_dim - self.embed_dim)))

    def region_state(self, ridx: int, n_servers: int) -> LocalityState:
        """One region's rings as a host ``LocalityState`` (uids synthesized
        from a per-region range, as the reference does)."""
        mids = self.mids[ridx, :n_servers].cpu().numpy()
        keep = mids.shape[1]
        base = ridx * self.mids.shape[1] * keep
        return LocalityState(
            mids=mids, slots=self.slots[ridx, :n_servers].cpu().numpy(),
            embeds=self.embeds[ridx, :n_servers].cpu().numpy(),
            norms=self.norms[ridx, :n_servers].cpu().numpy(),
            uid=np.arange(base + 1, base + 1 + mids.size,
                          dtype=np.int64).reshape(mids.shape),
            count=(mids != EMPTY).sum(axis=1).astype(np.int32))


def server_pad_map(region_ptr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(R, S_pad) global-index map + validity mask for the padded server
    axis (padded entries alias global index 0 but are masked inactive)."""
    sizes = np.diff(region_ptr)
    s_pad = max(int(sizes.max()), 1) if sizes.size else 1
    idx = region_ptr[:-1, None] + np.arange(s_pad)[None, :]
    valid = np.arange(s_pad)[None, :] < sizes[:, None]
    return np.where(valid, idx, 0), valid


def note_norms(t_emb: torch.Tensor) -> torch.Tensor:
    """Per-row L2 norms of the embeddings a ring stores, on ``t_emb``'s
    device, bitwise equal to each row's own ``np.linalg.norm`` (the value
    the numpy oracle writes into its rings): float32 squares summed left
    to right in float64 and rounded to float32, as OpenBLAS's ``sdot``
    does for rows shorter than 32, then a square root rounded once to
    float32 (the float64 root of a float32, rounded, is the correctly
    rounded float32 root).  Zero-padded columns add exact zeros."""
    acc = torch.zeros(t_emb.shape[:-1], dtype=torch.float64,
                      device=t_emb.device)
    for e in range(t_emb.shape[-1]):
        acc = acc + (t_emb[..., e] * t_emb[..., e]).double()
    return acc.float().double().sqrt().float()


def _pad_embeds(embeds: np.ndarray, width: int) -> np.ndarray:
    """Zero-pad the task embeddings to the carried rings' width (exact:
    the extra dot terms are 0.0)."""
    if embeds.shape[1] < width:
        embeds = np.pad(embeds, ((0, 0), (0, width - embeds.shape[1])))
    return embeds


def _greedy_inputs(obs, gmap, valid, ridx_rows, n_pad, rings, dev, *,
                   mem_t, work, mids, kind_ids, embeds, has_embed,
                   norms) -> Tuple[GreedyInputs, np.ndarray]:
    """The greedy's operands for ``R = gmap.shape[0]`` regions: servers
    gathered through the padded map ``gmap``/``valid``, rows scattered to
    ``(R, n_pad)`` by their region ``ridx_rows`` in appearance order, and
    ``rings`` the (mids, slots, embeds, norms) device tensors.  Returns
    the operands and each row's position within its region."""
    from repro_torch.core import micro
    st = obs.state
    r = gmap.shape[0]
    n = len(work)
    slot_s = obs.slot_seconds
    counts = np.bincount(ridx_rows, minlength=r)

    # position of each row within its region (appearance order preserved)
    sort_idx = np.argsort(ridx_rows, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    pos = np.empty(n, np.int64)
    pos[sort_idx] = np.arange(n) - starts[ridx_rows[sort_idx]]

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def scatter(values, dtype):
        out = np.zeros((r, n_pad) + values.shape[1:], dtype)
        out[ridx_rows, pos] = values
        return to_dev(out)

    util = to_dev(st.util[gmap])
    proj0 = to_dev(np.where(valid, st.queue_s[gmap], 0.0).astype(np.float64))
    t_kinds = scatter(kind_ids, np.int32)
    t_emb = scatter(embeds, np.float32)
    x = GreedyInputs(
        tflops=to_dev(st.tflops[gmap]), mem_s=to_dev(st.mem_gb[gmap]),
        kind_s=to_dev(st.kind_id[gmap].astype(np.int32)),
        # Eq 9 load term is static during the pass (util/queue snapshot)
        load=torch.exp(-(util + proj0 / max(slot_s, 1e-9))),
        cur_model=to_dev(st.current_model[gmap].astype(np.int32)),
        warm_srv=to_dev(st.warm_models[gmap].astype(np.int32)),
        switch_scale=to_dev(st.switch_scale[gmap]),
        active=to_dev((st.state[gmap] == ACTIVE) & valid),
        # host numpy true division, as the numpy oracle computes it
        speed=to_dev(np.maximum(st.tflops[gmap] / 112.0, 0.1)),
        proj0=proj0,
        l_mids=rings[0], l_slots=rings[1], l_emb=rings[2], l_nrm=rings[3],
        t_mids=scatter(mids, np.int32), t_kinds=t_kinds,
        t_mem=scatter(mem_t, np.float64), t_work=scatter(work, np.float64),
        t_demand=to_dev(micro._DEMAND_BY_KIND.astype(np.float64))[
            t_kinds.long()],
        t_emb=t_emb, t_norms=scatter(norms, np.float32),
        t_note=note_norms(t_emb),
        t_has=scatter(has_embed, bool),
        n_real=to_dev(counts.astype(np.int64)),
        # exp(LOC_DECAY * age) for every clipped age, computed once on the
        # CPU so the table is the same whichever device runs the greedy
        decay=torch.exp(micro.LOC_DECAY * torch.arange(
            MAX_AGE + 1, dtype=torch.float64)).to(dev),
        t=int(obs.t), slot_s=float(slot_s),
        consts=ScoreConsts(micro.W_HW, micro.W_LOAD, micro.W_LOC,
                           micro.W_WARM, micro.W_MODEL, micro.W_EMBED,
                           _WARM_HIT_S, MODEL_SWITCH_S))
    return x, pos


def assign_scan_all(alloc, obs, ridx_rows: np.ndarray, *, mem_t, work, mids,
                    kind_ids, embeds, has_embed, norms) -> np.ndarray:
    """Host wrapper of the fused greedy.  ``ridx_rows[i]`` is the target
    region of row ``i``; rows are already in each region's greedy order.
    Returns the per-row server index within its region (-1 = buffer).
    The rings stay on ``alloc.device`` in ``alloc._dev_rings``."""
    st = obs.state
    r = st.n_regions
    if len(work) == 0:
        return np.zeros(0, np.int32)
    gmap, valid = server_pad_map(st.region_ptr)
    s_pad = gmap.shape[1]
    rings = alloc._ensure_dev_rings(r, s_pad, max(embeds.shape[1], 1))
    embeds = _pad_embeds(embeds, rings.embed_dim)
    n_pad = bucket(int(np.bincount(ridx_rows, minlength=r).max()))
    obs_rt.count_new_shape("micro.shape.scan_all",
                           f"{r}x{n_pad}x{s_pad}x{rings.embed_dim}")
    x, pos = _greedy_inputs(
        obs, gmap, valid, ridx_rows, n_pad,
        (rings.mids, rings.slots, rings.embeds, rings.norms), alloc.device,
        mem_t=mem_t, work=work, mids=mids, kind_ids=kind_ids, embeds=embeds,
        has_embed=has_embed, norms=norms)
    out, new_rings = greedy_assign(x)
    alloc._dev_rings = DeviceRings(*new_rings)
    obs_rt.count("micro.host_sync.scan_all")
    with obs_rt.span("micro.host_sync"):
        out_np = out.cpu().numpy()         # the one device->host sync
    return out_np[ridx_rows, pos].astype(np.int32)


def assign_scan(alloc, obs, ridx: int, lstate: LocalityState, *, mem_t,
                work, mids, kind_ids, embeds, has_embed,
                norms) -> np.ndarray:
    """One region's pre-sorted tasks through the greedy at R = 1, its
    rings uploaded from ``lstate`` and written back into it.  Returns the
    per-task server index (-1 = buffer), identical to the host walk's
    for ``alloc.fused=False``."""
    from repro_torch.core import micro
    st = obs.state
    sl = st.region_slice(ridx)
    n = len(work)
    s_total = sl.stop - sl.start
    dev = alloc.device
    embeds = _pad_embeds(embeds, lstate.embed_dim)
    n_pad = bucket(n)
    obs_rt.count_new_shape("micro.shape.scan", f"{n_pad}x{s_total}")
    gmap = np.arange(sl.start, sl.stop)[None, :]
    rings = tuple(torch.from_numpy(a[None]).to(dev) for a in (
        lstate.mids, lstate.slots, lstate.embeds, lstate.norms))
    x, _ = _greedy_inputs(
        obs, gmap, np.ones(gmap.shape, bool), np.zeros(n, np.int64), n_pad,
        rings, dev, mem_t=mem_t, work=work, mids=mids, kind_ids=kind_ids,
        embeds=embeds, has_embed=has_embed, norms=norms)
    if alloc.fused:
        # hw + load + warm in one float32 kernel, widened on the device;
        # the greedy adds only the locality term to it
        def f32(a):
            return torch.from_numpy(np.ascontiguousarray(
                a, dtype=np.float32)).to(dev)
        server_models = np.concatenate(
            [st.current_model[sl][:, None], st.warm_models[sl]], axis=1)
        score = fused_score(
            f32(micro.task_feature_arrays(kind_ids, mem_t)),
            f32(micro.server_feature_matrix(st, sl, obs.slot_seconds)),
            f32(mids), f32(server_models))
        static = torch.zeros((1, n_pad, s_total), dtype=torch.float64,
                             device=dev)
        static[0, :n] = score.double()
        x = dataclasses.replace(x, static=static)
    out, new_rings = greedy_assign(x)
    obs_rt.count("micro.host_sync.scan")
    with obs_rt.span("micro.host_sync"):
        out_np = out[0, :n].cpu().numpy()  # waits for the greedy
    _writeback(alloc, lstate, tuple(a[0].cpu().numpy() for a in new_rings))
    return out_np.astype(np.int32)


def _writeback(alloc, lstate: LocalityState, rings) -> None:
    """Copy the scanned rings back into the region's ``LocalityState``,
    refreshing uids (the walk's cache keys must be unique, not stable)
    and counts."""
    l_mids, l_slots, l_emb, l_nrm = rings
    lstate.mids[...] = l_mids
    lstate.slots[...] = l_slots
    lstate.embeds[...] = l_emb
    lstate.norms[...] = l_nrm
    lstate.count[...] = (l_mids != EMPTY).sum(axis=1).astype(np.int32)
    n_entries = lstate.uid.size
    lstate.uid[...] = np.arange(alloc._uid + 1, alloc._uid + 1 + n_entries,
                                dtype=np.int64).reshape(lstate.uid.shape)
    alloc._uid += n_entries
