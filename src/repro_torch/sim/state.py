"""Struct-of-arrays cluster state (port of ``repro/sim/state.py``).

``ClusterState`` flattens the fleet into region-major per-server numpy
arrays: servers of region ``r`` occupy ``region_ptr[r]:region_ptr[r+1]``.
It is the host mirror the scheduler and the engine's oracle fallbacks
read; the torch step (``sim/engine_torch.py``) uploads the columns it
needs and writes its results back here.  Per-region reductions are
sequential within a segment, which is the reference's parity contract.
``from_cluster`` / ``to_cluster`` convert losslessly to and from the
object model (``sim/cluster.py``), the view of the frozen per-object
oracle (``sim/reference.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.sim.cluster import (GPU_TYPES, MODEL_CATALOG, MODEL_SWITCH_S,
                                     SWITCH_STAGES_S, Cluster, Region,
                                     Server, make_cluster)

# server state codes
OFF, WARMING, ACTIVE = 0, 1, 2
STATE_NAMES = ("off", "warming", "active")
STATE_CODES = {n: i for i, n in enumerate(STATE_NAMES)}

KINDS = ("compute", "memory", "lightweight")
KIND_IDS = {k: i for i, k in enumerate(KINDS)}

GPU_NAMES = tuple(GPU_TYPES)
GPU_IDS = {n: i for i, n in enumerate(GPU_NAMES)}

MODEL_NAMES = tuple(MODEL_CATALOG)
MODEL_IDS = {n: i for i, n in enumerate(MODEL_NAMES)}
NO_MODEL = -1
WARM_SLOTS = 3                    # servers keep 3 warm models (MRU)

# warm cache hit cost fraction of a full switch
_WARM_HIT_S = 0.5 * (SWITCH_STAGES_S["load"] + SWITCH_STAGES_S["reconfig"])


def model_id(name: Optional[str]) -> int:
    if name is None:
        return NO_MODEL
    return MODEL_IDS[name]


@dataclasses.dataclass
class ClusterState:
    """Per-server arrays (region-major) + per-region price/segment index."""

    region_ptr: np.ndarray        # (R+1,) int64 segment offsets
    power_price: np.ndarray       # (R,) $/kWh

    # static hardware facts
    gpu_id: np.ndarray            # (S,) int8 index into GPU_NAMES
    tflops: np.ndarray            # (S,) float64
    mem_gb: np.ndarray            # (S,) float64
    power_w: np.ndarray           # (S,) float64
    kind_id: np.ndarray           # (S,) int8 index into KINDS
    capacity: np.ndarray          # (S,) float64 tasks/slot
    switch_scale: np.ndarray      # (S,) float64 vs V100

    # dynamic state
    state: np.ndarray             # (S,) int8 OFF/WARMING/ACTIVE
    warm_remaining_s: np.ndarray  # (S,) float64
    queue_s: np.ndarray           # (S,) float64 backlog gpu-seconds
    util: np.ndarray              # (S,) float64
    idle_slots: np.ndarray        # (S,) int64
    current_model: np.ndarray     # (S,) int16, NO_MODEL when empty
    warm_models: np.ndarray       # (S, WARM_SLOTS) int16 MRU, NO_MODEL pad

    # ---------------------------------------------------------------- shape

    @property
    def n_regions(self) -> int:
        return len(self.region_ptr) - 1

    @property
    def n_servers(self) -> int:
        return int(self.region_ptr[-1])

    def region_sizes(self) -> np.ndarray:
        return np.diff(self.region_ptr)

    def region_slice(self, ridx: int) -> slice:
        return slice(int(self.region_ptr[ridx]),
                     int(self.region_ptr[ridx + 1]))

    def gidx(self, ridx: int, sidx: int) -> int:
        """Global server index of server ``sidx`` within region ``ridx``."""
        return int(self.region_ptr[ridx]) + int(sidx)

    @property
    def region_of(self) -> np.ndarray:
        """(S,) region index of each server."""
        return np.repeat(np.arange(self.n_regions), self.region_sizes())

    # ----------------------------------------------------------- reductions

    def _segsum(self, values: np.ndarray) -> np.ndarray:
        """Per-region sum; sequential within segments; empty regions sum
        to 0."""
        sizes = self.region_sizes()
        if self.n_servers == 0 or np.any(sizes == 0):
            out = np.zeros(self.n_regions)
            for r in range(self.n_regions):
                sl = self.region_slice(r)
                if sl.stop > sl.start:
                    out[r] = np.add.reduce(values[sl])
            return out
        return np.add.reduceat(values, self.region_ptr[:-1])

    def active_mask(self) -> np.ndarray:
        return self.state == ACTIVE

    def capacities(self) -> np.ndarray:
        """(R,) active tasks/slot per region."""
        return self._segsum(np.where(self.active_mask(), self.capacity, 0.0))

    def total_capacities(self) -> np.ndarray:
        return self._segsum(self.capacity)

    def queue_by_region(self) -> np.ndarray:
        """(R,) backlog gpu-seconds over active servers."""
        return self._segsum(np.where(self.active_mask(), self.queue_s, 0.0))

    def utilizations(self) -> np.ndarray:
        """(R,) mean utilization over active servers (0 when none)."""
        act = self.active_mask()
        out = np.zeros(self.n_regions)
        for r in range(self.n_regions):
            sl = self.region_slice(r)
            m = act[sl]
            if m.any():
                out[r] = float(np.mean(self.util[sl][m]))
        return out

    def power_prices(self) -> np.ndarray:
        return self.power_price

    # -------------------------------------------------------- model caches

    def switch_cost_vec(self, mid: int) -> np.ndarray:
        """(S,) seconds to switch every server to model ``mid``
        (vectorized ``Server.switch_cost_s``)."""
        cost = self.switch_scale * MODEL_SWITCH_S
        warm_hit = (self.warm_models == mid).any(axis=1)
        cost = np.where(warm_hit, self.switch_scale * _WARM_HIT_S, cost)
        return np.where(self.current_model == mid, 0.0, cost)

    def switch_cost_rows(self, g: np.ndarray, mids: np.ndarray) -> np.ndarray:
        """(K,) seconds to switch server ``g[k]`` to model ``mids[k]``."""
        scale = self.switch_scale[g]
        warm_hit = (self.warm_models[g] == mids[:, None]).any(axis=1)
        cost = np.where(warm_hit, scale * _WARM_HIT_S,
                        scale * MODEL_SWITCH_S)
        return np.where(self.current_model[g] == mids, 0.0, cost)

    def switch_cost_matrix(self, mids: np.ndarray,
                           sl: Optional[slice] = None) -> np.ndarray:
        """(N, S) seconds to switch server ``j`` to task ``i``'s model —
        the all-pairs form of :meth:`switch_cost` (optionally restricted
        to a region slice)."""
        scale = (self.switch_scale if sl is None
                 else self.switch_scale[sl])[None, :]
        cur = self.current_model if sl is None else self.current_model[sl]
        warm_hit = self.warm_hit_matrix(mids, sl)
        cost = np.where(warm_hit, scale * _WARM_HIT_S,
                        scale * MODEL_SWITCH_S)
        return np.where(cur[None, :] == mids[:, None], 0.0, cost)

    def switch_cost(self, g: int, mid: int) -> float:
        if self.current_model[g] == mid:
            return 0.0
        scale = float(self.switch_scale[g])
        if mid in self.warm_models[g]:
            return scale * _WARM_HIT_S
        return scale * MODEL_SWITCH_S

    def warm_hit_matrix(self, mids: np.ndarray,
                        sl: Optional[slice] = None) -> np.ndarray:
        """(N, S) bool: model ``mids[i]`` is in server ``j``'s warm cache
        (optionally restricted to a region slice)."""
        wm = self.warm_models if sl is None else self.warm_models[sl]
        return (wm[None, :, :] == mids[:, None, None]).any(axis=2)

    def note_model(self, g: int, mid: int) -> None:
        """MRU update: the current model is also the head of the warm
        list."""
        self.current_model[g] = mid
        row = self.warm_models[g]
        kept = [m for m in row.tolist() if m != mid and m != NO_MODEL]
        new = ([mid] + kept)[:WARM_SLOTS]
        new += [NO_MODEL] * (WARM_SLOTS - len(new))
        self.warm_models[g] = new

    def note_model_rows(self, g: np.ndarray, mids: np.ndarray) -> None:
        """Vectorized :meth:`note_model` over DISTINCT servers ``g``."""
        self.current_model[g] = mids.astype(self.current_model.dtype)
        rows = self.warm_models[g]                        # (K, W)
        keep = (rows != mids[:, None]) & (rows != NO_MODEL)
        # stable kept-first column permutation preserves MRU order
        order = np.argsort(~keep, axis=1, kind="stable")
        kept = np.take_along_axis(rows, order, axis=1)
        n_keep = keep.sum(axis=1)
        out = np.full_like(rows, NO_MODEL)
        out[:, 0] = mids
        for k in range(WARM_SLOTS - 1):
            out[:, k + 1] = np.where(n_keep > k, kept[:, k], NO_MODEL)
        self.warm_models[g] = out

    # -------------------------------------------------------- conversions

    @classmethod
    def from_cluster(cls, cluster: Cluster) -> "ClusterState":
        servers: List[Server] = []
        ptr = [0]
        prices = []
        for reg in cluster.regions:
            servers.extend(reg.servers)
            ptr.append(len(servers))
            prices.append(reg.power_price)
        s = len(servers)
        spec = [GPU_TYPES[sv.gpu] for sv in servers]
        st = cls(
            region_ptr=np.asarray(ptr, np.int64),
            power_price=np.asarray(prices, np.float64),
            gpu_id=np.array([GPU_IDS[sv.gpu] for sv in servers], np.int8),
            tflops=np.array([g[0] for g in spec], np.float64),
            mem_gb=np.array([g[1] for g in spec], np.float64),
            power_w=np.array([g[2] for g in spec], np.float64),
            kind_id=np.array([KIND_IDS[g[3]] for g in spec], np.int8),
            capacity=np.array([sv.capacity for sv in servers], np.float64),
            switch_scale=np.array([g[5] for g in spec], np.float64),
            state=np.array([STATE_CODES[sv.state] for sv in servers],
                           np.int8),
            warm_remaining_s=np.array([sv.warm_remaining_s for sv in servers],
                                      np.float64),
            queue_s=np.array([sv.queue_s for sv in servers], np.float64),
            util=np.array([sv.util for sv in servers], np.float64),
            idle_slots=np.array([sv.idle_slots for sv in servers], np.int64),
            current_model=np.full(s, NO_MODEL, np.int16),
            warm_models=np.full((s, WARM_SLOTS), NO_MODEL, np.int16),
        )
        for g, sv in enumerate(servers):
            st.current_model[g] = model_id(sv.current_model)
            for k, m in enumerate(sv.warm_models[:WARM_SLOTS]):
                st.warm_models[g, k] = model_id(m)
        return st

    def to_cluster(self) -> Cluster:
        """The object view of this state (every dynamic field, the warm
        list without its ``NO_MODEL`` pad)."""
        regions = []
        for r in range(self.n_regions):
            sl = self.region_slice(r)
            servers = []
            for g in range(sl.start, sl.stop):
                cur = int(self.current_model[g])
                servers.append(Server(
                    gpu=GPU_NAMES[int(self.gpu_id[g])],
                    capacity=float(self.capacity[g]),
                    state=STATE_NAMES[int(self.state[g])],
                    warm_remaining_s=float(self.warm_remaining_s[g]),
                    current_model=None if cur == NO_MODEL
                    else MODEL_NAMES[cur],
                    warm_models=[MODEL_NAMES[int(m)]
                                 for m in self.warm_models[g]
                                 if m != NO_MODEL],
                    queue_s=float(self.queue_s[g]),
                    util=float(self.util[g]),
                    idle_slots=int(self.idle_slots[g])))
            regions.append(Region(idx=r, servers=servers,
                                  power_price=float(self.power_price[r])))
        return Cluster(regions)

    def copy(self) -> "ClusterState":
        return ClusterState(**{f.name: getattr(self, f.name).copy()
                               for f in dataclasses.fields(self)})


def make_cluster_state(n_regions: int, seed: int = 0, *,
                       servers_per_region: tuple = (10, 18)) -> ClusterState:
    """Array-native ``make_cluster`` (same RNG draws, so a given seed yields
    the identical fleet as the reference)."""
    return ClusterState.from_cluster(
        make_cluster(n_regions, seed, servers_per_region=servers_per_region))
