"""Heterogeneous GPU clusters (paper Table I.b + Fig 3 cost tables).

Port of ``repro/sim/cluster.py``: the same constants, the same seeded
``make_cluster`` draws (a given seed yields the identical fleet), the
task/throughput helpers, and the object model with its methods:
``make_cluster``'s output, ``ClusterState.to_cluster``'s, and what the
frozen per-object oracle (``sim/reference.py``) and the legacy
scheduler path read and mutate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# name: (tflops_bf16, mem_gb, power_watts, kind, capacity_range tasks/slot,
#        switch_scale vs V100)
GPU_TYPES: Dict[str, tuple] = {
    "H100": (989.0, 80, 700, "compute", (32.0, 46.0), 0.45),
    "A100": (312.0, 80, 400, "compute", (10.0, 15.0), 0.70),
    "4090": (165.0, 24, 450, "lightweight", (5.5, 8.0), 0.55),
    "V100": (112.0, 32, 250, "memory", (3.5, 5.5), 1.00),
    "T4": (65.0, 16, 70, "lightweight", (2.0, 3.2), 1.20),
}

# Fig 3.a stage costs on a V100, seconds
SWITCH_STAGES_S = {"unload": 3.5, "cleanup": 2.1, "load": 6.8,
                   "init": 14.2, "reconfig": 3.4}
MIGRATION_STAGES_S = {"serialize": 15.2, "deserialize": 4.8,
                      "mem_load": 5.6, "warmup": 5.1}
MODEL_SWITCH_S = sum(SWITCH_STAGES_S.values())      # ~30.0
MIGRATION_S = sum(MIGRATION_STAGES_S.values())      # ~30.7
COLD_START_S = 90.0          # cold -> ready (paper: 1-3 min)
SWITCH_POWER_FRAC = 0.95     # peak draw fraction during transitions (Fig 3.c)

# served model catalogue: (active params (B), mem footprint GB, kind)
MODEL_CATALOG: Dict[str, tuple] = {
    "tinyllama-1.1b": (1.1, 3, "lightweight"),
    "qwen2.5-3b": (3.4, 8, "lightweight"),
    "llama3-8b": (8.0, 18, "compute"),
    "mixtral-8x7b": (12.9, 60, "memory"),
    "falcon-mamba-7b": (7.3, 16, "compute"),
    "whisper-small": (0.3, 2, "lightweight"),
}


@dataclasses.dataclass
class Server:
    gpu: str
    capacity: float                 # tasks / slot at full utilisation
    state: str = "active"           # off | warming | active
    warm_remaining_s: float = 0.0
    current_model: Optional[str] = None
    warm_models: List[str] = dataclasses.field(default_factory=list)
    queue_s: float = 0.0            # backlog in gpu-seconds
    util: float = 0.0
    idle_slots: int = 0

    @property
    def tflops(self) -> float:
        return GPU_TYPES[self.gpu][0]

    @property
    def mem_gb(self) -> float:
        return GPU_TYPES[self.gpu][1]

    @property
    def power_w(self) -> float:
        return GPU_TYPES[self.gpu][2]

    @property
    def kind(self) -> str:
        return GPU_TYPES[self.gpu][3]

    def switch_cost_s(self, model: str) -> float:
        scale = GPU_TYPES[self.gpu][5]
        if self.current_model == model:
            return 0.0
        if model in self.warm_models:   # warm cache hit (paper §II warm-up)
            return 0.5 * scale * (SWITCH_STAGES_S["load"]
                                  + SWITCH_STAGES_S["reconfig"])
        return scale * MODEL_SWITCH_S

    def note_model(self, model: str) -> None:
        """MRU update: the model becomes current and the head of the
        3-entry warm list."""
        self.current_model = model
        if model in self.warm_models:
            self.warm_models.remove(model)
        self.warm_models.insert(0, model)
        del self.warm_models[3:]


@dataclasses.dataclass
class Region:
    idx: int
    servers: List[Server]
    power_price: float              # $/kWh

    @property
    def capacity(self) -> float:
        return sum(s.capacity for s in self.servers if s.state == "active")

    @property
    def total_capacity(self) -> float:
        return sum(s.capacity for s in self.servers)

    def active_servers(self) -> List[Server]:
        return [s for s in self.servers if s.state == "active"]


@dataclasses.dataclass
class Cluster:
    regions: List[Region]

    @property
    def n_regions(self) -> int:
        return len(self.regions)

    def capacities(self) -> np.ndarray:
        return np.array([r.capacity for r in self.regions])

    def power_prices(self) -> np.ndarray:
        return np.array([r.power_price for r in self.regions])

    def utilizations(self) -> np.ndarray:
        out = []
        for r in self.regions:
            act = r.active_servers()
            out.append(np.mean([s.util for s in act]) if act else 0.0)
        return np.array(out)


def make_cluster(n_regions: int, seed: int = 0, *,
                 servers_per_region: tuple = (10, 18)) -> Cluster:
    """Heterogeneous cluster: mixed GPU types, regionally varying electricity
    prices (same RNG draw order as the reference)."""
    rng = np.random.default_rng(seed)
    names = list(GPU_TYPES)
    regions = []
    for r in range(n_regions):
        n_srv = int(rng.integers(*servers_per_region))
        # regional hardware mix: some regions are H100-rich, some legacy
        mix = rng.dirichlet(np.ones(len(names)) * 1.5)
        servers = []
        for _ in range(n_srv):
            gpu = names[int(rng.choice(len(names), p=mix))]
            lo, hi = GPU_TYPES[gpu][4]
            servers.append(Server(gpu=gpu,
                                  capacity=float(rng.uniform(lo, hi))))
        regions.append(Region(idx=r, servers=servers,
                              power_price=float(rng.uniform(0.06, 0.30))))
    return Cluster(regions)


def task_profile(model: str) -> tuple:
    """(work gpu-seconds on a V100-class chip, mem GB, kind)."""
    act_b, mem, kind = MODEL_CATALOG[model]
    work = max(2.0, 25.0 * act_b / 8.0)
    return work, mem, kind


def throughput_per_slot(cluster, slot_s: float = 45.0,
                        ref_work_s: float = 10.0) -> float:
    """Total cluster throughput in tasks/slot (speed-adjusted); accepts the
    object ``Cluster`` or a ``ClusterState``."""
    tflops = getattr(cluster, "tflops", None)
    if tflops is None:
        tflops = np.array([s.tflops for reg in cluster.regions
                           for s in reg.servers])
    return float(np.sum(slot_s * (np.asarray(tflops) / 112.0) / ref_work_s))
