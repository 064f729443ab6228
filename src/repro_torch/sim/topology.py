"""Network topologies (port of ``repro/sim/topology.py``; paper Table I.a,
SNDlib-style [31]).

| name    | nodes | bandwidth | base latency |
|---------|-------|-----------|--------------|
| abilene | 12    | 10 Gbps   | 25 ms        |
| polska  | 12    | 10 Gbps   | 45 ms        |
| gabriel | 25    | 15 Gbps   | 80 ms        |
| cost2   | 32    | 20 Gbps   | 150 ms       |

The graphs are seeded Watts-Strogatz small-worlds with matching node
counts; pairwise latency is the shortest-path sum of edge latencies
scaled to the paper's base latency.  The reference builds them with
networkx; this module rebuilds the same graphs with ``random.Random`` and
a dict-of-dicts adjacency kept in networkx's insertion order, so the
edges, their latency draws and the latency matrix are bitwise the
reference's for every name and seed.  ``graph`` is that adjacency
(``{u: {v: lat}}``); a caller may also build a ``Topology`` from a
latency matrix alone.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

TOPOLOGY_SPECS: Dict[str, tuple] = {
    # name: (nodes, bandwidth_gbps, base_latency_ms, ws_k)
    "abilene": (12, 10, 25, 4),
    "polska": (12, 10, 45, 6),
    "gabriel": (25, 15, 80, 4),
    "cost2": (32, 20, 150, 4),
}

Adjacency = Dict[int, Dict[int, Any]]


@dataclasses.dataclass
class Topology:
    name: str
    n_regions: int
    bandwidth_gbps: float
    latency: np.ndarray          # (R, R) ms, symmetric
    graph: Optional[Any] = None

    def bandwidth_cost(self) -> np.ndarray:
        """Per-task transfer cost proxy (ms) — request+response bytes over
        the shared backbone."""
        return self.latency * 0.1


def _watts_strogatz(n: int, k: int, p: float, rng: random.Random
                    ) -> Adjacency:
    """networkx 3.6's ``watts_strogatz_graph``: the ring lattice, then each
    edge (u, u + j) rewired with probability ``p`` to a uniform node,
    drawing from ``rng`` in its order."""
    nodes = list(range(n))
    adj: Adjacency = {u: {} for u in nodes}
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[0:j]):
            adj[u][v] = adj[v][u] = None
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[0:j]):
            if rng.random() < p:
                w = rng.choice(nodes)
                # no self-loops or multiple edges
                while w == u or w in adj[u]:
                    w = rng.choice(nodes)
                    if len(adj[u]) >= n - 1:
                        break                # skip this rewiring
                else:
                    del adj[u][v], adj[v][u]
                    adj[u][w] = adj[w][u] = None
    return adj


def _connected(adj: Adjacency) -> bool:
    start = next(iter(adj))
    seen = {start}
    todo = [start]
    while todo:
        for v in adj[todo.pop()]:
            if v not in seen:
                seen.add(v)
                todo.append(v)
    return len(seen) == len(adj)


def connected_watts_strogatz(n: int, k: int, p: float, seed: int,
                             tries: int = 100) -> Adjacency:
    """networkx's ``connected_watts_strogatz_graph`` with an int seed: one
    ``random.Random(seed)`` across up to ``tries`` attempts."""
    rng = random.Random(seed)
    for _ in range(tries):
        adj = _watts_strogatz(n, k, p, rng)
        if _connected(adj):
            return adj
    raise RuntimeError("Maximum number of tries exceeded")


def edges(adj: Adjacency) -> Iterator[Tuple[int, int]]:
    """Each undirected edge once, in networkx's ``Graph.edges`` order."""
    seen = set()
    for u, nbrs in adj.items():
        for v in nbrs:
            if v not in seen:
                yield u, v
        seen.add(u)


def dijkstra_lengths(adj: Adjacency, source: int) -> Dict[int, float]:
    """Shortest-path lengths from ``source`` over edge weights ``adj[u][v]``,
    summed outward (``dist[u] + w``) as networkx's Dijkstra sums them."""
    dist: Dict[int, float] = {}
    seen = {source: 0}
    count = itertools.count()
    fringe = [(0, next(count), source)]
    while fringe:
        d, _, v = heapq.heappop(fringe)
        if v in dist:
            continue
        dist[v] = d
        for u, w in adj[v].items():
            vu = d + w
            if u in dist:
                continue
            if u not in seen or vu < seen[u]:
                seen[u] = vu
                heapq.heappush(fringe, (vu, next(count), u))
    return dist


def make_topology(name: str, seed: int = 0) -> Topology:
    if name not in TOPOLOGY_SPECS:
        raise KeyError(f"unknown topology {name!r}: {list(TOPOLOGY_SPECS)}")
    n, bw, base_lat, k = TOPOLOGY_SPECS[name]
    rng = np.random.default_rng(seed)
    adj = connected_watts_strogatz(n, k, 0.3, int(rng.integers(1 << 30)))
    for u, v in list(edges(adj)):
        adj[u][v] = adj[v][u] = float(rng.uniform(0.4, 1.0))
    lat = np.zeros((n, n))
    for i in range(n):
        for j, d in dijkstra_lengths(adj, i).items():
            lat[i, j] = d
    # scale so the mean off-diagonal latency matches the paper's base
    off = lat[~np.eye(n, dtype=bool)]
    lat = lat * (base_lat / max(off.mean(), 1e-9))
    np.fill_diagonal(lat, 1.0)
    return Topology(name, n, bw, lat, adj)
