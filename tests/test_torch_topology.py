"""The port's named topologies, built without networkx, against the JAX
package's ``make_topology``: the same Watts-Strogatz graph, its edges in
the same order with the same latency draws, and a bitwise-equal latency
matrix for every name and seed."""
import numpy as np
import pytest

from repro.sim import TOPOLOGY_SPECS as REF_SPECS
from repro.sim import make_topology as ref_make_topology
from repro_torch.sim import TOPOLOGY_SPECS, make_topology
from repro_torch.sim.topology import dijkstra_lengths, edges

CASES = [(name, seed) for name in sorted(REF_SPECS) for seed in range(3)]


@pytest.mark.parametrize("name,seed", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_topology_matches_reference_bitwise(name, seed):
    got, want = make_topology(name, seed), ref_make_topology(name, seed)
    assert (got.name, got.n_regions, got.bandwidth_gbps) == \
        (want.name, want.n_regions, want.bandwidth_gbps)
    assert [(u, v, got.graph[u][v]) for u, v in edges(got.graph)] == \
        [(u, v, d["lat"]) for u, v, d in want.graph.edges(data=True)]
    assert got.latency.dtype == want.latency.dtype
    np.testing.assert_array_equal(got.latency, want.latency)
    np.testing.assert_array_equal(got.bandwidth_cost(),
                                  want.bandwidth_cost())


def test_topology_shape_and_unknown_name():
    assert TOPOLOGY_SPECS == REF_SPECS
    topo = make_topology("polska", seed=1)
    lat = topo.latency
    # symmetric up to the order of each path's sum
    np.testing.assert_allclose(lat, lat.T, rtol=1e-12)
    np.testing.assert_array_equal(np.diag(lat), np.ones(12))
    # k = 6: every node keeps degree >= 1 and the graph is connected
    assert len(dijkstra_lengths(topo.graph, 0)) == 12
    with pytest.raises(KeyError, match="unknown topology"):
        make_topology("nsfnet")
