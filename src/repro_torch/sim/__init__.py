"""Slotted simulator (port of ``repro/sim``)."""
from repro_torch.sim.topology import TOPOLOGY_SPECS, Topology, make_topology
