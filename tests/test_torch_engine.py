"""The port's ``Engine(step_backend="torch")`` against the JAX package's
``Engine(step_backend="numpy")``.  The reference engine runs TORTA and
records each slot's decision; the port's engine replays the very same
decisions, so any difference is the engine's.  Summary metrics must be
bitwise equal (rtol 0), failure window and fallbacks included."""
import numpy as np
import pytest

from _torch_port import (Recorder, Replay, port_failures, port_state,
                         port_topology, ref_failures, synth_topology)
from repro.core.torta import TortaScheduler as RefTorta
from repro.sim import Engine as RefEngine
from repro.sim import make_cluster_state
from repro.sim.cluster import throughput_per_slot
from repro.workload import make_source
from repro_torch.api import BatchDecision
from repro_torch.sim.engine import Engine
from repro_torch.workload import StreamingWorkload
from repro_torch.workload.legacy import generate_traffic

SLOTS = 10
FAILURE = [(3, 3, 2)]          # region 3 down for slots 3-4


def _reference(failures):
    """Seeded 15x40 trajectory of the reference numpy engine, recorded."""
    topo = synth_topology(15, seed=1)
    cs = make_cluster_state(15, seed=3, servers_per_region=(40, 41))
    rate = 0.3 * throughput_per_slot(cs) / 15
    src = make_source("diurnal", SLOTS, 15, seed=2, base_rate=rate)
    rec = Recorder(RefTorta(15, seed=0))
    summary = RefEngine(topo, cs.copy(), src, rec, seed=0,
                        failures=ref_failures(failures),
                        step_backend="numpy").run(SLOTS).summary()
    port_src = StreamingWorkload(generate_traffic(SLOTS, 15, 2,
                                                  base_rate=rate), seed=2)
    return topo, cs, port_src, rec.decisions, summary


def _port_run(step_backend, failures):
    topo, cs, src, decisions, want = _reference(failures)
    eng = Engine(port_topology(topo), port_state(cs), src,
                 Replay(decisions, BatchDecision),
                 failures=port_failures(failures),
                 step_backend=step_backend, device="cpu")
    return eng, eng.run(SLOTS).summary(), want


@pytest.mark.parametrize("failures", [[], FAILURE], ids=["steady", "outage"])
def test_torch_step_matches_reference_numpy_engine(failures):
    eng, got, want = _port_run("torch", failures)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    # the slot really went through the torch step and the host fallbacks
    counters = eng.counters.as_dict()
    assert counters["engine.host_sync.close_step"] == SLOTS
    assert counters["engine.fallback.same_server_conflict"] > 0


def test_port_numpy_backend_matches_reference():
    _, got, want = _port_run("numpy", FAILURE)
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k


def test_engine_rejects_unknown_backend_and_non_batch_scheduler():
    topo, cs, src, decisions, _ = _reference([])
    with pytest.raises(ValueError, match="step backend"):
        Engine(port_topology(topo), port_state(cs), src,
               Replay(decisions, BatchDecision), step_backend="jax",
               device="cpu")
    with pytest.raises(TypeError, match="batch-native"):
        Engine(port_topology(topo), port_state(cs), src, object(),
               device="cpu")
