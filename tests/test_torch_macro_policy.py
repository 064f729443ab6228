"""The slice with the learned macro layer: the port's
``TortaScheduler(micro_backend="fused")`` with a trained-policy and
predictor pair, on ``Engine(step_backend="torch")`` on the CPU, against
the reference's ``TortaScheduler(use_sinkhorn_kernel=True)`` with the
same weights on ``Engine(step_backend="numpy")``, over 8 slots of both
``SLICE_CASES``, with the forecast corrupted by Dirichlet noise
(``prediction_noise=0.3``) from the scheduler's RNG.

The weights are the reference's seeded initial ones, the policy's final
layer scaled up 100x (undoing the init's 0.01) so that A_t is far from
uniform, bridged to the port by ``interop``.  A_t is held per slot within
1e-5 and the logged forecasts within 1e-6 (both float32 networks, each
side with its own matrix products); the decisions and the summaries must
be equal, with the flipped-draw report of ``test_torch_slice.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import (SLICE_CASES, SLICE_SLOTS, Recorder, port_failures,
                         port_topology, ref_failures, slice_case)
from repro.core import policy as r_pol
from repro.core import predictor as r_pred
from repro.core.env import obs_dim
from repro.core.torta import TortaScheduler as RefTorta
from repro.sim import Engine as RefEngine
from repro_torch import interop
from repro_torch.core.torta import TortaScheduler
from repro_torch.sim.engine import Engine
from test_torch_slice import _check_decisions, _check_summary

NOISE = 0.3


class MacroRecorder(Recorder):
    """Also keeps A_t after every slot."""

    def __init__(self, inner):
        super().__init__(inner)
        self.allocations = []

    def schedule_batch(self, obs, batch):
        d = super().schedule_batch(obs, batch)
        self.allocations.append(np.array(self.inner.macro.a_prev))
        return d


def _weights(r: int):
    """The reference's policy and predictor trees (numpy), seeded."""
    policy = jax.tree.map(np.asarray, r_pol.init_policy(
        jax.random.PRNGKey(3), obs_dim(r), r))
    policy["policy"][-1]["w"] = policy["policy"][-1]["w"] * 100
    predictor = jax.tree.map(np.asarray, r_pred.init_predictor(
        jax.random.PRNGKey(4), r))
    return policy, predictor


@pytest.mark.parametrize("case", SLICE_CASES)
def test_slice_with_policy_matches_reference_numpy_path(case):
    c = slice_case(case)
    r = c.topo.n_regions
    policy, predictor = _weights(r)
    pred_params = jax.tree.map(jnp.asarray, predictor)
    ref = MacroRecorder(RefTorta(
        r, seed=0, use_sinkhorn_kernel=True,
        policy_params=jax.tree.map(jnp.asarray, policy),
        predictor=lambda h: np.asarray(r_pred.predict(pred_params,
                                                      jnp.asarray(h))),
        prediction_noise=NOISE))
    want = RefEngine(c.topo, c.cs.copy(), c.workload, ref, seed=0,
                     failures=ref_failures(c.failures),
                     step_backend="numpy").run(SLICE_SLOTS).summary()
    port = MacroRecorder(TortaScheduler(
        r, seed=0, micro_backend="fused",
        policy_params=interop.policy_params_from_arrays(policy, r,
                                                        device="cpu"),
        predictor=interop.predictor_params_from_arrays(predictor, r,
                                                       device="cpu"),
        prediction_noise=NOISE, device="cpu"))
    got = Engine(port_topology(c.topo), c.port_cs, c.port_workload, port,
                 failures=port_failures(c.failures), step_backend="torch",
                 device="cpu").run(SLICE_SLOTS).summary()
    for t, (a_port, a_ref) in enumerate(zip(port.allocations,
                                            ref.allocations)):
        np.testing.assert_allclose(a_port, a_ref, atol=1e-5, rtol=0,
                                   err_msg=f"A_t, slot {t}")
    assert np.abs(ref.allocations[-1] - 1.0 / r).max() > 1e-2  # not uniform
    assert len(port.inner.prediction_log) == SLICE_SLOTS
    np.testing.assert_allclose(np.array(port.inner.prediction_log),
                               np.array(ref.inner.prediction_log),
                               atol=1e-6, rtol=0)
    _check_decisions(port.decisions, [d[0] for d in ref.decisions],
                     [d[1] for d in ref.decisions])
    _check_summary(got, want)
