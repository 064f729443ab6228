"""The port's Sinkhorn (plain version of the CUDA kernel, on the CPU)
against the JAX package's Pallas kernel in interpret mode and its jnp
oracle ``core/ot.py:sinkhorn``, and the port's macro layer against the
reference's ``use_sinkhorn_kernel=True`` route.

Tolerances are those of ``tests/test_kernels.py``: the plan to 1e-4 and
its marginals to 1e-3, because both sides run 100 float32 iterations
with their own exp/log and summation order.  The kernel takes any R:
``launch_plan`` (threads, shared bytes, where the tile lives) is pinned
here, and R = 64 and 200 (the fused route's largest fleet) are held to
both JAX sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.macro import MacroAllocator as RefMacro
from repro.core.ot import sinkhorn as jnp_sinkhorn
from repro.kernels.sinkhorn import sinkhorn_batched
from repro_torch.core.macro import MacroAllocator
from repro_torch.kernels.sinkhorn import ops, sinkhorn_plan, sinkhorn_ref

SHAPES = [(1, 12), (5, 12), (9, 25), (3, 32), (1, 64), (1, 200)]


def _problem(b, r):
    rng = np.random.default_rng(b * 100 + r)
    mu = rng.random((b, r)) + 0.05
    mu /= mu.sum(1, keepdims=True)
    nu = rng.random((b, r)) + 0.05
    nu /= nu.sum(1, keepdims=True)
    c = rng.random((b, r, r))
    return [x.astype(np.float32) for x in (mu, nu, c)]


@pytest.mark.parametrize("b,r", SHAPES)
def test_plain_sinkhorn_matches_pallas_interpret(b, r):
    mu, nu, c = _problem(b, r)
    want = np.asarray(sinkhorn_batched(*(jnp.asarray(x) for x in (mu, nu, c)),
                                       interpret=True))
    got = sinkhorn_plan(*(torch.from_numpy(x) for x in (mu, nu, c))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got.sum(-1), mu, atol=1e-3)
    np.testing.assert_allclose(got.sum(-2), nu, atol=1e-3)


@pytest.mark.parametrize("b,r", SHAPES)
def test_plain_sinkhorn_matches_jnp_oracle(b, r):
    mu, nu, c = _problem(b, r)
    want = np.asarray(jnp_sinkhorn(*(jnp.asarray(x) for x in (mu, nu, c))))
    got = sinkhorn_ref(*(torch.from_numpy(x) for x in (mu, nu, c))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_macro_allocator_matches_reference_kernel_route():
    """Ten calls with the same inputs: the smoothed A_t stays within 1e-6
    of the reference's (the float32 plans differ in the last bits only).
    The forecast is the same EMA on both sides."""
    r = 12
    rng = np.random.default_rng(5)
    ref = RefMacro(r, use_sinkhorn_kernel=True)
    port = MacroAllocator(r, device="cpu")
    launches = sinkhorn_plan.launches
    power = rng.uniform(0.06, 0.3, r)
    lat = rng.uniform(10, 80, (r, r))
    for step in range(10):
        demand = rng.poisson(30.0, r).astype(np.float64)
        cap = rng.uniform(5.0, 60.0, r)
        if step == 6:
            cap[:3] = 0.05                       # supply shock: snap to P*
        p_ref = ref.predict_next(demand, np.zeros(r), np.zeros(r))
        p_port = port.predict_next(demand)
        np.testing.assert_array_equal(p_port, p_ref)
        a_ref = ref.allocate(demand=demand, predicted=p_ref, capacity=cap,
                             power_cost=power, latency=lat,
                             queue=np.zeros(r), utilization=np.zeros(r),
                             q_max=1.0)
        a_port = port.allocate(demand=demand, predicted=p_port, capacity=cap,
                               power_cost=power, latency=lat)
        np.testing.assert_allclose(a_port, a_ref, atol=1e-6, rtol=0,
                                   err_msg=f"call {step}")
    assert sinkhorn_plan.launches == launches   # CPU: plain version only


def test_sinkhorn_wrapper_runs_plain_version_on_cpu_for_any_r():
    """On the CPU any R runs the plain version (the kernel, too, takes
    any R)."""
    mu, nu, c = _problem(1, 40)
    plan = sinkhorn_plan(*(torch.from_numpy(x) for x in (mu, nu, c)))
    assert plan.shape == (1, 40, 40) and torch.isfinite(plan).all()


@pytest.mark.parametrize("r", [1, 25, 32, 33, 64, 200, 238, 239, 300, 1000])
def test_launch_plan_any_r(r):
    """A warp a row up to R = 32, then 32 warps; the padded -cost/reg tile
    in shared memory while it fits a block's 232,448 bytes (R <= 238),
    else read from device memory; the shared bytes the kernel's formula
    gives."""
    plan = ops.launch_plan(r)
    assert plan.threads == 32 * min(r, 32) <= 1024
    assert plan.shared == (r <= 238)
    ld = ops.tile_ld(r)
    assert ld % 2 == 1 and r + 1 <= ld <= r + 2
    assert plan.smem == 4 * (4 * r + (r * ld if plan.shared else 0))
    assert plan.smem <= ops.SMEM_LIMIT


def test_launch_plan_rejects_empty_problem():
    with pytest.raises(ValueError, match="R >= 1"):
        ops.launch_plan(0)


def test_macro_allocator_matches_reference_beyond_old_cap():
    """R = 40, past the 32 regions the kernel once took: the port's macro
    layer against the reference's ``use_sinkhorn_kernel=True`` route
    (the Pallas kernel, run as the reference runs it on the CPU), the
    smoothed A_t within 1e-6 over five calls."""
    r = 40
    rng = np.random.default_rng(6)
    ref = RefMacro(r, use_sinkhorn_kernel=True)
    port = MacroAllocator(r, device="cpu")
    power = rng.uniform(0.06, 0.3, r)
    lat = rng.uniform(10, 80, (r, r))
    for step in range(5):
        demand = rng.poisson(30.0, r).astype(np.float64)
        cap = rng.uniform(5.0, 60.0, r)
        p_ref = ref.predict_next(demand, np.zeros(r), np.zeros(r))
        p_port = port.predict_next(demand)
        a_ref = ref.allocate(demand=demand, predicted=p_ref, capacity=cap,
                             power_cost=power, latency=lat,
                             queue=np.zeros(r), utilization=np.zeros(r),
                             q_max=1.0)
        a_port = port.allocate(demand=demand, predicted=p_port, capacity=cap,
                               power_cost=power, latency=lat)
        assert a_port.shape == (r, r)
        np.testing.assert_allclose(a_port, a_ref, atol=1e-6, rtol=0,
                                   err_msg=f"call {step}")
