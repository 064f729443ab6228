"""The port's selective scan (plain version, on the CPU) against the JAX
package: the Pallas ``selective_scan`` kernel in interpret mode and its
jnp oracle, on ``tests/test_kernels.py``'s sweep at its tolerances
(2e-4 float32, 2e-2 bfloat16, times 5), and the last state against
``hs[:, -1]`` of the reference model's associative scan.  The associative
scan combines the steps in another order than a sequential scan, so the
two differ by rounding only: held at 5 x 2e-4, also at S = 512.  On
the CPU the tests also pin the kernel's launch plan (``ops.scan_plan``:
every (b, d, n, s) covered once, shared memory within the card's
limit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan as jax_scan
from repro.kernels.selective_scan import selective_scan_ref as jax_scan_ref
from repro_torch.kernels.selective_scan import ops, selective_scan
from repro_torch.kernels.selective_scan import selective_scan_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
CASES = [                        # test_kernels.py's selective_scan sweep
    (2, 16, 8, 4, 8, 4),
    (1, 33, 16, 8, 16, 16),     # seq padding path
    (3, 8, 32, 16, 4, 8),       # d blocking
]


def _inputs(b, s, d, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((b, s, d)).astype(np.float32) * 0.1,
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, d)).astype(np.float32),
            -rng.random((d, n)).astype(np.float32),
            rng.random(d).astype(np.float32))


@pytest.mark.parametrize("b,s,d,n,ch,db", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_kernel(b, s, d, n, ch, db, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    dt, bm, cm, x, a, dsk = _inputs(b, s, d, n, seed=b * 100 + s + d)
    y, h = selective_scan(*(torch.from_numpy(v).to(tdt)
                            for v in (dt, bm, cm, x)),
                          torch.from_numpy(a), torch.from_numpy(dsk))
    assert y.dtype == tdt and y.shape == (b, s, d)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)
    jargs = [jnp.asarray(v, jdt) for v in (dt, bm, cm, x)] + [
        jnp.asarray(a), jnp.asarray(dsk)]
    pallas = jax_scan(*jargs, chunk=ch, d_block=db, interpret=True)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(pallas, np.float32),
                               atol=5 * tol, rtol=5 * tol)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jax_scan_ref(*jargs), np.float32),
                               atol=5 * tol, rtol=5 * tol)


@pytest.mark.parametrize("b,s,d,n", [(2, 16, 8, 4), (1, 33, 16, 8),
                                     (2, 64, 24, 16), (1, 512, 64, 16)])
def test_last_state_matches_associative_scan(b, s, d, n):
    """The kernel's extra output, the state after the last step, is
    ``hs[:, -1]`` of ``repro/models/mamba.py``'s associative scan."""
    dt, bm, cm, x, a, dsk = _inputs(b, s, d, n, seed=s + n)
    _, h = selective_scan(*(torch.from_numpy(v)
                            for v in (dt, bm, cm, x, a, dsk)))
    abar = jnp.exp(jnp.asarray(dt)[..., None] * jnp.asarray(a))
    bx = jnp.asarray(dt * x)[..., None] * jnp.asarray(bm)[..., None, :]
    _, hs = jax.lax.associative_scan(
        lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1]), (abar, bx),
        axis=1)
    np.testing.assert_allclose(h.numpy(), np.asarray(hs[:, -1]),
                               atol=5 * 2e-4, rtol=5 * 2e-4)


def test_wrapper_rejects_non_cuda_device():
    z = torch.zeros((1, 4, 8), device="meta")
    bm = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        selective_scan(z, bm, bm, z, torch.zeros((8, 4), device="meta"),
                       torch.zeros(8, device="meta"))


# falcon-mamba-7b's and jamba-v0.1's Mamba layers (d_inner 8192, N 16) at
# the admit (S = 1) and the serving prompt (S = 512), B = 4, the ragged
# shape and test_kernels.py's sweep
PLAN_SHAPES = [(1, 1, 8192, 16), (1, 512, 8192, 16), (4, 512, 8192, 16),
               (2, 1000, 1000, 16), (2, 16, 8, 4), (1, 33, 16, 8),
               (3, 8, 32, 16)]
# the knobs chip_smoke.py's sweeps force: steps a stage and stages in
# flight, and (``--scan-lanes``, each on its own build) lanes a channel
SWEEP_KNOBS = ([dict(steps=t, stages=k) for t in (32, 64, 128)
                for k in (2, 3, 4)]
               + [dict(lanes=lanes) for lanes in ops.SWEEP_LANES])


def _assert_covers(plan, b, s, d, n):
    """Every (b, d, n, s) owned by exactly one (block, thread, state,
    step): the grid's batch rows are B, each block walks all S steps, and
    its channel blocks with their threads partition (channel, state)."""
    gx, gb = plan.grid(b, d)
    assert gb == b
    cells = np.zeros((d, n), np.int64)
    for x in range(gx):
        c0, c1 = plan.channel_range(x, d)
        assert c0 < c1
        for t in range(plan.threads):
            c, (n0, n1) = plan.thread(t, n)
            if c0 + c < c1:
                cells[c0 + c, n0:n1] += 1
    assert (cells == 1).all()
    # the steps: stages of plan.steps from 0, the last cut at S
    stages = -(-s // plan.steps)
    steps = np.zeros(s, np.int64)
    for k in range(stages):
        steps[k * plan.steps:min((k + 1) * plan.steps, s)] += 1
    assert (steps == 1).all()


def _assert_runs(plan, n):
    """What the kernel's launcher checks, and the shared-memory limit
    (227 KB a block)."""
    assert plan.threads == ops.THREADS and plan.threads % 32 == 0
    assert plan.lanes in ops.SWEEP_LANES and n % plan.lanes == 0
    assert plan.steps % (2 * ops.group_steps(n // plan.lanes)) == 0
    assert 2 <= plan.stages <= ops.MAX_STAGES
    assert plan.smem <= ops.SMEM_LIMIT == 227 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,n", PLAN_SHAPES)
def test_scan_plan_covers_every_element_once(b, s, d, n, dtype):
    plan = ops.scan_plan(n, dtype)
    _assert_covers(plan, b, s, d, n)
    _assert_runs(plan, n)
    assert plan.smem == ops.smem_bytes(n, dtype, plan.lanes, plan.steps,
                                       plan.stages)


@pytest.mark.parametrize("b,s,d,n", [(1, 512, 8192, 16), (2, 1000, 1000, 16)])
def test_scan_sweep_plans_cover_and_fit(b, s, d, n):
    """Every plan of the on-card sweeps covers the shape and fits shared
    memory."""
    for knobs in SWEEP_KNOBS:
        plan = ops.scan_plan(n, torch.float32, **knobs)
        _assert_covers(plan, b, s, d, n)
        _assert_runs(plan, n)


@pytest.mark.parametrize("b,s,d,n", [
    (1, 512, 8192, 16), (1, 1, 8192, 16), (4, 512, 8192, 16),
    (2, 1000, 1000, 16), (1, 512, 64, 16), (1, 4096, 1024, 16),
    (2, 16, 8, 4)])
def test_scan_plan_defaults(b, s, d, n):
    """The default plan: 4 lanes (N / 4 states a lane), stages of 64
    steps, 3 in flight, 32 channels a block; a block walks all S steps,
    so the grid is the channel blocks times B, whatever the shape."""
    plan = ops.scan_plan(n, torch.float32)
    assert (plan.lanes, plan.steps, plan.stages) == (4, 64, 3)
    assert plan.lanes == ops.LANES and plan.channels == 32
    assert plan.grid(b, d) == (-(-d // 32), b)


def test_scan_plan_lane_builds():
    """The default plan runs the default build; any other lane count
    names a build of its own, made with ``-DSCAN_LANES``."""
    assert ops.lanes_source(ops.LANES) is ops.SOURCE
    names = {ops.lanes_source(lanes).name for lanes in ops.SWEEP_LANES}
    assert len(names) == len(ops.SWEEP_LANES)
    for lanes in ops.SWEEP_LANES:
        if lanes != ops.LANES:
            assert (f"-DSCAN_LANES={lanes}"
                    in ops.lanes_source(lanes).extra_flags)


@pytest.mark.parametrize("knobs,match", [
    (dict(lanes=3), "lanes"), (dict(lanes=16, steps=16), "steps a stage"),
    (dict(steps=12), "steps a stage"), (dict(stages=1), "stages"),
    (dict(stages=6), "stages"), (dict(lanes=32), "lanes"),
    (dict(lanes=1, steps=128, stages=5), "shared memory")])
def test_scan_plan_rejects_what_the_kernel_cannot_run(knobs, match):
    with pytest.raises(ValueError, match=match):
        ops.scan_plan(16, torch.float32, **knobs)
