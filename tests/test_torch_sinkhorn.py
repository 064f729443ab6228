"""The port's Sinkhorn (plain version of the CUDA kernel, on the CPU)
against the JAX package's Pallas kernel in interpret mode and its jnp
oracle ``core/ot.py:sinkhorn``, and the port's macro layer against the
reference's ``use_sinkhorn_kernel=True`` route.

Tolerances are those of ``tests/test_kernels.py``: the plan to 1e-4 and
its marginals to 1e-3, because both sides run 100 float32 iterations
with their own exp/log and summation order.  The kernel takes any R:
``launch_plan`` (team or cluster, warps, cluster size, span, where
-cost/reg lives, shared bytes) is pinned here, R = 64 and 200 (the fused
route's largest fleet) are held to both JAX sides, and a float32
emulation of the kernel's merge order (``_emulate``) is held to both at
every shape, since the kernel itself runs only on the card."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


@functools.cache
def _pallas(b, r):
    mu, nu, c = _problem(b, r)
    return np.asarray(sinkhorn_batched(*(jnp.asarray(x) for x in (mu, nu, c)),
                                       interpret=True))


@pytest.mark.parametrize("b,r", SHAPES)
def test_plain_sinkhorn_matches_pallas_interpret(b, r):
    mu, nu, c = _problem(b, r)
    want = _pallas(b, r)
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
        p_port = port.predict_next(demand, np.zeros(r), np.zeros(r))
        np.testing.assert_array_equal(p_port, p_ref)
        a_ref = ref.allocate(demand=demand, predicted=p_ref, capacity=cap,
                             power_cost=power, latency=lat,
                             queue=np.zeros(r), utilization=np.zeros(r),
                             q_max=1.0)
        a_port = port.allocate(demand=demand, predicted=p_port, capacity=cap,
                               power_cost=power, latency=lat,
                               queue=np.zeros(r), utilization=np.zeros(r),
                               q_max=1.0)
        np.testing.assert_allclose(a_port, a_ref, atol=1e-6, rtol=0,
                                   err_msg=f"call {step}")
    assert sinkhorn_plan.launches == launches   # CPU: plain version only


def test_sinkhorn_wrapper_runs_plain_version_on_cpu_for_any_r():
    """On the CPU any R runs the plain version (the kernel, too, takes
    any R)."""
    mu, nu, c = _problem(1, 40)
    plan = sinkhorn_plan(*(torch.from_numpy(x) for x in (mu, nu, c)))
    assert plan.shape == (1, 40, 40) and torch.isfinite(plan).all()


R_CASES = [1, 25, 32, 33, 64, 200, 238, 239, 300, 1000]


def _shared_bytes(plan, r):
    """The kernel's shared-memory layout, buffer by buffer: a team's
    partials [2][warps][32] float2 and its warps' copies of X_f and X_g
    [2][warps][32] float; a cluster block's two mbarriers (16 bytes), X_f
    and X_g [2][R], log mu and log nu [2][span], and the row and column
    slabs [2][span][R] when they live in shared memory."""
    if plan.form == "team":
        warps = plan.threads // 32
        return 2 * warps * 32 * 8 + 2 * warps * 32 * 4
    return 16 + 4 * 2 * r + 4 * 2 * plan.span + (
        4 * 2 * plan.span * r if plan.slab == "shared" else 0)


@pytest.mark.parametrize("r", R_CASES)
def test_launch_plan_any_r(r):
    """A team at R = 1: one warp.  Else a cluster of at most 16 blocks
    each owning ``span`` = min(max(ceil(R / 16), 8), R) rows (every block
    some), a warp a row up to 32 warps, -cost/reg in registers to R =
    256, in shared slabs while they fit a block's 232,448 bytes, else in
    a device workspace; the shared bytes the kernel's layout gives."""
    plan = ops.launch_plan(1, r)
    n = -(-r // plan.span)
    assert n * plan.span >= r > (n - 1) * plan.span
    if r == 1:
        assert plan.form == "team" and plan.cluster == 1
        assert plan.span == 1 and plan.threads == 32 * n == 32
        assert plan.slab == "registers" and plan.workspace == 0
    else:
        assert plan.form == "cluster" and plan.cluster == n <= 16
        assert plan.span == min(max(-(-r // 16), 8), r)
        assert plan.threads == 32 * min(plan.span, 32)
        want = ("registers" if r <= 256 else
                "shared" if 8 * plan.span * r + 8 * r + 8 * plan.span + 16
                <= ops.SMEM_LIMIT else "device")
        assert plan.slab == want
        assert plan.workspace == (2 * plan.cluster * plan.span * r
                                  if want == "device" else 0)
    assert plan.smem == _shared_bytes(plan, r) <= ops.SMEM_LIMIT


@pytest.mark.parametrize("b", [2, 8, 64, 160])
@pytest.mark.parametrize("r", [25, 200, 1000])
def test_launch_plan_batched(b, r):
    """One team or one cluster a problem: B changes only the device
    workspace, which holds every block's slabs, unless at R <= 32 the B
    clusters' blocks would outnumber the card's SMs: then a team of 4
    warps a problem (at B = 64, R = 25, and at the OT plans of 160
    training slots, B = 160)."""
    one, plan = ops.launch_plan(1, r), ops.launch_plan(b, r)
    if r <= 32 and b * one.cluster > ops.CARD_SMS:
        assert plan == ops.launch_plan(1, r, warps=4)
        assert plan.form == "team" and plan.threads == 128
        return
    assert plan._replace(workspace=0) == one._replace(workspace=0)
    assert plan.workspace == b * one.workspace


@pytest.mark.parametrize("b,r,form", [
    (1, 1, "team"), (64, 1, "team"), (1, 2, "cluster"), (64, 8, "cluster"),
    (64, 16, "cluster"), (64, 20, "team"), (33, 25, "cluster"),
    (34, 25, "team"), (8, 32, "cluster"), (64, 32, "team"),
    (64, 33, "cluster"), (160, 25, "team")])
def test_launch_plan_form_by_blocks_and_sms(b, r, form):
    """The team where the card measured it faster than the cluster: at R
    = 1, and at R <= 32 once the B problems' blocks (C = ceil(R / 8)
    each) outnumber the 132 SMs; past R = 32 always the cluster."""
    plan = ops.launch_plan(b, r)
    assert plan.form == form
    if form == "cluster" and r <= 32:
        assert b * plan.cluster <= ops.CARD_SMS


@pytest.mark.parametrize("r,cluster,span,threads,slab", [
    (33, 5, 8, 256, "registers"),
    (64, 8, 8, 256, "registers"),
    (200, 16, 13, 416, "registers"),
    (300, 16, 19, 608, "shared"),
    (1000, 16, 63, 1024, "device")])
def test_launch_plan_cluster_size(r, cluster, span, threads, slab):
    plan = ops.launch_plan(1, r)
    assert (plan.cluster, plan.span, plan.threads, plan.slab) == (
        cluster, span, threads, slab)


@pytest.mark.parametrize("size", ops.CLUSTER_SIZES)
@pytest.mark.parametrize("r", [25, 64, 200, 300])
def test_launch_plan_forced_cluster_shared_bytes(r, size):
    """A forced cluster size (the on-card sweep) at any R: ceil(R / span)
    blocks of span = ceil(R / size), and the shared bytes of its form
    and slab."""
    plan = ops.launch_plan(1, r, cluster=size)
    assert plan.form == "cluster"
    assert plan.span == -(-r // min(size, r))
    assert plan.cluster == -(-r // plan.span) <= size
    assert plan.smem == _shared_bytes(plan, r) <= ops.SMEM_LIMIT
    if plan.slab == "registers":
        assert plan.span <= 32 and r <= 32 * ops.REG_TERMS


@pytest.mark.parametrize("warps", ops.TEAM_SIZES)
@pytest.mark.parametrize("r", [1, 5, 12, 25, 32])
def test_launch_plan_team_sizes(r, warps):
    """A team of at most ``warps`` warps: chunks of ceil(R / warps), every
    warp some; each warp's chunk, padded to the kernel's power-of-two
    instance (8, 16 or 32 terms), stays inside its 32-entry copy of X."""
    plan = ops.launch_plan(1, r, warps=warps)
    n = plan.threads // 32
    assert plan.form == "team" and plan.span == -(-r // warps)
    assert n == -(-r // plan.span) <= warps
    padded = 8 if plan.span <= 8 else 16 if plan.span <= 16 else 32
    assert (n - 1) * plan.span + padded <= 32
    assert plan.smem == _shared_bytes(plan, r)


def test_launch_plan_rejects_unknown_cluster_and_huge_r():
    with pytest.raises(ValueError, match="cluster 3"):
        ops.launch_plan(1, 200, cluster=3)
    with pytest.raises(ValueError, match="team of 3"):
        ops.launch_plan(1, 25, warps=3)
    with pytest.raises(ValueError, match="overflow"):
        ops.launch_plan(1, 30000)


def _tree_sum(v):
    """Sum a list as the kernel's ``tree_sum``: padded with zeros to a
    power of two, then the sum of each half, added."""
    n = 1 << (len(v) - 1).bit_length()
    v = v + [torch.zeros_like(v[0])] * (n - len(v))
    return v[0] if n == 1 else (_tree_sum(v[:n // 2])
                                + _tree_sum(v[n // 2:]))


def _team_half(t, lm, plan):
    """A team half-step: warp q's partial (max, sum of exp(t - max)) over
    its ``span`` terms; with more than one warp the partials merge: the
    max of the maxes, each sum rescaled by exp(m_q - m), added as a
    tree."""
    parts = [(tq.amax(-1), tq) for tq in t.split(plan.span, dim=-1)]
    parts = [(m, torch.exp(tq - m[..., None]).sum(-1)) for m, tq in parts]
    if len(parts) == 1:
        m, s = parts[0]
        return lm - (m + torch.log(s))
    m = torch.stack([p[0] for p in parts]).amax(0)
    s = _tree_sum([sq * torch.exp(mq - m) for mq, sq in parts])
    return lm - (m + torch.log(s))


def _cluster_half(t, lm, plan):
    """A cluster half-step: lane l folds the terms x = l, l + 32, ...
    after the warp's max; the lanes' sums meet in fixed point (each
    rounded to a multiple of 2^-k, k = 26 - ceil(log2 n) for n terms a
    lane, added exactly as integers)."""
    b, n, r = t.shape
    t = F.pad(t, (0, -r % 32), value=-np.inf).reshape(b, n, -1, 32)
    m = t.amax((-1, -2))
    s = torch.zeros((b, n, 32))
    for j in range(t.shape[2]):
        s = s + torch.exp(t[:, :, j, :] - m[..., None])
    terms = t.shape[2]
    if plan.slab == "registers":                 # the instance's terms
        terms = 1 << (terms - 1).bit_length()
    k = 26 - (terms - 1).bit_length()
    q = torch.round(s.double() * 2.0 ** k).sum(-1)
    return lm - (m + torch.log((q * 2.0 ** -k).float()))


def _emulate(mu, nu, cost, plan, *, reg=0.05, n_iters=100):
    """The kernel's arithmetic in float32 on the CPU: X = f/reg carried
    between half-steps (no division a term), each half-step reduced in
    the plan's merge order, the plan from f = reg X."""
    mk = -cost / reg
    lmu = torch.log(torch.clamp(mu, min=1e-30))
    lnu = torch.log(torch.clamp(nu, min=1e-30))
    half = _team_half if plan.form == "team" else _cluster_half
    xf, xg = torch.zeros_like(mu), torch.zeros_like(nu)
    for _ in range(n_iters):
        xf = half(mk + xg[:, None, :], lmu, plan)
        xg = half(mk.transpose(1, 2) + xf[:, None, :], lnu, plan)
    return torch.exp(mk + (reg * xf[:, :, None] + reg * xg[:, None, :])
                     / reg)


PLANS = [{}, {"warps": 1}, {"warps": 4}, {"cluster": 16}]
PLAN_IDS = ["default", "warps1", "warps4", "cluster16"]


@pytest.mark.parametrize("kw", PLANS, ids=PLAN_IDS)
@pytest.mark.parametrize("b,r", SHAPES)
def test_kernel_merge_order_matches_pallas_interpret(b, r, kw):
    """The emulation of the kernel's merge order (the plan's form, a team
    of one or four warps, or a cluster of 16 blocks forced) against the
    Pallas kernel."""
    mu, nu, c = _problem(b, r)
    plan = ops.launch_plan(b, r, **kw)
    got = _emulate(*(torch.from_numpy(x) for x in (mu, nu, c)), plan).numpy()
    np.testing.assert_allclose(got, _pallas(b, r), atol=1e-4)
    np.testing.assert_allclose(got.sum(-1), mu, atol=1e-3)
    np.testing.assert_allclose(got.sum(-2), nu, atol=1e-3)


@pytest.mark.parametrize("kw", PLANS, ids=PLAN_IDS)
@pytest.mark.parametrize("b,r", SHAPES)
def test_kernel_merge_order_matches_plain(b, r, kw):
    mu, nu, c = (torch.from_numpy(x) for x in _problem(b, r))
    got = _emulate(mu, nu, c, ops.launch_plan(b, r, **kw))
    want = sinkhorn_ref(mu, nu, c)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.sum(-1), mu, atol=1e-3, rtol=0)
    torch.testing.assert_close(got.sum(-2), nu, atol=1e-3, rtol=0)


def test_launch_plan_rejects_empty_problem():
    with pytest.raises(ValueError, match="R >= 1"):
        ops.launch_plan(1, 0)


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
        p_port = port.predict_next(demand, np.zeros(r), np.zeros(r))
        a_ref = ref.allocate(demand=demand, predicted=p_ref, capacity=cap,
                             power_cost=power, latency=lat,
                             queue=np.zeros(r), utilization=np.zeros(r),
                             q_max=1.0)
        a_port = port.allocate(demand=demand, predicted=p_port, capacity=cap,
                               power_cost=power, latency=lat,
                               queue=np.zeros(r), utilization=np.zeros(r),
                               q_max=1.0)
        assert a_port.shape == (r, r)
        np.testing.assert_allclose(a_port, a_ref, atol=1e-6, rtol=0,
                                   err_msg=f"call {step}")
