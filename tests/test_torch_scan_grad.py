"""The gradient of the port's selective scan on the CPU: the plain
backward (``selective_scan_bwd_ref``, an explicit reverse recurrence)
against autograd of the plain forward and against ``jax.vjp`` of the JAX
package's jnp oracle; the ``SelectiveScan`` autograd path against
autograd of the plain version; the boundary states the forward returns
given ``states``; the backward's launch plan (``ops.bwd_plan``) and its
operand checks; and ``mamba_forward``'s routing under grad.

Tolerances, and why:

- against autograd of the plain forward in float64: 1e-10 of each
  gradient's largest entry (the same sums in another order; measured
  under 1e-15);
- against ``jax.vjp`` of the JAX oracle: 1e-5 of each gradient's largest
  entry.  The oracle casts to float32 even under 64-bit mode, so its side
  is float32 and the port's float64: what is left is float32 rounding
  over S steps (measured under 3e-7);
- ``SelectiveScan`` against autograd of the plain version: 1e-10 in
  float64, 1e-5 of the largest entry in float32 (two float32 recurrences
  summed in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ref import \
    selective_scan_ref as jax_scan_ref
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.selective_scan import (SelectiveScan, ops,
                                                selective_scan,
                                                selective_scan_bwd,
                                                selective_scan_bwd_ref,
                                                selective_scan_grad,
                                                selective_scan_ref)
from repro_torch.kernels.selective_scan import autograd as scan_autograd
from repro_torch.models import Model
from repro_torch.models import mamba

# test_kernels.py's sweep, S not a multiple of the chunk (64), S = 1
SHAPES = [(2, 16, 8, 4), (1, 33, 16, 8), (3, 8, 32, 16), (2, 150, 8, 8),
          (1, 1, 8, 16)]
NAMES = ("dt", "bm", "cm", "x", "a", "d_skip")


def _inputs(b, s, d, n, seed, dtype=np.float64, dh_last=False):
    """Seeded (dt, Bm, Cm, x, A, Dskip), the cotangent dy and, if asked,
    dh_last, as numpy arrays."""
    rng = np.random.default_rng(seed)
    ops_ = [rng.random((b, s, d)) * 0.1, rng.standard_normal((b, s, n)),
            rng.standard_normal((b, s, n)), rng.standard_normal((b, s, d)),
            -rng.random((d, n)), rng.random(d), rng.standard_normal((b, s, d))]
    dh = rng.standard_normal((b, d, n)) if dh_last else None
    return [v.astype(dtype) for v in ops_], \
        None if dh is None else dh.astype(dtype)


def _torch(arrays):
    return [torch.from_numpy(v) for v in arrays]


def _autograd(operands, dy, dh_last, forward=selective_scan_ref):
    leaves = [t.detach().clone().requires_grad_(True) for t in operands]
    y, h = forward(*leaves)
    outs, cots = [y], [dy]
    if dh_last is not None:
        outs.append(h)
        cots.append(dh_last)
    return torch.autograd.grad(outs, leaves, cots)


def _assert_grads(got, want, tol, what):
    for name, g, w in zip(NAMES, got, want):
        w = torch.as_tensor(np.array(w)).double()
        assert tuple(g.shape) == tuple(w.shape), name
        scale = float(w.abs().max())
        err = float((g.double() - w).abs().max())
        assert err <= tol * scale, f"{what} {name}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("dh_last", [False, True])
@pytest.mark.parametrize("b,s,d,n", SHAPES)
def test_bwd_ref_matches_autograd_of_the_plain_forward(b, s, d, n, dh_last):
    arrays, dh = _inputs(b, s, d, n, seed=s + d + n, dh_last=dh_last)
    operands, dy = _torch(arrays[:6]), torch.from_numpy(arrays[6])
    dh = None if dh is None else torch.from_numpy(dh)
    got = selective_scan_bwd_ref(*operands, dy, dh)
    assert all(g.dtype == torch.float64 for g in got)
    _assert_grads(got, _autograd(operands, dy, dh), 1e-10, "float64")


@pytest.mark.parametrize("b,s,d,n", SHAPES[:3] + [(2, 100, 64, 16)])
def test_bwd_ref_matches_jax_vjp_of_the_oracle(b, s, d, n):
    arrays, _ = _inputs(b, s, d, n, seed=7 * s + n)
    operands, dy = arrays[:6], arrays[6]
    _, vjp = jax.vjp(jax_scan_ref, *(jnp.asarray(v, jnp.float32)
                                     for v in operands))
    want = vjp(jnp.asarray(dy, jnp.float32))
    got = selective_scan_bwd_ref(*_torch(operands), torch.from_numpy(dy))
    _assert_grads(got, want, 1e-5, "jax.vjp")


@pytest.mark.parametrize("dh_last", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("b,s,d,n", [(2, 16, 8, 4), (1, 70, 16, 8)])
def test_function_matches_autograd_of_the_plain_version(b, s, d, n, dtype,
                                                        tol, dh_last):
    arrays, dh = _inputs(b, s, d, n, seed=s + 3, dh_last=dh_last)
    operands = [t.to(dtype) for t in _torch(arrays[:6])]
    dy = torch.from_numpy(arrays[6]).to(dtype)
    dh = None if dh is None else torch.from_numpy(dh).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in operands]
    y, h = selective_scan_grad(*leaves)
    want_y, want_h = selective_scan_ref(*operands)
    assert torch.equal(y.detach(), want_y) and torch.equal(h.detach(), want_h)
    outs, cots = ([y], [dy]) if dh is None else ([y, h], [dy, dh])
    got = torch.autograd.grad(outs, leaves, cots)
    assert all(g.dtype == dtype for g in got)
    _assert_grads(got, _autograd(operands, dy, dh), tol, str(dtype))


def test_function_takes_its_kernels_from_ops(monkeypatch):
    """The Function looks its forward and backward up on ``ops`` at each
    call, the forward asked for its boundary states (``chip_smoke.py``
    wraps them there to record and count)."""
    seen = []
    fwd, bwd = ops.selective_scan, ops.selective_scan_bwd

    def rec_fwd(*args, **kw):
        seen.append(("fwd", kw))
        return fwd(*args, **kw)

    def rec_bwd(*args, **kw):
        seen.append(("bwd", kw["h_chunks"].shape))
        return bwd(*args, **kw)
    monkeypatch.setattr(ops, "selective_scan", rec_fwd)
    monkeypatch.setattr(ops, "selective_scan_bwd", rec_bwd)
    arrays, _ = _inputs(1, 130, 8, 4, seed=1, dtype=np.float32)
    leaves = [t.requires_grad_(True) for t in _torch(arrays[:6])]
    y, _ = SelectiveScan.apply(*leaves)
    y.sum().backward()
    assert seen == [("fwd", {"states": True}),
                    ("bwd", (1, -(-130 // ops.STEPS), 8, 4))]
    assert all(t.grad is not None for t in leaves)


@pytest.mark.parametrize("b,s,d,n", [(2, 150, 8, 8), (1, 64, 16, 4)])
def test_forward_boundary_states(b, s, d, n):
    """Given ``states`` the forward also returns the state each run of
    ``ops.STEPS`` (16) steps starts from (zeros first), the backward's
    chunks; y and the last state are the same bits as without it."""
    chunk = ops.STEPS
    assert chunk == 16
    arrays, _ = _inputs(b, s, d, n, seed=2, dtype=np.float32)
    operands = _torch(arrays[:6])
    y, h = selective_scan(*operands)
    y2, h2, starts = selective_scan(*operands, states=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert starts.shape == (b, -(-s // chunk), d, n)
    assert starts.dtype == torch.float32 and not starts[:, 0].any()
    for k in range(1, starts.shape[1]):
        _, want = selective_scan_ref(*(t[:, :k * chunk] if t.dim() == 3
                                       else t for t in operands))
        assert torch.equal(starts[:, k], want), k


# the backward at falcon-mamba-7b's train shape, its serving prompt and
# admit, jamba's prompt, the ragged shape, the reduced configs (N = 8)
# and test_kernels.py's sweep
BWD_PLAN_SHAPES = [(4, 512, 8192, 16), (1, 512, 8192, 16), (1, 1, 8192, 16),
                   (2, 1000, 1000, 16), (2, 16, 512, 8), (2, 130, 512, 8),
                   (2, 16, 8, 4), (1, 33, 16, 8), (3, 8, 32, 16)]


@pytest.mark.parametrize("b,s,d,n", BWD_PLAN_SHAPES)
def test_bwd_plan_covers_every_element_once(b, s, d, n):
    """Every (b, chunk, d, n) is owned by exactly one (block, thread): a
    block ``channels`` channels of one batch row, a thread one channel
    and ``N / lanes`` of its states; the chunks of ``ops.STEPS`` steps
    partition S; a block's shared memory fits the card's 227 KB."""
    plan = ops.bwd_plan(b, s, d, n)
    gx, gb = plan.grid(b)
    assert gb == b and gx == -(-d // plan.channels)
    assert (plan.lanes, plan.warps) == (ops.BWD_LANES, ops.BWD_WARPS)
    assert plan.channels * plan.lanes == plan.threads == 32 * plan.warps
    assert n % plan.lanes == 0 and n // plan.lanes <= ops.BWD_MAX_STATES
    cells = np.zeros((d, n), np.int64)
    for x in range(gx):
        c0, c1 = plan.channel_range(x, d)
        assert c0 < c1
        for t in range(plan.threads):
            c, (m0, m1) = plan.thread(t, n)
            if c0 + c < c1:
                cells[c0 + c, m0:m1] += 1
    assert (cells == 1).all()
    steps = np.zeros(s, np.int64)
    for k in range(plan.chunks(s)):
        k0, k1 = plan.step_range(k, s)
        assert k1 - k0 <= plan.steps == ops.STEPS
        steps[k0:k1] += 1
    assert (steps == 1).all()
    assert plan.smem == ops.bwd_smem_bytes(n) <= ops.SMEM_LIMIT
    # the workspace: two (B, S, blocks, N) rows of sums over a block's
    # channels, dA's (B, D, N) and dDskip's (B, D) batch rows
    assert plan.workspace_bytes == 4 * (2 * b * s * gx * n + b * d * n
                                        + b * d)


def test_bwd_plan_rejects_what_the_kernel_cannot_run():
    for n in (2, 32):
        with pytest.raises(ValueError, match=f"N={n}"):
            ops.bwd_plan(1, 16, 8, n)


@pytest.mark.parametrize("n,knobs,match", [
    (4, dict(lanes=8), "8 lanes a channel cannot split N=4"),
    (16, dict(lanes=3), "3 lanes a channel cannot split N=16"),
    (8, dict(lanes=16), "16 lanes a channel cannot split N=8"),
    (16, dict(lanes=2), "2 lanes a channel cannot split N=16"),
    (16, dict(warps=3), "3 warps a block"),
    (16, dict(warps=1), "1 warps a block"),
    (16, dict(warps=16), "16 warps a block")])
def test_bwd_plan_rejects_lanes_and_knobs(n, knobs, match):
    """Lanes must divide N into at most ``BWD_MAX_STATES`` states a lane
    (2 x 16 steps x that many floats stay in registers); warps as the
    kernel takes them (2, 4 or 8)."""
    with pytest.raises(ValueError, match=match):
        ops.bwd_plan(1, 16, 64, n, **knobs)


@pytest.mark.parametrize("lanes,warps", ops.BWD_SWEEP)
def test_bwd_sweep_plans(lanes, warps):
    """Every build the sweep makes has a plan at falcon-mamba-7b's train
    shape, within the card's shared memory, and a build of its own (the
    kept pair is ``BWD_SOURCE``)."""
    plan = ops.bwd_plan(4, 512, 8192, 16, lanes=lanes, warps=warps)
    assert plan.channels == 32 * warps // lanes
    assert plan.smem <= ops.SMEM_LIMIT
    source = ops.bwd_source(lanes, warps)
    if (lanes, warps) == (ops.BWD_LANES, ops.BWD_WARPS):
        assert source is ops.BWD_SOURCE
    else:
        assert f"-DBWD_LANES={lanes}" in source.extra_flags
        assert f"-DBWD_WARPS={warps}" in source.extra_flags
        assert source.path == ops.BWD_SOURCE.path


def _bwd_operands(dtype=torch.float32, device="cpu"):
    b, s, d, n = 1, 4, 8, 4
    operands = [torch.zeros(shape, dtype=dtype, device=device) for shape in
                ((b, s, d), (b, s, n), (b, s, n), (b, s, d), (d, n), (d,),
                 (b, s, d))]
    return operands


def test_bwd_rejects_bfloat16_and_wrong_shapes():
    with pytest.raises(ValueError, match="float32"):
        selective_scan_bwd(*_bwd_operands(torch.bfloat16))
    mixed = _bwd_operands()
    mixed[6] = mixed[6].double()
    with pytest.raises(ValueError, match="dy is torch.float64"):
        selective_scan_bwd(*mixed)
    wrong = _bwd_operands()
    wrong[1] = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="bm must be"):
        selective_scan_bwd(*wrong)
    with pytest.raises(ValueError, match="dh_last must be"):
        selective_scan_bwd(*_bwd_operands(), torch.zeros((1, 8, 8)))
    with pytest.raises(ValueError, match="h_chunks must be"):
        selective_scan_bwd(*_bwd_operands(),
                           h_chunks=torch.zeros((1, 2, 8, 4)))
    with pytest.raises(ValueError, match="N=2"):
        selective_scan_bwd(*(torch.zeros(shape) for shape in (
            (1, 4, 8), (1, 4, 2), (1, 4, 2), (1, 4, 8), (8, 2), (8,),
            (1, 4, 8))))


def test_bwd_wrapper_rejects_non_cuda_device():
    with pytest.raises(ValueError, match="unsupported device"):
        selective_scan_bwd(*_bwd_operands(device="meta"))


@pytest.mark.parametrize("grad", [False, True])
def test_mamba_forward_routes_the_scan_under_grad(grad, monkeypatch):
    """``mamba_forward`` takes the autograd path only under grad with an
    operand that requires grad; serving (no grad, or frozen parameters)
    calls the wrapper as before."""
    cfg = reduced(get_config("falcon-mamba-7b"))
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    calls = []
    for mod, name in ((ops, "selective_scan"),
                      (scan_autograd, "selective_scan_grad")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    toks = torch.zeros((1, 8), dtype=torch.int64)
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(grad)
    try:
        logits, _, _ = model(toks)
    finally:
        for p in params:
            p.requires_grad_(False)
    # the autograd path's forward is the wrapper, called with ``chunk``
    want = ["selective_scan_grad", "selective_scan"] if grad \
        else ["selective_scan"]
    assert calls == want * cfg.num_layers
    assert (logits.grad_fn is not None) == grad
    assert mamba.scan_autograd is scan_autograd
