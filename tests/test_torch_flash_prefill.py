"""The port's prefill attention (plain version, on the CPU) against the
JAX package: the Pallas ``flash_prefill`` kernel in interpret mode and its
jnp oracle, on ``tests/test_kernels.py``'s sweep at its tolerances
(2e-4 float32, 2e-2 bfloat16, times 3), and the port's ``gqa_attention``
against the reference model's at atol 2e-5 (``test_kernels.py:120``).
Then the CUDA kernel's launch plan (every visible pair walked once,
heaviest blocks first, shared memory within the card's) and its precision
scheme (3xTF32 products, emulated, against float64).  Last, the
gradient: ``flash_prefill_bwd`` and the autograd path against ``jax.vjp``
of the jnp oracle (tolerances where they are defined)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import flash_prefill as jax_flash_prefill
from repro.kernels.flash_prefill import flash_prefill_ref as jax_prefill_ref
from repro.kernels.flash_prefill.ops import \
    prefill_attention as jax_prefill_attention
from repro.models.layers import gqa_attention as jax_gqa_attention
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_bwd,
                                               flash_prefill_grad,
                                               flash_prefill_ref, ops,
                                               prefill_attention)
from repro_torch.models.layers import gqa_attention

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
CASES = [                        # test_kernels.py's flash_prefill sweep
    (2, 2, 2, 32, 32, 8, 8, None),
    (1, 1, 4, 33, 64, 16, 8, None),    # ragged padding
    (2, 2, 1, 64, 32, 16, 16, 12),     # sliding window (block skipping)
    (1, 4, 1, 48, 128, 16, 16, None),  # MQA-ish, hd 128
]


def _pair(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,kh,g,s,hd,bq,bk,win", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_kernel(b, kh, g, s, hd, bq, bk, win, dtype):
    rng = np.random.default_rng(b * 1000 + s * 10 + hd)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, kh, g, s, hd), (b, kh, s, hd), (b, kh, s, hd)))
    got = flash_prefill(tq, tk, tv, window=win)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 3 * DTYPES[dtype][2]
    pallas = jax_flash_prefill(jq, jk, jv, window=win, block_q=bq,
                               block_k=bk, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    oracle = jax_prefill_ref(jq, jk, jv, window=win)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 7])
def test_layout_wrapper_matches_reference_wrapper(window):
    """(B, S, H, hd) in and out, head h = (h // G, h % G)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 24, 8, 32), (2, 24, 2, 32), (2, 24, 2, 32)))
    got = prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            window=window)
    want = jax_prefill_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 window=window, use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("chunks", [(8, 8), (1024, 2048)])
@pytest.mark.parametrize("window", [None, 5])
def test_gqa_attention_matches_model_attention(chunks, window):
    """The port's causal self-attention (the ``flash_prefill`` op) against
    the reference model's flash-style XLA attention at atol 2e-5."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 24, 8, 32), (2, 24, 2, 32), (2, 24, 2, 32)))
    got = gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        window=window)
    pos = jnp.arange(24)
    want = jax_gqa_attention(*(jnp.asarray(a) for a in (q, k, v)), pos, pos,
                             causal=True, window=window, q_chunk=chunks[0],
                             kv_chunk=chunks[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("mode", ["non_causal", "prefix", "k_valid"])
def test_plain_attention_paths_match_model_attention(mode):
    """The attention the serving path does not use (encoder, vision
    prefix, key mask) is the plain version; held to the reference too."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
    qp, kp = np.arange(4, 16), np.arange(16)
    kw = {"non_causal": dict(causal=False),
          "prefix": dict(prefix_len=6, window=5),
          "k_valid": dict(k_valid=rng.random(16) > 0.3)}[mode]
    tkw = {key: torch.from_numpy(val) if isinstance(val, np.ndarray) else val
           for key, val in kw.items()}
    jkw = {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val
           for key, val in kw.items()}
    got = gqa_attention(*(torch.from_numpy(a) for a in (q, k, v, qp, kp)),
                        **tkw)
    want = jax_gqa_attention(*(jnp.asarray(a) for a in (q, k, v, qp, kp)),
                             q_chunk=4, kv_chunk=8, **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_wrapper_rejects_non_cuda_device():
    q = torch.zeros((1, 1, 1, 4, 32), device="meta")
    k = torch.zeros((1, 1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill(q, k, k)


# ------------------------------------------------- the kernel's launch plan
# The CUDA kernel runs only on the card; its tiling is Python
# (``launch_plan``) so it is pinned here: which (query row, key) pairs
# each warpgroup of each block walks, in what order, in how much shared
# memory.

PLAN_CASES = [case[:4] + case[4:5] + case[7:] for case in CASES] + [
    (1, 4, 8, 512, 64, None),          # tinyllama-1.1b's admit
    (1, 8, 4, 512, 128, None),         # llama3-8b's widths
    (1, 1, 48, 33, 128, None),         # granite-20b's MQA, ragged S
    (1, 4, 8, 512, 64, 100),           # a window at the serving width
]
PLAN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _visible(g, s, window):
    """(G S, S): row r = (s, g) in (s, g) order sees key t."""
    pos = np.arange(g * s) // g
    key = np.arange(s)
    ok = key[None, :] <= pos[:, None]
    if window is not None:
        ok &= key[None, :] > pos[:, None] - window
    return ok


def _plans(b, kh, g, s, hd, window, dtype):
    """The default plan and every row tile / key tile the kernel takes."""
    plans = [ops.launch_plan(b, kh, g, s, hd, window, dtype)]
    for rows in ops.ROWS:
        for bk in ops.KEY_TILES[dtype]:
            try:
                plans.append(ops.launch_plan(b, kh, g, s, hd, window, dtype,
                                             rows=rows, bk=bk))
            except ValueError:
                pass
    return plans


@pytest.mark.parametrize("b,kh,g,s,hd,win", PLAN_CASES)
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_launch_plan_covers_each_visible_pair_once(b, kh, g, s, hd, win,
                                                   dtype):
    vis = _visible(g, s, win)
    for plan in _plans(b, kh, g, s, hd, win, PLAN_DTYPES[dtype]):
        seen = np.zeros((b, kh, g * s, s), np.int32)
        for _, bb, hh, r0, r1, t0, t1 in plan.units(b, kh, g, s, win):
            assert 0 <= r0 < r1 <= g * s and r1 - r0 <= ops.WG_ROWS
            for t in range(t0, t1 + 1):        # no tile without a visible key
                assert vis[r0:r1, t * plan.bk:(t + 1) * plan.bk].any(), plan
            k0, k1 = t0 * plan.bk, min((t1 + 1) * plan.bk, s)
            seen[bb, hh, r0:r1, k0:k1] += vis[r0:r1, k0:k1]
        np.testing.assert_array_equal(seen, np.broadcast_to(vis, seen.shape),
                                      err_msg=str(plan))
        assert plan.blocks(b, kh) == b * kh * -(-g * s // plan.rows)


@pytest.mark.parametrize("b,kh,g,s,hd,win", PLAN_CASES)
def test_launch_plan_orders_tiles_heaviest_first(b, kh, g, s, hd, win):
    """Blocks launch in order of their walk, longest first, so the longest
    walks of the causal triangle start at once.  A block's work is its
    key tiles (each the same 64-row products, however many of its rows
    are real), the union of its warpgroups' ranges.  Under a window every
    walk past the first ``window`` positions spans the window, give or
    take the one key tile that its alignment adds."""
    plan = ops.launch_plan(b, kh, g, s, hd, win, torch.float32)
    first = np.full(plan.blocks(b, kh), np.iinfo(np.int64).max)
    last = np.full(plan.blocks(b, kh), -1)
    for blk, _, _, _, _, t0, t1 in plan.units(b, kh, g, s, win):
        first[blk], last[blk] = min(first[blk], t0), max(last[blk], t1)
    walk = last - first + 1
    longest_after = np.maximum.accumulate(walk[::-1])[::-1]
    assert (walk >= longest_after - (1 if win else 0)).all(), walk
    assert walk[0] == walk.max() or win


@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_launch_plan_shared_memory_fits_at_hd_128(dtype):
    """Every plan the kernel takes at hd = 128 fits the H100's 227 KB a
    block; a ring that does not fit is refused, not launched."""
    dt = PLAN_DTYPES[dtype]
    taken = 0
    for rows in ops.ROWS:
        for bk in ops.KEY_TILES[dt]:
            for stages in range(ops.MIN_STAGES, ops.MAX_STAGES + 1):
                try:
                    plan = ops.launch_plan(1, 8, 4, 4096, 128, None, dt,
                                           rows=rows, bk=bk, stages=stages)
                except ValueError as err:
                    assert "shared memory" in str(err)
                    assert ops.smem_bytes(4 if dt == torch.float32 else 2,
                                          128, bk, rows, stages) > 232448
                    continue
                taken += 1
                assert plan.smem <= ops.SMEM_LIMIT == 232448
                assert plan.smem == ops.smem_bytes(
                    4 if dt == torch.float32 else 2, 128, bk, rows, stages)
    assert taken >= 1
    assert ops.launch_plan(1, 8, 4, 4096, 128, None, dt).smem <= 232448


def test_launch_plan_choices_at_the_measured_shapes():
    """The plan's knobs where they were timed on the card: tinyllama's
    admit takes 64-row blocks of 32-key tiles in a 3-stage ring (two
    blocks an SM, as many as its 256 blocks need); four admits at once a
    2-stage ring (three blocks an SM); the long prompt 128-row blocks
    (two warpgroups share each K/V tile; two 64-row blocks of hd = 128
    do not fit an SM) in a 2-stage ring; float32 is 3xTF32, bf16 one
    bf16 product."""
    serving = ops.launch_plan(1, 4, 8, 512, 64, None, torch.float32)
    assert (serving.rows, serving.bk, serving.stages) == (64, 32, 3)
    assert serving.precision == "3xtf32" and ops.resident(serving.smem) == 2
    batch = ops.launch_plan(4, 4, 8, 512, 64, None, torch.float32)
    assert (batch.rows, batch.bk, batch.stages) == (64, 32, 2)
    assert ops.resident(batch.smem) == 3
    long = ops.launch_plan(1, 8, 4, 4096, 128, None, torch.float32)
    assert (long.rows, long.bk, long.stages) == (128, 32, 2)
    assert ops.launch_plan(1, 4, 8, 512, 64, None,
                           torch.bfloat16).precision == "bf16"
    with pytest.raises(ValueError, match="key tile"):
        ops.launch_plan(1, 4, 8, 512, 64, None, torch.bfloat16, bk=32)
    with pytest.raises(ValueError, match="stages"):
        ops.launch_plan(1, 4, 8, 512, 64, None, torch.float32, stages=5)


# ---------------------------------------------- the precision scheme (3xTF32)

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 fraction bits), nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: the mantissa bits below are masked."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b):
    """a @ b as the kernel computes a float32 product on the tensor cores:
    hi = tf32(x), lo = tf32(x - hi); a_lo b_hi + a_hi b_lo + a_hi b_hi,
    each TF32 product exact in float32, summed in float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _one_pass_mm(a, b):
    return _tf32(a) @ _tf32(b)


def _attention(q, k, v, mm):
    s, hd = q.shape
    scores = mm(q, k.T) * hd ** -0.5
    ok = torch.ones(s, s, dtype=torch.bool).tril()
    scores = torch.where(ok, scores, torch.tensor(-1e30, dtype=q.dtype))
    return mm(torch.softmax(scores, -1), v), torch.where(ok, scores, 0)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tf32_products_keep_float32_accuracy(hd, seed):
    """Causal attention with both products in 3xTF32, at scores in the
    hundreds (as full-width models on the reference's initialisers give),
    stays within twice the plain float32 version's error against float64,
    in the scores and in the output; one TF32 pass does not (the test has
    teeth)."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((512, hd)) * 6 for _ in range(2))
    v = rng.standard_normal((512, hd))
    exact_o, exact_s = _attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  lambda a, b: a @ b)
    assert float(exact_s.abs().max()) > 100
    err = {}
    for name, mm in (("plain", lambda a, b: a @ b), ("3xtf32", _split_mm),
                     ("tf32", _one_pass_mm)):
        o, sc = _attention(*(torch.from_numpy(a).float() for a in (q, k, v)),
                           mm)
        err[name] = (float((o.double() - exact_o).abs().max()),
                     float((sc.double() - exact_s).abs().max()))
    for i in range(2):
        assert err["3xtf32"][i] <= 2 * err["plain"][i], err
        assert err["tf32"][i] > 2 * err["plain"][i], err


# ---------------------------------------------------------------- backward
#
# The gradient the train step takes through the kernel: ``flash_prefill_bwd``
# (explicit torch operations, in query chunks) and the autograd path that
# ``prefill_attention`` takes under grad, against ``jax.vjp`` of the
# reference's jnp oracle (``repro/kernels/flash_prefill/ref.py``).  The
# oracle computes in float32 even for float64 operands, so both types are
# held to it at 1e-5 relative to each gradient's largest entry: float32
# sums over up to 40 keys taken in another order differ by up to 9e-7 of
# the largest entry here, and the float64 port differs from the float32
# oracle by the oracle's own rounding (5e-7).  The float64 port is then
# held to autograd of the port's own plain version in float64 at 1e-12,
# the exact gradient.

BWD_SHAPE = (2, 2, 40)           # (B, KH, S): S not a multiple of a chunk
BWD_TOL = 1e-5


def _bwd_operands(g, hd, dtype, seed=0):
    b, kh, s = BWD_SHAPE
    rng = np.random.default_rng(seed + 97 * g + hd)
    shapes = ((b, kh, g, s, hd), (b, kh, s, hd), (b, kh, s, hd),
              (b, kh, g, s, hd))
    return [rng.standard_normal(sh).astype(dtype) for sh in shapes]


def _oracle_vjp(q, k, v, do, window):
    import jax
    with jax.enable_x64(q.dtype == np.float64):
        dt = jnp.float64 if q.dtype == np.float64 else jnp.float32
        out, vjp = jax.vjp(
            lambda a, b, c: jax_prefill_ref(a, b, c, window=window),
            *(jnp.asarray(x, dt) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do, dt))
        return np.asarray(out), [np.asarray(gr) for gr in grads]


def _hold_rel(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: max |diff| / max |want| = {err:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 4])
def test_backward_matches_oracle_vjp(g, hd, window, dtype):
    """dq, dk, dv of ``flash_prefill_bwd`` (16-row chunks, so the last is
    ragged) and of the autograd path (one chunk) against ``jax.vjp`` of
    the oracle; in float64 also against autograd of the plain version."""
    q, k, v, do = _bwd_operands(g, hd, np.dtype(dtype))
    want_o, want = _oracle_vjp(q, k, v, do, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = flash_prefill(tq, tk, tv, window=window)
    chunked = flash_prefill_bwd(tq, tk, tv, o, tdo, window=window, chunk=16)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = flash_prefill_grad(*leaves, window=window)
    path = torch.autograd.grad(out, leaves, tdo)
    _hold_rel(out, want_o, BWD_TOL, "output")
    for name, a, b_, w in zip(("dq", "dk", "dv"), chunked, path, want):
        assert a.dtype == tq.dtype and a.shape == w.shape, name
        _hold_rel(a, w, BWD_TOL, f"{name}, chunked")
        _hold_rel(b_, w, BWD_TOL, f"{name}, autograd path")
    if dtype == "float64":
        exact = torch.autograd.grad(
            flash_prefill_ref(*leaves, window=window), leaves, tdo)
        for name, a, w in zip(("dq", "dk", "dv"), chunked, exact):
            _hold_rel(a, w.numpy(), 1e-12, f"{name} vs float64 autograd")


def _graph_nodes(fn) -> set:
    """The names of the autograd nodes reachable from ``fn``."""
    seen, todo = set(), [fn]
    while todo:
        node = todo.pop()
        if node is not None and type(node).__name__ not in seen:
            seen.add(type(node).__name__)
            todo.extend(nxt for nxt, _ in node.next_functions)
    return seen


@pytest.mark.parametrize("window", [None, 5])
def test_prefill_attention_routes_by_grad_mode(window):
    """Under grad, ``prefill_attention`` goes through the autograd path
    (its output has the Function's ``grad_fn``) and its gradients equal
    autograd of the plain version on the model's (B, S, H, hd) views;
    without grad, the output has none and is the same."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((2, 24, 8, 32), (2, 24, 2, 32), (2, 24, 2, 32)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = prefill_attention(*leaves, window=window)
    assert "FlashPrefillBackward" in _graph_nodes(out.grad_fn)
    with torch.no_grad():
        plain = prefill_attention(*leaves, window=window)
    assert plain.grad_fn is None
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    do = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, leaves, do)
    b, s, h, hd = q.shape
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    qr = ref_leaves[0].reshape(b, s, 2, 4, hd).permute(0, 2, 3, 1, 4)
    ref_out = flash_prefill_ref(qr, ref_leaves[1].transpose(1, 2),
                                ref_leaves[2].transpose(1, 2), window=window)
    want = torch.autograd.grad(
        ref_out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd), ref_leaves, do)
    for a, w in zip(got, want):
        assert bool(a.abs().max() > 0)
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
