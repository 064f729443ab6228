"""The port's decode attention (plain version, on the CPU) against the
JAX package: the Pallas ``flash_decode`` kernel in interpret mode and its
jnp oracle, on ``tests/test_kernels.py``'s sweep at its tolerances
(2e-4 float32, 2e-2 bfloat16), the layout wrapper against the reference
model's ``decode_attention``, and a row with no valid position.  The
kernel's split of the cache over the card (``ops.decode_plan``) is
pinned here: enough blocks at the serving and long-context shapes, every
head and position covered once, and the chunked online softmax with its
merge, computed the kernel's way in torch, equal to the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_decode import flash_decode_ref as jax_decode_ref
from repro.models.layers import decode_attention as jax_decode_attention
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.flash_decode import ops
from repro_torch.models.layers import decode_attention

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
CASES = [                        # test_kernels.py's flash_decode sweep
    (2, 2, 4, 128, 64, 16),
    (1, 1, 1, 64, 100, 32),     # padding path (100 % 32 != 0)
    (3, 4, 2, 128, 256, 256),   # single block
    (2, 8, 1, 128, 33, 8),      # MQA grouping
    (2, 1, 8, 256, 96, 32),     # paligemma-3b's heads: G = 8 at hd 256
]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,kh,g,hd,c,bc", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_kernel(b, kh, g, hd, c, bc, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(b * 1000 + c * 10 + g)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, kh, g, hd), (b, c, kh, hd), (b, c, kh, hd)))
    valid = (rng.random((b, c)) > 0.25).astype(np.int32)
    got = flash_decode(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                       torch.from_numpy(valid))
    assert got.dtype == tdt and got.shape == (b, kh, g, hd)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(valid)]
    pallas = jax_flash_decode(*jargs, block_c=bc, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(jax_decode_ref(*jargs)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("c,window", [(16, None), (8, 8)])
def test_layout_wrapper_matches_model_decode_attention(c, window):
    """(B, 1, H, hd) against a rotating cache: the validity mask built
    from ``cache_positions`` and ``pos`` as the reference model builds it;
    one row's cache has wrapped, one is partly filled."""
    rng = np.random.default_rng(3)
    b, h, kh, hd = 3, 8, 2, 32
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, c, kh, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.array([3, c + 5, c - 1], np.int32)
    idx = np.arange(c)[None, :]
    cache_pos = pos[:, None] - ((pos[:, None] - idx) % c)
    if window is not None:
        cache_pos = np.where(cache_pos > pos[:, None] - window, cache_pos, -1)
    got = decode_attention(*(torch.from_numpy(a)
                             for a in (q, k, v, pos, cache_pos)))
    want = jax_decode_attention(*(jnp.asarray(a)
                                  for a in (q, k, v, pos, cache_pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_row_without_valid_position_is_finite():
    """An empty batch slot (pos = -1) sees no valid position: the row
    averages the cache, as the Pallas kernel and the reference model do,
    and stays finite; the other rows are untouched by it."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 2, 4, 64), (2, 20, 2, 64), (2, 20, 2, 64)))
    valid = np.ones((2, 20), np.int32)
    valid[1] = 0
    got = flash_decode(*(torch.from_numpy(a) for a in (q, k, v, valid)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(v[1].mean(0)[:, None],
                                               (2, 4, 64)), atol=1e-6)
    pallas = jax_flash_decode(*(jnp.asarray(a) for a in (q, k, v, valid)),
                              block_c=20, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-4)


def test_wrapper_rejects_non_cuda_device():
    q = torch.zeros((1, 1, 1, 32), device="meta")
    k = torch.zeros((1, 4, 1, 32), device="meta")
    valid = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_decode(q, k, k, valid)


H100_SMS = 132
SERVING = (4, 4, 8, 1024, 64)        # tinyllama-1.1b's decode: B KH G C hd
LONG = (1, 8, 4, 8192, 128)          # llama3-8b, one sequence, C = 8192


@pytest.mark.parametrize("shape", [SERVING, LONG], ids=["serving", "long"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plan_fills_the_card(shape, dtype):
    """About two blocks an SM (the old kernel ran 16 and 8 blocks), chunks
    of whole 32-position tiles, and the most ring stages (up to 3) at
    which three blocks' shared memory fit an SM (228 KB, 1 KB a block
    reserved): 2 for float32 at hd = 128."""
    b, kh, g, c, hd = shape
    plan = ops.decode_plan(b, kh, g, c, hd, H100_SMS, dtype=dtype)
    assert plan.blocks(b, kh) >= 1.5 * H100_SMS
    assert plan.chunk >= ops.TILE and plan.chunk % ops.TILE == 0
    assert plan.n_chunks == -(-c // plan.chunk)
    assert 3 * (plan.smem + 1024) <= 233472
    assert plan.stages == (2 if (hd, dtype) == (128, torch.float32) else 3)
    deeper = ops.decode_plan(b, kh, g, c, hd, H100_SMS, dtype=dtype,
                             stages=plan.stages + 1)
    assert 3 * (deeper.smem + 1024) > 233472 or plan.stages == ops.STAGES
    assert plan.workspace_floats(b, kh, hd) == (
        b * kh * plan.n_chunks * plan.gt * (hd + 2))


@pytest.mark.parametrize("shape,chunk", [
    (SERVING, None), (LONG, None),
    ((2, 1, 48, 160, 128), None),    # granite-20b's MQA: six head tiles
    ((1, 2, 6, 20, 64), None),       # C below one tile, G = 6 in a tile of 8
    ((3, 2, 3, 100, 32), 64),        # a forced chunk, C no multiple of it
])
def test_decode_plan_covers_each_head_and_position_once(shape, chunk):
    """Block i's work as the kernel derives it from blockIdx.x: pair i //
    n_chunks = (b, kh, head tile), chunk i % n_chunks."""
    b, kh, g, c, hd = shape
    plan = ops.decode_plan(b, kh, g, c, hd, H100_SMS, chunk=chunk)
    seen = np.zeros((b, kh, g, c), np.int32)
    for i in range(plan.blocks(b, kh)):
        chunk_i, pair = i % plan.n_chunks, i // plan.n_chunks
        bk, tile = divmod(pair, plan.n_gtiles)
        bi, h = divmod(bk, kh)
        g0, c0 = tile * plan.gt, chunk_i * plan.chunk
        heads = range(g0, min(g0 + plan.gt, g))
        positions = range(c0, min(c0 + plan.chunk, c))
        assert len(heads) >= 1 and len(positions) >= 1
        seen[bi, h, heads.start:heads.stop, positions.start:positions.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("g,gt,tiles", [(1, 1, 1), (3, 4, 1), (6, 8, 1),
                                        (8, 8, 1), (48, 8, 6)])
def test_decode_plan_head_tiles(g, gt, tiles):
    plan = ops.decode_plan(2, 2, g, 64, 64, H100_SMS)
    assert (plan.gt, plan.n_gtiles) == (gt, tiles)
    assert plan.chunk == ops.TILE and plan.n_chunks == 2   # C = 64


@pytest.mark.parametrize("kw,match", [
    (dict(chunk=48), "multiple of 32"), (dict(chunk=8192), "multiple of 32"),
    (dict(stages=5), "stages"), (dict(hd=96), "hd=96")])
def test_decode_plan_rejects_what_the_kernel_cannot_run(kw, match):
    args = dict(b=1, kh=2, g=4, c=512, hd=64, n_sms=H100_SMS)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        ops.decode_plan(**args)


def _split_decode(q, k, v, valid, plan):
    """The kernel's arithmetic in torch (float32): per chunk, an online
    softmax over its 32-position tiles that have a valid position; then
    the partials merged in chunk order, or the row's V mean when no
    chunk saw a valid position."""
    b, kh, g, hd = q.shape
    c = k.shape[1]
    out = torch.empty_like(q)
    for bi in range(b):
        for h in range(kh):
            parts = []
            for ci in range(plan.n_chunks):
                lo, hi = ci * plan.chunk, min(c, (ci + 1) * plan.chunk)
                m = torch.full((g,), -np.inf)
                den, acc = torch.zeros(g), torch.zeros(g, hd)
                for t0 in range(lo, hi, ops.TILE):
                    t1 = min(t0 + ops.TILE, hi)
                    ok = valid[bi, t0:t1] > 0
                    if not ok.any():
                        continue
                    s = (q[bi, h] @ k[bi, t0:t1, h].T) * hd ** -0.5
                    s = torch.where(ok, s, -np.inf)
                    m_new = torch.maximum(m, s.amax(-1))
                    p = torch.exp(s - m_new[:, None])
                    cr = torch.exp(m - m_new)
                    den = den * cr + p.sum(-1)
                    acc = acc * cr[:, None] + p @ v[bi, t0:t1, h]
                    m = m_new
                parts.append((m, den, acc))
            ms = torch.stack([p[0] for p in parts])
            if torch.isinf(ms).all():
                out[bi, h] = v[bi, :, h].mean(0)
                continue
            f = torch.where(torch.isinf(ms), 0.0, torch.exp(ms - ms.amax(0)))
            den = sum(p[1] * f[i] for i, p in enumerate(parts))
            num = sum(p[2] * f[i][:, None] for i, p in enumerate(parts))
            out[bi, h] = num / torch.clamp(den, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("shape,mask", [
    ((2, 2, 4, 200, 32), "random, last row empty"),
    ((1, 2, 8, 300, 64), "rotating window"),
    ((3, 1, 2, 96, 32), "all valid"),
])
def test_split_merge_matches_plain(shape, mask):
    """Chunks of the default plan and of a forced 32-position chunk (one
    tile a block), with a ragged last chunk: the kernel's split and merge
    give the plain version's answer within 2e-4 (float32), the empty row
    the mean of its V rows."""
    b, kh, g, c, hd = shape
    rng = np.random.default_rng(c + g)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, kh, g, hd), (b, c, kh, hd), (b, c, kh, hd)))
    if mask == "random, last row empty":
        valid = (rng.random((b, c)) > 0.6).astype(np.int32)
        valid[-1] = 0
    elif mask == "rotating window":
        pos = np.array([c + 77])
        cache_pos = pos[:, None] - ((pos[:, None] - np.arange(c)) % c)
        valid = (cache_pos > pos[:, None] - 100).astype(np.int32)
    else:
        valid = np.ones((b, c), np.int32)
    valid = torch.from_numpy(valid)
    want = flash_decode_ref(q, k, v, valid)
    for chunk in (None, ops.TILE):
        plan = ops.decode_plan(b, kh, g, c, hd, H100_SMS, chunk=chunk)
        got = _split_decode(q, k, v, valid, plan)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                                   rtol=2e-4, err_msg=f"plan {plan}")
