"""The port's decode attention (plain version, on the CPU) against the
JAX package: the Pallas ``flash_decode`` kernel in interpret mode and its
jnp oracle, on ``tests/test_kernels.py``'s sweep at its tolerances
(2e-4 float32, 2e-2 bfloat16), the layout wrapper against the reference
model's ``decode_attention``, and a row with no valid position."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_decode import flash_decode_ref as jax_decode_ref
from repro.models.layers import decode_attention as jax_decode_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.layers import decode_attention

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
CASES = [                        # test_kernels.py's flash_decode sweep
    (2, 2, 4, 128, 64, 16),
    (1, 1, 1, 64, 100, 32),     # padding path (100 % 32 != 0)
    (3, 4, 2, 128, 256, 256),   # single block
    (2, 8, 1, 128, 33, 8),      # MQA grouping
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
