"""The port's prefill attention (plain version, on the CPU) against the
JAX package: the Pallas ``flash_prefill`` kernel in interpret mode and its
jnp oracle, on ``tests/test_kernels.py``'s sweep at its tolerances
(2e-4 float32, 2e-2 bfloat16, times 3), and the port's ``gqa_attention``
against the reference model's at atol 2e-5 (``test_kernels.py:120``)."""
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
