"""The port's selective scan (plain version, on the CPU) against the JAX
package: the Pallas ``selective_scan`` kernel in interpret mode and its
jnp oracle, on ``tests/test_kernels.py``'s sweep at its tolerances
(2e-4 float32, 2e-2 bfloat16, times 5), and the last state against
``hs[:, -1]`` of the reference model's associative scan.  The associative
scan combines the steps in another order than a sequential scan, so the
two differ by rounding only: held at 5 x 2e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan as jax_scan
from repro.kernels.selective_scan import selective_scan_ref as jax_scan_ref
from repro_torch.kernels.selective_scan import selective_scan

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
                                     (2, 64, 24, 16)])
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
