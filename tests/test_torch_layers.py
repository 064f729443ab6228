"""The port's primitive layers against the reference model's
(``repro/models/layers.py``) on the same numpy inputs: norms,
activations, RoPE and the sinusoidal table, float32 at 1e-6 (the same
elementwise formulas; only the ulps of ``exp``/``sin``/``rsqrt`` and the
order of a mean may differ)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref
from repro_torch.models import layers

RNG = np.random.default_rng(0)
X = RNG.standard_normal((2, 7, 4, 32)).astype(np.float32) * 3


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    p = {"scale": RNG.standard_normal(32).astype(np.float32),
         "bias": RNG.standard_normal(32).astype(np.float32)}
    got = layers.norm(torch.from_numpy(X), {k: torch.from_numpy(v)
                                            for k, v in p.items()}, kind,
                      1e-5)
    want = ref.norm(jnp.asarray(X), {k: jnp.asarray(v) for k, v in p.items()},
                    kind, 1e-5)
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_glu"])
def test_activation_matches_reference(name):
    _close(layers.act_fn(name)(torch.from_numpy(X)),
           ref.act_fn(name)(jnp.asarray(X)), atol=2e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_rope_matches_reference(theta, positions):
    """Positions (S,) as in a prefill, (B, 1) as in a decode step."""
    if positions == "prefill":
        x, pos = X, np.arange(7)
    else:
        x, pos = X[:, :1], np.array([[5], [300]])
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
           ref.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           atol=1e-5)
    _close(layers.rope_freqs(32, theta), ref.rope_freqs(32, theta))


def test_sinusoidal_positions_match_reference():
    _close(layers.sinusoidal_positions(50, 16),
           ref.sinusoidal_positions(50, 16), atol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "rope"])
def test_float64_stays_float64(kind):
    """A float64 model (the float64 witness the on-card smoke run holds
    the kernels' model to) computes its norms and RoPE in float64, at
    the float32 model's RoPE frequencies."""
    rng = np.random.default_rng(7)
    x = X.astype(np.float64)
    scale, bias = rng.standard_normal(32), rng.standard_normal(32)
    if kind == "rope":
        pos = np.arange(7)
        ang = pos[:, None] * layers.rope_freqs(32, 1e4).double().numpy()
        cos, sin = np.cos(ang)[:, None, :], np.sin(ang)[:, None, :]
        x1, x2 = x[..., :16], x[..., 16:]
        want = np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                1e4)
    else:
        p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
        got = layers.norm(torch.from_numpy(x), p, kind, 1e-5)
        if kind == "rmsnorm":
            want = x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-5) * scale
        else:
            c = x - x.mean(-1, keepdims=True)
            want = c / np.sqrt((c ** 2).mean(-1, keepdims=True) + 1e-5) \
                * scale + bias
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
