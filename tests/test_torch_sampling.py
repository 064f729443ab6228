"""The port's sampler (``serving/sampling.py``) against jax's default
generator on the CPU: Threefry-2x32, ``PRNGKey``, ``fold_in`` and the
partitionable random bits bit for bit, over several shapes (a vocabulary
that is odd, batches of 1 and 4) and positions; ``uniform`` bitwise;
the Gumbel noise within 2 ulp (each of its two logs within 1 ulp of
XLA's, which computes ``log`` with its own polynomial: the noise's error
is the inner log's relative error, so it is counted in ulps of
max(1, |noise|)); ``categorical`` equal on equal logits, in float32 and,
under ``jax.enable_x64``, in float64 (64-bit draws).  Then the sampled
serve step, ``make_serve_step(greedy=False, temperature=t)``, against
the reference's over several steps of two reduced models: equal tokens,
except at a near-tie, a row whose two largest perturbed logits (the
reference's) lie within 1e-5 of each other, which the test asserts."""
import jax
import jax.extend.random as jax_random_ext
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.steps import make_prefill_step as ref_prefill
from repro.serving.steps import make_serve_step as ref_serve
from repro_torch.serving import sampling
from repro_torch.serving.steps import make_prefill_step, make_serve_step
from test_torch_models import _pair

SHAPES = [(1, 5), (4, 257), (4, 512), (3,)]
POSITIONS = [0, 1, 37, 288, 2**31 - 1, -1]
NEAR_TIE = 1e-5
TINY = float(np.finfo(np.float32).tiny)


def _keys(pos):
    """(jax's key, the port's) for ``fold_in(PRNGKey(0), pos)``."""
    return (jax.random.fold_in(jax.random.PRNGKey(0), jnp.int32(pos)),
            sampling.fold_in(sampling.prng_key(0),
                             torch.tensor(pos, dtype=torch.int32)))


def _as_int64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _ulps(a, b, bits=32) -> np.ndarray:
    """Distance in units in the last place of max(1, |a|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    eps = np.finfo(np.float32 if bits == 32 else np.float64).eps
    return np.abs(a - b) / (eps * np.maximum(1.0, np.abs(a)))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_prng_key_equals_jax(seed):
    np.testing.assert_array_equal(sampling.prng_key(seed).numpy(),
                                  _as_int64(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("n", [2, 10, 1026])
def test_threefry2x32_equals_jax(seed, n):
    """jax's ``threefry_2x32`` hashes the first half of the counts with
    the second and concatenates the two output words."""
    counts = np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint64)
    want = jax_random_ext.threefry_2x32(
        jax.random.PRNGKey(seed), jnp.asarray(counts.astype(np.uint32)))
    c = torch.from_numpy(counts.astype(np.int64))
    o0, o1 = sampling.threefry2x32(sampling.prng_key(seed), c[:n // 2],
                                   c[n // 2:])
    np.testing.assert_array_equal(torch.cat([o0, o1]).numpy(),
                                  _as_int64(want))


@pytest.mark.parametrize("pos", POSITIONS)
def test_fold_in_equals_jax(pos):
    want, got = _keys(pos)
    np.testing.assert_array_equal(got.numpy(), _as_int64(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("pos", [0, 288, -1])
def test_random_bits_equal_jax(shape, pos):
    kj, kp = _keys(pos)
    np.testing.assert_array_equal(
        sampling.random_bits(kp, shape).numpy(),
        _as_int64(jax.random.bits(kj, shape, jnp.uint32)))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (TINY, 1.0), (-2.0, 3.5)])
def test_uniform_bitwise_equal_jax(lo, hi):
    kj, kp = _keys(5)
    want = np.asarray(jax.random.uniform(kj, (4, 257), minval=lo,
                                         maxval=hi))
    got = sampling.uniform(kp, (4, 257), torch.float32, lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("pos", [0, 37, 288, -1])
def test_gumbel_within_two_ulp(pos):
    kj, kp = _keys(pos)
    shape = (4, 4097)
    want = np.asarray(jax.random.gumbel(kj, shape))
    got = sampling.gumbel(kp, shape).numpy()
    assert _ulps(want, got).max() <= 2.0
    u = sampling.uniform(kp, shape, torch.float32, TINY, 1.0)
    inner = -torch.log(u)
    for x in (u, inner):                 # each log against XLA's
        np.testing.assert_array_max_ulp(
            (-torch.log(x)).numpy(), np.asarray(-jnp.log(x.numpy())), 1)


@pytest.mark.parametrize("shape", [(1, 257), (4, 512), (4, 2049)], ids=str)
@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_categorical_equals_jax(shape, scale):
    logits = (np.random.default_rng(shape[-1]).standard_normal(shape)
              * scale).astype(np.float32)
    for pos in (0, 9, 300):
        kj, kp = _keys(pos)
        np.testing.assert_array_equal(
            sampling.categorical(kp, torch.from_numpy(logits)).numpy(),
            np.asarray(jax.random.categorical(kj, jnp.asarray(logits))))


def test_64_bit_draws_equal_jax():
    """Under jax's 64-bit mode a float64 draw takes both words of each
    element's hash: bits, uniforms bitwise, the Gumbel noise within 2
    ulp, ``categorical`` equal."""
    logits = np.random.default_rng(0).standard_normal((4, 257)) * 3
    with jax.enable_x64(True):
        kj = jax.random.fold_in(jax.random.PRNGKey(0), 41)
        kp = sampling.fold_in(sampling.prng_key(0), 41)
        np.testing.assert_array_equal(
            sampling.random_bits(kp, (4, 257), 64).numpy(),
            np.asarray(jax.random.bits(kj, (4, 257), jnp.uint64)).view(
                np.int64))
        want = np.asarray(jax.random.uniform(kj, (4, 257), jnp.float64))
        got = sampling.uniform(kp, (4, 257), torch.float64).numpy()
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64))
        assert _ulps(np.asarray(jax.random.gumbel(kj, (4, 257),
                                                  jnp.float64)),
                     sampling.gumbel(kp, (4, 257), torch.float64).numpy(),
                     bits=64).max() <= 2.0
        np.testing.assert_array_equal(
            sampling.categorical(kp, torch.from_numpy(logits)).numpy(),
            np.asarray(jax.random.categorical(kj, jnp.asarray(logits))))


def test_sampler_refuses_what_it_does_not_draw():
    key = sampling.prng_key(0)
    with pytest.raises(ValueError, match="dtype"):
        sampling.uniform(key, (3,), torch.bfloat16)
    with pytest.raises(ValueError, match="width"):
        sampling.random_bits(key, (3,), 16)
    with pytest.raises(ValueError, match="seed"):
        sampling.prng_key(-1)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "paligemma-3b"])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_sampled_serve_step_matches_reference(arch, temperature):
    """A prefill step, then four sampled ``make_serve_step``s on both
    packages, each fed the reference's token: the port's tokens equal the
    reference's, except at an asserted near-tie."""
    ref, params, port = _pair(arch)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, ref.cfg.vocab, (4, 6)).astype(np.int32)
    batch = {"tokens": toks}
    if ref.cfg.vision is not None:
        batch["patches"] = (rng.standard_normal(
            (4, ref.cfg.vision.num_patches, ref.cfg.vision.embed_dim))
            * 0.02).astype(np.float32)
    want, want_cache = ref_prefill(ref, cache_len=24)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    _, cache = make_prefill_step(port, cache_len=24)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    nxt = np.array(jnp.argmax(want, -1), np.int32)[:, None]
    serve = make_serve_step(port, greedy=False, temperature=temperature)
    differ = 0
    for _ in range(4):
        w, want_cache = ref_serve(ref, greedy=False, temperature=temperature)(
            params, want_cache, {"tokens": jnp.asarray(nxt)})
        g, cache = serve(cache, {"tokens": torch.from_numpy(nxt)})
        want_tok = np.asarray(w["next_token"])
        diff = g["next_token"].numpy() != want_tok
        if diff.any():
            key = jax.random.fold_in(jax.random.PRNGKey(0),
                                     want_cache["pos"][0])
            pert = np.asarray(w["logits"] / temperature + jax.random.gumbel(
                key, w["logits"].shape))
            top2 = -np.sort(-pert, axis=-1)[:, :2]
            assert (top2[diff, 0] - top2[diff, 1] <= NEAR_TIE).all()
            differ += int(diff.sum())
        nxt = want_tok.astype(np.int32)[:, None]
    assert differ <= 1
