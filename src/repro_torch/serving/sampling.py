"""Sampled decode: the draw of the reference's sampled serve step,
``jax.random.categorical(fold_in(PRNGKey(0), pos), logits / temperature)``
(``repro/serving/steps.py``), bit for bit.

jax's default generator is Threefry-2x32 with partitionable random bits:
a key is two 32-bit words; ``PRNGKey(seed)`` is (seed >> 32, seed mod
2^32); ``fold_in(key, d)`` hashes the counter pair (0, d) under the key;
the random bits of an array hash the (high, low) words of each element's
flat index and xor the two output words (64-bit draws keep both).  A
float in [1, 2) takes the top mantissa bits, minus 1, then the
``uniform``'s affine map to [tiny, 1); ``gumbel`` (its default "low"
mode) is -log(-log(u)), and ``categorical`` the argmax of logits plus
that noise, the first index on ties.  The hash is computed here with
plain tensor operations, on any device, the 32-bit words held in int64
tensors and masked after each add and shift (``torch.uint32`` lacks
them on some backends).  Every draw follows from its key: there is no
global generator.  The reference computes this in XLA, not in a Pallas
kernel, so there is no kernel here either.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

MASK = 0xFFFFFFFF
# Threefry-2x32's rotations, the key schedule's parity constant, 20 rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
# float32 and float64: (mantissa bits, the bits of 1.0)
FLOATS = {torch.float32: (23, 0x3F800000),
          torch.float64: (52, 0x3FF0000000000000)}


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under
    ``key`` (2,): int64 tensors of 32-bit values, x0 and x1 broadcast
    together.  Returns the two output words, int64 in [0, 2^32)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s two words, (2,) int64, for a seed
    in [0, 2^64)."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"prng_key: seed {seed} outside [0, 2^64)")
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor | int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``data`` an integer (a 0-d
    tensor, on the key's device, or an int) taken mod 2^32, as jax casts
    it to uint32."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    o0, o1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([o0, o1])


def random_bits(key: torch.Tensor, shape, width: int = 32) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` with partitionable Threefry, of
    ``width`` 32 or 64: int64 (a 64-bit draw's bit pattern, two's
    complement) of ``shape``."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    o0, o1 = threefry2x32(key, idx >> 32, idx & MASK)
    if width == 32:
        bits = o0 ^ o1
    elif width == 64:
        bits = (o0 << 32) | o1
    else:
        raise ValueError(f"random_bits: width {width}, 32 or 64 taken")
    return bits.reshape(shape)


def uniform(key: torch.Tensor, shape, dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: float32 or float64 in [minval, maxval),
    from the top mantissa bits of one draw an element.  Bitwise jax's in
    float32; in float64 where the map's product is exact (a scale of 1,
    as the sampler's), since no wider type rounds it once."""
    if dtype not in FLOATS:
        raise ValueError(f"uniform: dtype {dtype}, float32 or float64 "
                         f"taken")
    nmant, one = FLOATS[dtype]
    width = 64 if dtype == torch.float64 else 32
    bits = random_bits(key, shape, width)
    # a logical right shift of the pattern, then the exponent of 1.0
    mant = (bits >> (width - nmant)) & ((1 << nmant) - 1)
    if dtype == torch.float32:
        f = (mant | one).to(torch.int32).view(torch.float32)
    else:
        f = (mant | one).view(torch.float64)
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    # XLA contracts the affine map into one multiply-add: a float32 map
    # is computed in float64, where the product is exact, and rounded once
    wide = (f - 1.0).double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, wide.to(dtype))


def gumbel(key: torch.Tensor, shape,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ("low") mode."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform(key, shape, dtype, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    first index of the largest logit plus Gumbel noise, int64."""
    noise = gumbel(key, logits.shape, logits.dtype)
    return torch.argmax(noise + logits, dim=-1)


def serve_key(pos: torch.Tensor) -> torch.Tensor:
    """The sampled serve step's key, ``fold_in(PRNGKey(0), pos[0])``, from
    the cache's positions after the step (on their device, no host
    read)."""
    return fold_in(prng_key(0, pos.device), pos[0])
