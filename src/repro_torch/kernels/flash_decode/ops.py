"""Wrapper of the decode attention kernel (``csrc/flash_decode.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
plain version in ``ref.py``.  There is no fallback between the two.
``flash_decode.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

SOURCE = _build.KernelSource(
    "flash_decode",
    pathlib.Path(__file__).resolve().parent / "csrc" / "flash_decode.cu")
HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    """The launcher, bound once per process."""
    fn = _build.load(SOURCE).flash_decode_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i32] * 5 + [ctypes.c_float, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """q: (B, KH, G, hd); caches: (B, C, KH, hd); valid: (B, C) int32 ->
    (B, KH, G, hd) in q's type (float32 or bfloat16)."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    b, kh, g, hd = q.shape
    c = k_cache.shape[1]
    if (k_cache.shape != (b, c, kh, hd) or v_cache.shape != (b, c, kh, hd)
            or valid.shape != (b, c)):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} {tuple(v_cache.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: hd={hd}, the kernel takes "
                         f"{HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_decode: dtype {q.dtype}, the kernel takes "
                         f"{list(DTYPES)}")
    for name, t, dtype in (("k_cache", k_cache, q.dtype),
                           ("v_cache", v_cache, q.dtype),
                           ("valid", valid, torch.int32)):
        if t.dtype != dtype or t.device != q.device:
            raise ValueError(f"flash_decode: {name} must be {dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    q, k_cache, v_cache, valid = (t.contiguous()
                                  for t in (q, k_cache, v_cache, valid))
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 valid.data_ptr(), out.data_ptr(), b, kh, g, c, hd,
                 hd ** -0.5, DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError "
                           f"{err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     cache_positions: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention against a (possibly rotating) cache.

    q: (B, 1, H, hd); caches: (B, C, KH, hd); pos: (B,); cache_positions:
    (B, C) absolute position held by each slot (-1 = empty).  Attends to
    slots with 0 <= cache_pos <= pos."""
    b, _, h, hd = q.shape
    kh = k_cache.shape[2]
    valid = ((cache_positions >= 0)
             & (cache_positions <= pos[:, None])).to(torch.int32)
    o = flash_decode(q.reshape(b, kh, h // kh, hd), k_cache, v_cache, valid)
    return o.reshape(b, 1, h, hd)
