"""Wrapper of the prefill attention kernel (``csrc/flash_prefill.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
plain version in ``ref.py``.  There is no fallback between the two.
``flash_prefill.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

SOURCE = _build.KernelSource(
    "flash_prefill",
    pathlib.Path(__file__).resolve().parent / "csrc" / "flash_prefill.cu")
HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    """The launcher, bound once per process."""
    fn = _build.load(SOURCE).flash_prefill_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 4 + [i32] * 6 + [ctypes.c_float, i32]
                   + [i64] * 14 + [ptr])
    fn.restype = ctypes.c_int
    return fn


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window=None) -> torch.Tensor:
    """q: (B, KH, G, S, hd); k, v: (B, KH, S, hd) -> (B, KH, G, S, hd),
    float32 or bfloat16.  Causal self-attention with an optional sliding
    window.  Views with hd contiguous launch without a copy (permuted
    views of (B, S, H, hd) included); the output has q's strides."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    b, kh, g, s, hd = q.shape
    if k.shape != (b, kh, s, hd) or v.shape != (b, kh, s, hd):
        raise ValueError(f"flash_prefill: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: hd={hd}, the kernel takes "
                         f"{HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_prefill: window={window} must be >= 1")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_prefill: {name} must be {q.dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_prefill: dtype {q.dtype}, the kernel takes "
                         f"{list(DTYPES)}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, kh, g, s, hd, window or 0, hd ** -0.5, DTYPES[q.dtype],
                 *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:4],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: cudaError "
                           f"{err}")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window=None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KH, hd) -> (B, S, H, hd), causal;
    head h is (h // G, h % G).  Permuted views in, no copies."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qr = q.reshape(b, s, kh, h // kh, hd).permute(0, 2, 3, 1, 4)
    o = flash_prefill(qr, k.transpose(1, 2), v.transpose(1, 2),
                      window=window)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
