"""Wrapper of the selective-scan kernel (``csrc/selective_scan.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
plain version in ``ref.py``.  There is no fallback between the two.
``selective_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

SOURCE = _build.KernelSource(
    "selective_scan",
    pathlib.Path(__file__).resolve().parent / "csrc" / "selective_scan.cu")
STATE_DIMS = (4, 8, 16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    """The launcher, bound once per process."""
    fn = _build.load(SOURCE).selective_scan_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def selective_scan(dt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                   x: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (B, S, D); bm, cm: (B, S, N), all float32 or all bfloat16;
    a: (D, N); d_skip: (D,) -> (y (B, S, D) in x's type, last state
    (B, D, N) float32).  ``a`` and ``d_skip`` are read as float32."""
    if x.device.type == "cpu":
        return selective_scan_ref(dt, bm, cm, x, a, d_skip)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    b, s, d = x.shape
    n = a.shape[-1]
    want = {"dt": (b, s, d), "bm": (b, s, n), "cm": (b, s, n),
            "a": (d, n), "d_skip": (d,)}
    given = {"dt": dt, "bm": bm, "cm": cm, "a": a, "d_skip": d_skip}
    for name, t in given.items():
        if tuple(t.shape) != want[name] or t.device != x.device:
            raise ValueError(f"selective_scan: {name} must be {want[name]} "
                             f"on {x.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    for name in ("dt", "bm", "cm"):
        if given[name].dtype != x.dtype:
            raise ValueError(f"selective_scan: {name} is {given[name].dtype}"
                             f", x is {x.dtype}")
    if x.dtype not in DTYPES or n not in STATE_DIMS or s < 1:
        raise ValueError(f"selective_scan: dtype {x.dtype}, N={n}, S={s}; "
                         f"the kernel takes {list(DTYPES)}, N in "
                         f"{STATE_DIMS}, S >= 1")
    dt, bm, cm, x = (t.contiguous() for t in (dt, bm, cm, x))
    a, d_skip = (t.to(torch.float32).contiguous() for t in (a, d_skip))
    y = torch.empty_like(x)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    err = _lib()(dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
                 a.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), b, s, d, n, DTYPES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: cudaError "
                           f"{err}")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
