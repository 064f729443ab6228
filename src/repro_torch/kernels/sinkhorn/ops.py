"""Wrapper of the Sinkhorn kernel (``csrc/sinkhorn.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
plain version in ``ref.py``.  There is no fallback between the two.
``sinkhorn_plan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref

SOURCE = _build.KernelSource(
    "sinkhorn", pathlib.Path(__file__).resolve().parent / "csrc" / "sinkhorn.cu")
MAX_R = 32


@functools.cache
def _lib():
    """The launcher, bound once per process."""
    lib = _build.load(SOURCE)
    fn = lib.sinkhorn_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sinkhorn_plan(mu: torch.Tensor, nu: torch.Tensor, cost: torch.Tensor, *,
                  reg: float = 0.05, n_iters: int = 100) -> torch.Tensor:
    """(B, R) x (B, R) x (B, R, R) float32 -> (B, R, R) transport plans."""
    if mu.device.type == "cpu":
        return sinkhorn_ref(mu, nu, cost, reg=reg, n_iters=n_iters)
    if mu.device.type != "cuda":
        raise ValueError(f"sinkhorn_plan: unsupported device {mu.device}")
    b, r = mu.shape
    if nu.shape != (b, r) or cost.shape != (b, r, r):
        raise ValueError(f"sinkhorn_plan: shapes mu {tuple(mu.shape)}, nu "
                         f"{tuple(nu.shape)}, cost {tuple(cost.shape)}")
    if not 1 <= r <= MAX_R:
        raise ValueError(f"sinkhorn_plan: R={r} outside [1, {MAX_R}]")
    for name, t in (("mu", mu), ("nu", nu), ("cost", cost)):
        if t.dtype != torch.float32 or t.device != mu.device:
            raise ValueError(f"sinkhorn_plan: {name} must be float32 on "
                             f"{mu.device}, got {t.dtype} on {t.device}")
    mu, nu, cost = (t.contiguous() for t in (mu, nu, cost))
    plan = torch.empty((b, r, r), dtype=torch.float32, device=mu.device)
    err = _lib()(mu.data_ptr(), nu.data_ptr(), cost.data_ptr(),
                 plan.data_ptr(), b, r, n_iters, float(reg),
                 torch.cuda.current_stream(mu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn kernel launch failed: cudaError {err}")
    sinkhorn_plan.launches += 1
    return plan


sinkhorn_plan.launches = 0
