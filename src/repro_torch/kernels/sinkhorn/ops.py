"""Wrapper of the Sinkhorn kernel (``csrc/sinkhorn.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
plain version in ``ref.py``.  There is no fallback between the two.
``launch_plan`` lays one problem over a block (warps, shared bytes,
where the tile lives), so the CPU tests pin it.
``sinkhorn_plan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref

SOURCE = _build.KernelSource(
    "sinkhorn", pathlib.Path(__file__).resolve().parent / "csrc" / "sinkhorn.cu")
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)
MAX_WARPS = 32


class SinkhornPlan(NamedTuple):
    """One block a problem: ``threads`` threads (a warp a row while R <=
    32, else 32 warps taking rows and columns in turn), ``smem`` bytes of
    dynamic shared memory, and the -cost/reg tile in shared memory
    (``shared``) or read from device memory."""

    threads: int
    smem: int
    shared: bool


def tile_ld(r: int) -> int:
    """Row stride of the shared tile: the least odd number above R (the
    kernel's ``tile_ld``)."""
    return (r + 1) | 1


def smem_bytes(r: int, shared: bool) -> int:
    """f, g, f/reg and g/reg, plus the padded tile when ``shared``."""
    return 4 * (4 * r + (r * tile_ld(r) if shared else 0))


def launch_plan(r: int) -> SinkhornPlan:
    """The launch for R regions: min(R, 32) warps; the tile in shared
    memory while it fits ``SMEM_LIMIT`` (R <= 238), else in device
    memory."""
    if r < 1:
        raise ValueError(f"sinkhorn_plan: R={r}, need R >= 1")
    shared = smem_bytes(r, True) <= SMEM_LIMIT
    return SinkhornPlan(32 * min(r, MAX_WARPS), smem_bytes(r, shared), shared)


@functools.cache
def _lib():
    """The launcher, bound once per process."""
    fn = _build.load(SOURCE).sinkhorn_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 4 + [i32] * 3 + [ctypes.c_float] + [i32] * 3 + [ptr]
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
    for name, t in (("mu", mu), ("nu", nu), ("cost", cost)):
        if t.dtype != torch.float32 or t.device != mu.device:
            raise ValueError(f"sinkhorn_plan: {name} must be float32 on "
                             f"{mu.device}, got {t.dtype} on {t.device}")
    plan = launch_plan(r)
    mu, nu, cost = (t.contiguous() for t in (mu, nu, cost))
    out = torch.empty((b, r, r), dtype=torch.float32, device=mu.device)
    err = _lib()(mu.data_ptr(), nu.data_ptr(), cost.data_ptr(),
                 out.data_ptr(), b, r, n_iters, float(reg), plan.threads,
                 plan.smem, int(plan.shared),
                 torch.cuda.current_stream(mu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn kernel launch failed: cudaError {err}")
    sinkhorn_plan.launches += 1
    return out


sinkhorn_plan.launches = 0
