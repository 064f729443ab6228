"""Wrappers of the compatibility-score kernels (``csrc/compat_score.cu``).

``compat_score`` is the hw+load score (the micro ``pallas`` route's
matrix), ``fused_score`` adds the warm bonus (the ``jax`` route with
``fused=True``); both take an optional locality operand.  CUDA tensors
launch the kernel, CPU tensors run the plain version in ``ref.py``; there
is no fallback between the two.  ``launch_plan`` picks the launch from
the shape, so the CPU tests pin it; ``run_plan`` launches a given plan
(the on-card sweep).  ``compat_score.launches`` and
``fused_score.launches`` count kernel launches.

Feature rows (shared with ``core.micro.task_feature_arrays`` /
``server_feature_matrix``):

  task rows   (N, 8): [demand_tflops, mem_gb, kind one-hot x3, 0, 0, 0]
  server rows (S, 8): [tflops, mem_gb, kind one-hot x3, util, queue_norm,
                       load_cap]
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.compat_score.ref import (W_HW, W_LOAD, W_LOC,
                                                  W_WARM, compat_score_ref,
                                                  fused_score_ref)

SOURCE = _build.KernelSource(
    "compat_score",
    pathlib.Path(__file__).resolve().parent / "csrc" / "compat_score.cu",
    extra_flags=("-fmad=false",))
TARGET_WARPS = 32 * _build.CARD_SMS   # the grid's warps: 32 an SM, one wave
MAX_THREADS = 128              # a block's threads, 4 columns each
QUAD = 4                       # columns a thread owns
MAX_MODELS = 64                # model ids a server, current + warm cache
MAX_ROWS = 64                  # rows a block walks, staged in shared memory
ROWS = (16, 32)                # the plan's rows a block, least and most
STORES = ("scalar", "vector")


class ScorePlan(NamedTuple):
    """A launch of the score kernel: blocks of ``threads`` threads, each
    owning 4 columns of a strip of 4 x ``threads`` columns (``strips``
    strips, grid x) and walking a run of ``rows`` rows (``groups`` runs,
    grid y; past 65,535 a block takes every 65,535th run).  ``store``:
    "vector" (16-byte stores, S % 4 == 0) or "scalar" (a thread's columns
    a quarter strip apart)."""

    threads: int
    strips: int
    rows: int
    groups: int
    store: str


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, s: int, m: int = 0, loc: bool = False, *,
                rows: Optional[int] = None) -> ScorePlan:
    """The launch for an (N, S) score matrix with ``m`` model ids a server
    (0: compat_score) [and the locality operand]: 128 threads a block,
    fewer where S needs fewer columns; 16-byte stores where S % 4 == 0,
    else scalar stores; runs of rows that give the grid about
    ``TARGET_WARPS`` warps, within ``ROWS`` (a block's prologue, the
    column values and their exps, costs a few rows' work, so small shapes
    take fewer blocks), at most ``ROWS[0]`` with the locality operand
    (more blocks keep more of its stream in flight).  The kernel keeps up
    to 8 model ids a column in registers and reads more from the cache.
    ``rows`` forces the run's length (the on-card sweep)."""
    if n < 1 or s < 1:
        raise ValueError(f"score kernels: N={n}, S={s}, need both >= 1")
    if not 0 <= m <= MAX_MODELS:
        raise ValueError(f"score kernels: {m} model ids per server, the "
                         f"kernel takes 1 to {MAX_MODELS}")
    threads = min(MAX_THREADS, 32 * -(-s // (QUAD * 32)))
    strips = -(-s // (QUAD * threads))
    store = "scalar" if s % QUAD else "vector"
    if rows is None:
        blocks = TARGET_WARPS // (threads // 32)
        rows = min(max(-(-n // -(-blocks // strips)), ROWS[0]),
                   ROWS[0] if loc else ROWS[1], n)
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"score kernels: {rows} rows a block, the kernel "
                         f"takes 1 to {MAX_ROWS}")
    return ScorePlan(threads, strips, rows, -(-n // rows), store)


@functools.cache
def _lib():
    """The launcher, bound once per process."""
    lib = _build.load(SOURCE)
    fn = lib.compat_score_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 5 + [i32, ptr, i32, i32] + [f32] * 4 + [i32] * 3 \
        + [ptr]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` contiguous, its data 16-byte aligned (a copy otherwise)."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, task_feats, server_feats, locality, task_mids,
            server_models, plan: Optional[ScorePlan] = None) -> torch.Tensor:
    """Check the operands and launch the kernel with ``plan``, by default
    ``launch_plan``'s (compat when ``task_mids`` is None, fused
    otherwise); an empty matrix launches nothing."""
    dev = task_feats.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    refuse_grad(name, (task_feats, server_feats, locality, task_mids,
                       server_models),
                "the scores rank servers for a scheduler's decision; "
                "nothing differentiates through them")
    n, s = task_feats.shape[0], server_feats.shape[0]
    m = 0 if server_models is None else server_models.shape[1]
    given = {"task_feats": (task_feats, (n, 8)),
             "server_feats": (server_feats, (s, 8)),
             "locality": (locality, (n, s)), "task_mids": (task_mids, (n,)),
             "server_models": (server_models, (s, m))}
    for key, (t, want) in given.items():
        if t is not None and (t.dtype != torch.float32 or t.device != dev
                              or tuple(t.shape) != want):
            raise ValueError(
                f"{name}: {key} must be float32 {want} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if server_models is not None and m < 1:
        raise ValueError(f"{name}: server_models has no model id column")
    out = torch.empty((n, s), dtype=torch.float32, device=dev)
    if n == 0 or s == 0:
        return out
    plan = plan or launch_plan(n, s, m, locality is not None)
    operands = [_aligned(t) for t, _ in given.values()]
    err = _lib()(*(None if t is None else t.data_ptr() for t in operands),
                 m, out.data_ptr(), n, s, W_HW, W_LOAD, W_LOC, W_WARM,
                 plan.threads, plan.rows, STORES.index(plan.store),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed ({plan}): "
                           f"cudaError {err}")
    return out


def run_plan(plan: ScorePlan, task_feats: torch.Tensor,
             server_feats: torch.Tensor, locality=None, task_mids=None,
             server_models=None) -> torch.Tensor:
    """Launch the kernel on CUDA operands with the given plan (the fused
    score when ``task_mids`` and ``server_models`` are given); counts no
    launch."""
    if (task_mids is None) != (server_models is None):
        raise ValueError("score run_plan: task_mids and server_models go "
                         "together")
    return _launch("score run_plan", task_feats, server_feats, locality,
                   task_mids, server_models, plan)


def compat_score(task_feats: torch.Tensor, server_feats: torch.Tensor,
                 locality: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 8) x (S, 8) [x (N, S)] float32 -> (N, S) float32 hw+load
    [+ locality] scores."""
    if task_feats.device.type == "cpu":
        return compat_score_ref(task_feats, server_feats, locality)
    out = _launch("compat_score", task_feats, server_feats, locality, None,
                  None)
    compat_score.launches += out.numel() > 0
    return out


def fused_score(task_feats: torch.Tensor, server_feats: torch.Tensor,
                task_mids: torch.Tensor, server_models: torch.Tensor,
                locality: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 8) x (S, 8) x (N,) x (S, 1+W) [x (N, S)] float32 -> (N, S)
    float32 hw+load+warm [+ locality] scores.  Model ids are float-encoded
    (exact below 2**24); -1 (no model) never equals a task's id."""
    if task_feats.device.type == "cpu":
        return fused_score_ref(task_feats, server_feats, task_mids,
                               server_models, locality)
    if task_mids is None or server_models is None:
        raise ValueError("fused_score: task_mids and server_models are "
                         "required")
    out = _launch("fused_score", task_feats, server_feats, locality,
                  task_mids, server_models)
    fused_score.launches += out.numel() > 0
    return out


def score_matrix(task_feats: torch.Tensor, server_feats: torch.Tensor,
                 locality: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The micro layer's hw+load(+locality) matrix through
    :func:`compat_score` (``locality=None`` allocates no zeros operand)."""
    return compat_score(task_feats, server_feats, locality)


compat_score.launches = 0
fused_score.launches = 0
