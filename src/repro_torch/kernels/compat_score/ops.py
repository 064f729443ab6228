"""Wrappers of the compatibility-score kernels (``csrc/compat_score.cu``).

``compat_score`` is the hw+load score (the micro ``pallas`` route's
matrix), ``fused_score`` adds the warm bonus (the ``jax`` route with
``fused=True``); both take an optional locality operand.  CUDA tensors
launch the kernel, CPU tensors run the plain version in ``ref.py``; there
is no fallback between the two.  ``compat_score.launches`` and
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
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compat_score.ref import (W_HW, W_LOAD, W_LOC,
                                                  W_WARM, compat_score_ref,
                                                  fused_score_ref)

SOURCE = _build.KernelSource(
    "compat_score",
    pathlib.Path(__file__).resolve().parent / "csrc" / "compat_score.cu",
    extra_flags=("-fmad=false",))


@functools.cache
def _lib():
    """The launcher and the model-id limit, bound once per process."""
    lib = _build.load(SOURCE)
    fn = lib.compat_score_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 5 + [i32, ptr, i32, i32] + [f32] * 4 + [ptr]
    fn.restype = ctypes.c_int
    lib.compat_score_max_models.restype = ctypes.c_int
    return fn, lib.compat_score_max_models()


def _launch(name: str, task_feats, server_feats, locality, task_mids,
            server_models) -> torch.Tensor:
    """Check the operands and launch the kernel (compat when ``task_mids``
    is None, fused otherwise)."""
    dev = task_feats.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    n, s = task_feats.shape[0], server_feats.shape[0]
    m = 0 if server_models is None else server_models.shape[1]
    want = {"task_feats": (n, 8), "server_feats": (s, 8),
            "locality": (n, s), "task_mids": (n,), "server_models": (s, m)}
    given = {"task_feats": task_feats, "server_feats": server_feats,
             "locality": locality, "task_mids": task_mids,
             "server_models": server_models}
    for key, t in given.items():
        if t is None:
            continue
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != want[key]):
            raise ValueError(
                f"{name}: {key} must be float32 {want[key]} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    launch, max_models = _lib()
    if server_models is not None and not 1 <= m <= max_models:
        raise ValueError(f"{name}: {m} model ids per server, the kernel "
                         f"takes 1 to {max_models}")
    given = {k: None if t is None else t.contiguous()
             for k, t in given.items()}
    out = torch.empty((n, s), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = launch(ptr(given["task_feats"]), ptr(given["server_feats"]),
                 ptr(given["locality"]), ptr(given["task_mids"]),
                 ptr(given["server_models"]), m, out.data_ptr(), n, s,
                 W_HW, W_LOAD, W_LOC, W_WARM,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def compat_score(task_feats: torch.Tensor, server_feats: torch.Tensor,
                 locality: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 8) x (S, 8) [x (N, S)] float32 -> (N, S) float32 hw+load
    [+ locality] scores."""
    if task_feats.device.type == "cpu":
        return compat_score_ref(task_feats, server_feats, locality)
    out = _launch("compat_score", task_feats, server_feats, locality, None,
                  None)
    compat_score.launches += 1
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
    fused_score.launches += 1
    return out


def score_matrix(task_feats: torch.Tensor, server_feats: torch.Tensor,
                 locality: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The micro layer's hw+load(+locality) matrix through
    :func:`compat_score` (``locality=None`` allocates no zeros operand)."""
    return compat_score(task_feats, server_feats, locality)


compat_score.launches = 0
fused_score.launches = 0
