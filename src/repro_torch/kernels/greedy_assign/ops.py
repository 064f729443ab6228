"""Wrapper of the multi-region greedy kernel (``csrc/greedy_assign.cu``).

``GreedyInputs`` is the full operand set of one slot's greedy, built once
by ``core/micro_torch.assign_scan_all``; the kernel and the plain
version (``ref.py``) take the very same tensors, so the pre-scan values
(load, demand, note norms, speed, the decay table) are computed once, in
that wrapper, for both.  A CUDA operand set launches the kernel; a CPU
one runs the plain version.  ``greedy_assign.launches`` counts kernel
launches.  An optional ``static`` operand selects the kernel's static
variant (the per-region route with the fused score kernel).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.micro_state import EMPTY
from repro_torch.kernels import _build
from repro_torch.kernels.greedy_assign.ref import greedy_assign_ref

SOURCE = _build.KernelSource(
    "greedy_assign",
    pathlib.Path(__file__).resolve().parent / "csrc" / "greedy_assign.cu",
    extra_flags=("-fmad=false",))
KEEP = 4                      # ring depth the kernel is compiled for
MAX_AGE = 40                  # Eq-10 age clip (decay table has 41 entries)
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)


class ScoreConsts(NamedTuple):
    """The Eq 7-10 weights and switch costs the score needs."""

    w_hw: float
    w_load: float
    w_loc: float
    w_warm: float
    w_model: float
    w_embed: float
    warm_hit_s: float
    model_switch_s: float


@dataclasses.dataclass
class GreedyInputs:
    """One slot's greedy operands.  R regions, S_pad servers and N_pad
    tasks per region, K ring entries of width E, W warm slots."""

    # server operands (R, S_pad)
    tflops: torch.Tensor        # float64
    mem_s: torch.Tensor         # float64
    kind_s: torch.Tensor        # int32
    load: torch.Tensor          # float64 exp(-(util + queue/slot_s))
    cur_model: torch.Tensor     # int32
    warm_srv: torch.Tensor      # (R, S_pad, W) int32
    switch_scale: torch.Tensor  # float64
    active: torch.Tensor        # bool (padding servers are inactive)
    speed: torch.Tensor         # float64 max(tflops/112, 0.1)
    proj0: torch.Tensor         # float64 projected queue seconds
    # locality rings (R, S_pad, K[, E]), newest entry first
    l_mids: torch.Tensor        # int32
    l_slots: torch.Tensor       # int32
    l_emb: torch.Tensor         # (R, S_pad, K, E) float32
    l_nrm: torch.Tensor         # float32
    # task operands (R, N_pad), each region's rows in greedy order
    t_mids: torch.Tensor        # int32
    t_kinds: torch.Tensor       # int32
    t_mem: torch.Tensor         # float64
    t_work: torch.Tensor        # float64
    t_demand: torch.Tensor      # float64 tflops demand of the task's kind
    t_emb: torch.Tensor         # (R, N_pad, E) float32
    t_norms: torch.Tensor       # float32 axis norms (Eq-10 denominator)
    t_note: torch.Tensor        # float32 per-row norms stored in the ring
    t_has: torch.Tensor         # bool
    n_real: torch.Tensor        # (R,) int64 tasks per region
    decay: torch.Tensor         # (MAX_AGE + 1,) float64 exp(LOC_DECAY*age)
    t: int                      # slot index (ring timestamp)
    slot_s: float
    consts: ScoreConsts
    # (R, N_pad, S_pad) float64 Eq 7-9 score with the warm bonus; when
    # given, a server scores (static + w_loc * loc) + 0.0 instead
    static: Optional[torch.Tensor] = None


Rings = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@functools.cache
def _lib():
    """The launcher and the shared-memory size query, bound once per
    process (the build, the source digest and the ctypes signatures stay
    off the per-slot path)."""
    lib = _build.load(SOURCE)
    fn = lib.greedy_assign_launch
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = ([i32] * 8 + [f64] + [ptr] * 26 + [f64] * 8
                   + [ptr, ptr])
    fn.restype = ctypes.c_int
    smem = lib.greedy_assign_smem_bytes
    smem.argtypes = [i32, i32]
    smem.restype = ctypes.c_size_t
    return fn, smem


_DTYPES = {
    "tflops": torch.float64, "mem_s": torch.float64, "kind_s": torch.int32,
    "load": torch.float64, "cur_model": torch.int32,
    "warm_srv": torch.int32, "switch_scale": torch.float64,
    "active": torch.bool, "speed": torch.float64, "proj0": torch.float64,
    "l_mids": torch.int32, "l_slots": torch.int32, "l_emb": torch.float32,
    "l_nrm": torch.float32, "t_mids": torch.int32, "t_kinds": torch.int32,
    "t_mem": torch.float64, "t_work": torch.float64,
    "t_demand": torch.float64, "t_emb": torch.float32,
    "t_norms": torch.float32, "t_note": torch.float32, "t_has": torch.bool,
    "n_real": torch.int64, "decay": torch.float64,
}


def _check(x: GreedyInputs) -> None:
    """Raise on any operand the kernel does not take."""
    r, s_pad, keep = x.l_mids.shape
    n_pad = x.t_mids.shape[1]
    e = x.l_emb.shape[3]
    want = {"l_emb": (r, s_pad, keep, e), "t_emb": (r, n_pad, e),
            "warm_srv": (r, s_pad, x.warm_srv.shape[2]),
            "n_real": (r,), "decay": (MAX_AGE + 1,)}
    dev = x.t_mids.device
    for name, dtype in _DTYPES.items():
        t = getattr(x, name)
        shape = want.get(name, (r, s_pad, keep) if name.startswith("l_")
                         else (r, n_pad) if name.startswith("t_")
                         else (r, s_pad))
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(
                f"greedy_assign: {name} must be {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if keep != KEEP:
        raise ValueError(f"greedy_assign: ring depth {keep}, kernel is "
                         f"built for {KEEP}")
    st = x.static
    if st is not None and (st.dtype != torch.float64 or st.device != dev
                           or tuple(st.shape) != (r, n_pad, s_pad)):
        raise ValueError(
            f"greedy_assign: static must be {torch.float64} "
            f"{(r, n_pad, s_pad)} on {dev}, got {st.dtype} "
            f"{tuple(st.shape)} on {st.device}")


def greedy_assign(x: GreedyInputs) -> Tuple[torch.Tensor, Rings]:
    """Run the slot's greedy.  Returns ``out`` (R, N_pad) int32 (server in
    region, -1 = buffer) and the updated rings (new tensors; the inputs
    are not modified)."""
    dev = x.t_mids.device
    if dev.type == "cpu":
        return greedy_assign_ref(x)
    if dev.type != "cuda":
        raise ValueError(f"greedy_assign: unsupported device {dev}")
    _check(x)
    launch, smem_bytes = _lib()
    r, s_pad, _ = x.l_mids.shape
    n_pad = x.t_mids.shape[1]
    e = x.l_emb.shape[3]
    if smem_bytes(s_pad, e) > SMEM_LIMIT:
        raise ValueError(
            f"greedy_assign: {s_pad} servers x embed width {e} need "
            f"{smem_bytes(s_pad, e)} B of shared memory per region, over "
            f"the {SMEM_LIMIT} B a block may use")
    x = dataclasses.replace(x, **{
        name: getattr(x, name).contiguous() for name in _DTYPES},
        static=None if x.static is None else x.static.contiguous())
    rings = tuple(a.clone() for a in (x.l_mids, x.l_slots, x.l_emb, x.l_nrm))
    out = torch.empty((r, n_pad), dtype=torch.int32, device=dev)
    c = x.consts
    err = launch(
        r, s_pad, n_pad, e, x.warm_srv.shape[2], int(x.t), EMPTY, MAX_AGE,
        float(x.slot_s),
        x.tflops.data_ptr(), x.mem_s.data_ptr(), x.kind_s.data_ptr(),
        x.load.data_ptr(), x.cur_model.data_ptr(), x.warm_srv.data_ptr(),
        x.switch_scale.data_ptr(), x.active.data_ptr(), x.speed.data_ptr(),
        x.proj0.data_ptr(), *(a.data_ptr() for a in rings),
        x.t_mids.data_ptr(), x.t_kinds.data_ptr(), x.t_mem.data_ptr(),
        x.t_work.data_ptr(), x.t_demand.data_ptr(), x.t_emb.data_ptr(),
        x.t_norms.data_ptr(), x.t_note.data_ptr(), x.t_has.data_ptr(),
        x.n_real.data_ptr(), x.decay.data_ptr(),
        None if x.static is None else x.static.data_ptr(),
        *(float(v) for v in c),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"greedy_assign kernel launch failed: cudaError {err}")
    greedy_assign.launches += 1
    return out, rings


greedy_assign.launches = 0
