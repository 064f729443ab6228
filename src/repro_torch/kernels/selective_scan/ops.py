"""Wrapper of the selective-scan kernel (``csrc/selective_scan.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
plain version in ``ref.py``.  There is no fallback between the two.
``scan_plan`` lays the scan over the card (lanes a channel, channels a
block, steps a stage, stages in the ring) so the CPU tests pin it.
``selective_scan.launches`` counts calls that launch the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

SOURCE = _build.KernelSource(
    "selective_scan",
    pathlib.Path(__file__).resolve().parent / "csrc" / "selective_scan.cu")
STATE_DIMS = (4, 8, 16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)
THREADS = 128                 # threads a block (kThreads in the source)
MAX_STAGES = 5
# the plan (set from the on-card sweep, PERF.md §6): lanes a channel (the
# build's SCAN_LANES), steps a stage, stages in flight
LANES = 4
STEPS = 64
STAGES = 3
SWEEP_LANES = (1, 2, 4, 8, 16)   # lane counts a build may be made for


def lanes_source(lanes: int) -> _build.KernelSource:
    """The kernel built for ``lanes`` lanes a channel (the lane sweep;
    ``SOURCE`` is built for ``LANES``)."""
    if lanes == LANES:
        return SOURCE
    return dataclasses.replace(
        SOURCE, name=f"selective_scan_lanes{lanes}",
        extra_flags=SOURCE.extra_flags + (f"-DSCAN_LANES={lanes}",))


class ScanPlan(NamedTuple):
    """How one launch lays (B, S, D, N) over the card.  Block (x, b) owns
    channels ``[x * channels, (x + 1) * channels)`` (cut at D) of batch
    row b and walks all S steps; thread t of it owns channel
    ``t // lanes`` and states ``[(t % lanes) * N / lanes, (t % lanes + 1)
    * N / lanes)``.  It walks the steps in stages of ``steps``,
    ``stages`` of them in flight; each block uses ``smem`` bytes of
    dynamic shared memory."""

    lanes: int
    channels: int
    steps: int
    stages: int
    smem: int

    @property
    def threads(self) -> int:
        return self.lanes * self.channels

    def grid(self, b: int, d: int) -> Tuple[int, int]:
        """Blocks along channels and batch rows."""
        return -(-d // self.channels), b

    def channel_range(self, x: int, d: int) -> Tuple[int, int]:
        """Block (x, .)'s channels."""
        return x * self.channels, min((x + 1) * self.channels, d)

    def thread(self, t: int, n: int) -> Tuple[int, Tuple[int, int]]:
        """Thread t's channel in its block and its state range."""
        per = n // self.lanes
        j = t % self.lanes
        return t // self.lanes, (j * per, (j + 1) * per)


def _elt(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def group_steps(states: int) -> int:
    """Steps a lane computes from one register set at ``states`` states a
    lane (``group_steps`` in the source)."""
    return 1 if states >= 16 else 16 // states


def smem_bytes(n: int, dtype: torch.dtype, lanes: int, steps: int,
               stages: int) -> int:
    """Dynamic shared memory of one block: ``stages`` buffers, each the
    stage's dt and x rows of the block's ``THREADS / lanes`` channels and
    its Bm and Cm rows, in the input type."""
    e, channels = _elt(dtype), THREADS // lanes
    return stages * (2 * steps * channels * e + 2 * steps * n * e)


def scan_plan(n: int, dtype: torch.dtype, *, lanes: int = LANES,
              steps: int = STEPS, stages: int = STAGES) -> ScanPlan:
    """The launch plan for N states in ``dtype``: blocks of ``THREADS``
    threads, ``THREADS / lanes`` channels, ``LANES`` lanes a channel,
    stages of ``STEPS`` steps, ``STAGES`` in flight.  Keywords force a
    knob (the on-card sweep; lanes other than ``LANES`` need the build
    ``lanes_source`` gives).  Raises on a plan the kernel cannot run."""
    if n not in STATE_DIMS:
        raise ValueError(f"selective_scan: N={n}, the kernel takes "
                         f"{STATE_DIMS}")
    if lanes not in SWEEP_LANES or n % lanes:
        raise ValueError(f"selective_scan: {lanes} lanes a channel cannot "
                         f"split N={n} (lanes in {SWEEP_LANES}, dividing "
                         f"N)")
    group = group_steps(n // lanes)
    if steps < 1 or steps % (2 * group):
        raise ValueError(f"selective_scan: {steps} steps a stage (a "
                         f"multiple of two groups of {group} steps)")
    if not 2 <= stages <= MAX_STAGES:
        raise ValueError(f"selective_scan: {stages} stages, the ring takes "
                         f"2-{MAX_STAGES}")
    smem = smem_bytes(n, dtype, lanes, steps, stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"selective_scan: {smem} B of shared memory a "
                         f"block, the card allows {SMEM_LIMIT}")
    return ScanPlan(lanes, THREADS // lanes, steps, stages, smem)


def granule(nbytes_row: int, *tensors: torch.Tensor) -> int:
    """The largest piece (16, 8 or 4 bytes) the kernel may move a staged
    row in: it must divide the row's bytes and every tensor's address;
    else 2 (bfloat16 moved one at a time by plain loads)."""
    for g in (16, 8, 4):
        if nbytes_row % g == 0 and all(t.data_ptr() % g == 0
                                       for t in tensors):
            return g
    return 2


@functools.cache
def _lib(source: _build.KernelSource = SOURCE):
    """The launcher and the plan queries, bound once per process."""
    lib = _build.load(source)
    fn = lib.selective_scan_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32] * 10 + [ptr]
    fn.restype = ctypes.c_int
    smem = lib.selective_scan_smem_bytes
    smem.argtypes = [i32] * 5
    smem.restype = i32
    lib.selective_scan_lanes.restype = i32
    return fn, smem, lib.selective_scan_lanes()


def _check(dt, bm, cm, x, a, d_skip) -> None:
    """Raise on any operand the kernel does not take."""
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
    refuse_grad("selective_scan", (dt, bm, cm, x, a, d_skip),
                "the scan's backward, d dt, dB, dC, dx, dA and dD, is the "
                "next slice of the port: Mamba layers do not train on the "
                "card yet")
    _check(dt, bm, cm, x, a, d_skip)
    return _run(dt, bm, cm, x, a, d_skip, scan_plan(a.shape[-1], x.dtype))


def run_plan(dt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
             x: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
             plan: ScanPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA operands with the given plan (the on-card
    sweep forces knobs), from the build for the plan's lanes."""
    _check(dt, bm, cm, x, a, d_skip)
    return _run(dt, bm, cm, x, a, d_skip, plan, lanes_source(plan.lanes))


def _run(dt, bm, cm, x, a, d_skip, plan: ScanPlan,
         source: _build.KernelSource = SOURCE):
    b, s, d = x.shape
    n = a.shape[-1]
    launch, smem_of, lanes = _lib(source)
    code = DTYPES[x.dtype]
    if (lanes != plan.lanes
            or smem_of(n, code, plan.lanes, plan.steps, plan.stages)
            != plan.smem):
        raise RuntimeError(f"selective_scan: {plan} disagrees with the "
                           f"build {source.name} ({lanes} lanes a channel)")
    dt, bm, cm, x = (t.contiguous() for t in (dt, bm, cm, x))
    a, d_skip = (t.to(torch.float32).contiguous() for t in (a, d_skip))
    y = torch.empty_like(x)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    e = _elt(x.dtype)
    gran_dx = granule(d * e, dt, x)
    gran_bc = granule(n * e, bm, cm)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
                 a.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), b, s, d, n, code, plan.lanes, plan.steps,
                 plan.stages, gran_dx, gran_bc, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"cudaError {err}")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
