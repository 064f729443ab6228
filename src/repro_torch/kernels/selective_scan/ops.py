"""Wrappers of the selective-scan kernels: the forward
(``csrc/selective_scan.cu``) and its gradient (``csrc/selective_scan_bwd.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
plain version in ``ref.py``.  There is no fallback between the two.
``scan_plan`` lays the scan over the card (lanes a channel, channels a
block, steps a stage, stages in the ring) and ``bwd_plan`` the backward
(lanes a channel, warps and channels a block, steps a chunk, shared
memory, workspace), so the CPU tests pin them.
``selective_scan.launches`` and ``selective_scan_bwd.launches`` count
calls that launch the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.selective_scan.ref import (STEPS,
                                                   selective_scan_bwd_ref,
                                                   selective_scan_ref)

SOURCE = _build.KernelSource(
    "selective_scan",
    pathlib.Path(__file__).resolve().parent / "csrc" / "selective_scan.cu")
# built with ptxas's report (registers, spills), which chip_smoke.py prints
BWD_SOURCE = _build.KernelSource(
    "selective_scan_bwd",
    pathlib.Path(__file__).resolve().parent / "csrc" / "selective_scan_bwd.cu",
    ("-Xptxas=-v",))
STATE_DIMS = (4, 8, 16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)
THREADS = 128                 # threads a block (kThreads in the source)
MAX_STAGES = 5
# the plan (set from the on-card sweep, PERF.md §6): lanes a channel (the
# build's SCAN_LANES), steps a stage, stages in flight.  Given ``states``
# the forward saves a state every ``STEPS`` (16, ref.py) steps, the
# backward's chunk; a stage is several chunks.
LANES = 4
STAGE_STEPS = 64
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
              steps: int = STAGE_STEPS, stages: int = STAGES) -> ScanPlan:
    """The launch plan for N states in ``dtype``: blocks of ``THREADS``
    threads, ``THREADS / lanes`` channels, ``LANES`` lanes a channel,
    stages of ``STAGE_STEPS`` steps, ``STAGES`` in flight.  Keywords
    force a knob (the on-card sweep; lanes other than ``LANES`` need the
    build ``lanes_source`` gives).  Raises on a plan the kernel cannot run."""
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
    fn.argtypes = [ptr] * 9 + [i32] * 11 + [ptr]
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
                   x: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor, *,
                   states: bool = False):
    """dt, x: (B, S, D); bm, cm: (B, S, N), all float32 or all bfloat16;
    a: (D, N); d_skip: (D,) -> (y (B, S, D) in x's type, last state
    (B, D, N) float32).  ``a`` and ``d_skip`` are read as float32.  Given
    ``states``, also the state each run of ``STEPS`` steps (a chunk)
    starts from, (B, ceil(S / STEPS), D, N) float32: the boundaries
    :func:`selective_scan_bwd` rebuilds the states from."""
    if x.device.type == "cpu":
        return selective_scan_ref(dt, bm, cm, x, a, d_skip, states=states)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    refuse_grad("selective_scan", (dt, bm, cm, x, a, d_skip),
                "its gradient is autograd.selective_scan_grad's, which "
                "mamba_forward takes under grad")
    _check(dt, bm, cm, x, a, d_skip)
    plan = scan_plan(a.shape[-1], x.dtype)
    return _run(dt, bm, cm, x, a, d_skip, plan, states=states)


def run_plan(dt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
             x: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
             plan: ScanPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA operands with the given plan (the on-card
    sweep forces knobs), from the build for the plan's lanes."""
    _check(dt, bm, cm, x, a, d_skip)
    return _run(dt, bm, cm, x, a, d_skip, plan, lanes_source(plan.lanes))


def _run(dt, bm, cm, x, a, d_skip, plan: ScanPlan,
         source: _build.KernelSource = SOURCE, states: bool = False):
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
    h_chunks = torch.empty((b, -(-s // STEPS), d, n),
                           dtype=torch.float32, device=x.device) \
        if states else None
    e = _elt(x.dtype)
    gran_dx = granule(d * e, dt, x)
    gran_bc = granule(n * e, bm, cm)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
                 a.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), h_chunks.data_ptr() if states else None,
                 b, s, d, n, STEPS, code, plan.lanes, plan.steps,
                 plan.stages, gran_dx, gran_bc, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"cudaError {err}")
    selective_scan.launches += 1
    return (y, h_last, h_chunks) if states else (y, h_last)


selective_scan.launches = 0


# ------------------------------------------------------------- backward

# the backward's plan (set from the on-card sweep, PERF.md §6): lanes a
# channel and warps a block (the build's BWD_LANES, BWD_WARPS); a chunk
# is ``STEPS`` steps, the forward's saving interval, and its ring holds
# two chunks (kStages in the source)
BWD_LANES = 4
BWD_WARPS = 8
BWD_RING = 2
BWD_MAX_STATES = 4          # states a lane: 2 x STEPS x 4 floats of registers
# (lanes, warps) builds the sweep makes
BWD_SWEEP = ((4, 4), (4, 8), (8, 4), (8, 8))


def bwd_source(lanes: int, warps: int) -> _build.KernelSource:
    """The backward built for ``lanes`` lanes a channel and ``warps``
    warps a block (``BWD_SOURCE`` is built for the kept pair)."""
    if (lanes, warps) == (BWD_LANES, BWD_WARPS):
        return BWD_SOURCE
    return dataclasses.replace(
        BWD_SOURCE, name=f"selective_scan_bwd_l{lanes}w{warps}",
        extra_flags=BWD_SOURCE.extra_flags + (f"-DBWD_LANES={lanes}",
                                              f"-DBWD_WARPS={warps}"))


class BwdPlan(NamedTuple):
    """How one backward launch lays (B, S, D, N) over the card.  Block
    (x, b) owns channels ``[x * channels, (x + 1) * channels)`` (cut at D)
    of batch row b; thread t of it channel ``t // lanes`` and states
    ``[(t % lanes) * N / lanes, (t % lanes + 1) * N / lanes)``.  It walks
    the ``ceil(S / steps)`` chunks of ``steps`` steps last first, the next
    one loading as it walks one, using ``smem`` bytes of dynamic shared
    memory.
    Its sums over its channels go into a workspace of ``workspace_bytes``
    that a second kernel adds up."""

    lanes: int
    warps: int
    steps: int
    smem: int
    blocks: int
    workspace_bytes: int

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def channels(self) -> int:
        return self.threads // self.lanes

    def grid(self, b: int) -> Tuple[int, int]:
        """Blocks along channels and batch rows."""
        return self.blocks, b

    def chunks(self, s: int) -> int:
        return -(-s // self.steps)

    def channel_range(self, x: int, d: int) -> Tuple[int, int]:
        """Block (x, .)'s channels."""
        return x * self.channels, min((x + 1) * self.channels, d)

    def step_range(self, k: int, s: int) -> Tuple[int, int]:
        """Chunk k's steps."""
        return k * self.steps, min((k + 1) * self.steps, s)

    def thread(self, t: int, n: int) -> Tuple[int, Tuple[int, int]]:
        """Thread t's channel in its block and its state range."""
        per = n // self.lanes
        j = t % self.lanes
        return t // self.lanes, (j * per, (j + 1) * per)


def bwd_smem_bytes(n: int, lanes: int = BWD_LANES,
                   warps: int = BWD_WARPS) -> int:
    """Dynamic shared memory of one backward block: ``BWD_RING`` chunk
    buffers, each the dt, x, dy rows of ``STEPS`` steps (a row padded by a
    warp's channels), its Bm and Cm rows and the boundary states of the
    block's channels; the warps' sums of d Cm and d Bm (warps x steps x
    N each); the dx and d dt rows (steps x channels each); float32."""
    cw = 32 // lanes
    c = warps * cw
    row = c + cw
    stage = 3 * STEPS * row + 2 * STEPS * n + c * n
    return 4 * (BWD_RING * stage + 2 * warps * STEPS * n + 2 * STEPS * c)


def bwd_workspace_bytes(b: int, s: int, d: int, n: int, channels: int) -> int:
    """Two (B, S, blocks, N) rows of sums over a block's channels (d Bm,
    d Cm), dA's (B, D, N) and dDskip's (B, D) batch rows, float32."""
    blocks = -(-d // channels)
    return 4 * (2 * b * s * blocks * n + b * d * n + b * d)


def bwd_plan(b: int, s: int, d: int, n: int, *, lanes: int = BWD_LANES,
             warps: int = BWD_WARPS) -> BwdPlan:
    """The backward's launch plan at (B, S, D, N), with chunks of
    ``STEPS`` steps (the forward's saving interval, whose boundary states
    it starts from).  Keywords force a knob (the on-card sweep; lanes and
    warps other than the kept ones need the build ``bwd_source`` gives).
    Raises on a plan the kernel cannot run."""
    if n not in STATE_DIMS:
        raise ValueError(f"selective_scan_bwd: N={n}, the kernel takes "
                         f"{STATE_DIMS}")
    if (lanes not in (2, 4, 8) or n % lanes
            or n // lanes > BWD_MAX_STATES):
        raise ValueError(f"selective_scan_bwd: {lanes} lanes a channel "
                         f"cannot split N={n} (lanes in (2, 4, 8), dividing "
                         f"N into at most {BWD_MAX_STATES} states a lane)")
    if warps not in (2, 4, 8):
        raise ValueError(f"selective_scan_bwd: {warps} warps a block, the "
                         f"kernel takes 2, 4 or 8")
    smem = bwd_smem_bytes(n, lanes, warps)
    if smem > SMEM_LIMIT:
        raise ValueError(f"selective_scan_bwd: {smem} B of shared memory a "
                         f"block, the card allows {SMEM_LIMIT}")
    channels = 32 * warps // lanes
    return BwdPlan(lanes, warps, STEPS, smem, -(-d // channels),
                   bwd_workspace_bytes(b, s, d, n, channels))


@functools.cache
def _bwd_lib(source: _build.KernelSource = BWD_SOURCE):
    """The backward's launcher and plan queries, bound once per process."""
    lib = _build.load(source)
    fn = lib.selective_scan_bwd_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 16 + [i32] * 8 + [ptr]
    fn.restype = i32
    lib.selective_scan_bwd_smem_bytes.argtypes = [i32]
    lib.selective_scan_bwd_smem_bytes.restype = i32
    lib.selective_scan_bwd_workspace_bytes.argtypes = [i32] * 4
    lib.selective_scan_bwd_workspace_bytes.restype = ctypes.c_longlong
    for name in ("lanes", "warps", "steps"):
        getattr(lib, f"selective_scan_bwd_{name}").restype = i32
    return (fn, lib.selective_scan_bwd_smem_bytes,
            lib.selective_scan_bwd_workspace_bytes,
            (lib.selective_scan_bwd_lanes(), lib.selective_scan_bwd_warps(),
             lib.selective_scan_bwd_steps()))


def _check_bwd(dt, bm, cm, x, a, d_skip, dy, dh_last, h_chunks) -> None:
    """Raise on any operand the backward kernel does not take."""
    b, s, d = x.shape
    n = a.shape[-1]
    want = {"dt": (b, s, d), "bm": (b, s, n), "cm": (b, s, n),
            "a": (d, n), "d_skip": (d,), "dy": (b, s, d),
            "dh_last": (b, d, n), "h_chunks": (b, -(-s // STEPS), d, n)}
    given = {"dt": dt, "bm": bm, "cm": cm, "x": x, "a": a, "d_skip": d_skip,
             "dy": dy, "dh_last": dh_last, "h_chunks": h_chunks}
    types = (torch.float32,) if x.device.type == "cuda" \
        else (torch.float32, torch.float64)
    for name, t in given.items():
        if t is None and name in ("dh_last", "h_chunks"):
            continue
        if name != "x" and (tuple(t.shape) != want[name]
                            or t.device != x.device):
            raise ValueError(f"selective_scan_bwd: {name} must be "
                             f"{want[name]} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if t.dtype not in types or (t.dtype != x.dtype
                                    and name != "h_chunks"):
            raise ValueError(f"selective_scan_bwd: {name} is {t.dtype}, x "
                             f"{x.dtype}; the kernel takes float32 operands "
                             f"(the plain version float64 too, on the CPU)")
    if n not in STATE_DIMS or s < 1:
        raise ValueError(f"selective_scan_bwd: N={n}, S={s}; the kernel "
                         f"takes N in {STATE_DIMS}, S >= 1")


def selective_scan_bwd(dt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                       x: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                       dy: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None, *,
                       h_chunks: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`selective_scan`'s (y, h_last) given ``dy``
    (B, S, D) and ``dh_last`` (B, D, N, or None for 0) -> (d dt, d bm,
    d cm, d x, d a, d d_skip).  On the card every operand is float32 and
    ``h_chunks`` is what the forward returned given ``states``; on
    the CPU the plain version rebuilds the states itself and ``h_chunks``
    is only checked."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"selective_scan_bwd: unsupported device "
                         f"{x.device}")
    _check_bwd(dt, bm, cm, x, a, d_skip, dy, dh_last, h_chunks)
    if x.device.type == "cpu":
        return selective_scan_bwd_ref(dt, bm, cm, x, a, d_skip, dy, dh_last)
    refuse_grad("selective_scan_bwd", (dt, bm, cm, x, a, d_skip, dy,
                                       dh_last), "it has no double backward")
    if h_chunks is None:
        raise ValueError("selective_scan_bwd: on the card it needs the "
                         "forward's h_chunks (selective_scan(..., "
                         "states=True))")
    b, s, d = x.shape
    return _bwd_run(dt, bm, cm, x, a, d_skip, dy, dh_last, h_chunks,
                    bwd_plan(b, s, d, a.shape[-1]))


def bwd_run_plan(dt, bm, cm, x, a, d_skip, dy, dh_last, h_chunks,
                 plan: BwdPlan) -> Tuple[torch.Tensor, ...]:
    """Launch the backward on CUDA operands with the given plan (the
    on-card sweep forces knobs), from the build for its lanes and warps."""
    _check_bwd(dt, bm, cm, x, a, d_skip, dy, dh_last, h_chunks)
    return _bwd_run(dt, bm, cm, x, a, d_skip, dy, dh_last, h_chunks, plan,
                    bwd_source(plan.lanes, plan.warps))


def _bwd_run(dt, bm, cm, x, a, d_skip, dy, dh_last, h_chunks,
             plan: BwdPlan, source: _build.KernelSource = BWD_SOURCE):
    b, s, d = x.shape
    n = a.shape[-1]
    launch, smem_of, ws_of, knobs = _bwd_lib(source)
    if (knobs != (plan.lanes, plan.warps, plan.steps)
            or smem_of(n) != plan.smem
            or ws_of(b, s, d, n) != plan.workspace_bytes):
        raise RuntimeError(f"selective_scan_bwd: {plan} disagrees with the "
                           f"build {source.name} (lanes, warps, steps "
                           f"{knobs})")
    dt, bm, cm, x, a, d_skip, dy, h_chunks = (
        t.contiguous() for t in (dt, bm, cm, x, a, d_skip, dy, h_chunks))
    if dh_last is not None:
        dh_last = dh_last.contiguous()
    grads = tuple(torch.empty_like(t) for t in (dt, bm, cm, x, a, d_skip))
    ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                     device=x.device)
    d_dt, d_bm, d_cm, d_x, d_a, d_d = grads
    err = launch(dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
                 a.data_ptr(), d_skip.data_ptr(), dy.data_ptr(),
                 None if dh_last is None else dh_last.data_ptr(),
                 h_chunks.data_ptr(), d_dt.data_ptr(), d_bm.data_ptr(),
                 d_cm.data_ptr(), d_x.data_ptr(), d_a.data_ptr(),
                 d_d.data_ptr(), ws.data_ptr(), b, s, d, n, plan.steps,
                 granule(d * 4, dt, x, dy, d_dt, d_x),
                 granule(n * 4, bm, cm), granule(n * 4, h_chunks),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd kernel launch failed: "
                           f"cudaError {err}")
    selective_scan_bwd.launches += 1
    return grads


selective_scan_bwd.launches = 0
