"""Wrapper of the multi-region greedy kernel (``csrc/greedy_assign.cu``).

``GreedyInputs`` is the full operand set of one slot's greedy, built once
by ``core/micro_torch.assign_scan_all``; the kernel and the plain
version (``ref.py``) take the very same tensors, so the pre-scan values
(load, demand, note norms, speed, the decay table) are computed once, in
that wrapper, for both.  A CUDA operand set launches the kernel; a CPU
one runs the plain version.  An optional ``static`` operand selects the
kernel's static variant (the per-region route with the fused score
kernel).

A call launches two kernels: a pre-pass that writes the static score
terms of every (task, server) pair into a workspace the wrapper
allocates (``workspace_bytes``), and the task loop, one thread-block
cluster per region, which reads them.  ``launch_plan`` picks the cluster
size and each block's server range from the shapes and the card's SM
count; when the regions' clusters do not all fit the card at once, they
run in waves.  ``greedy_assign.launches`` counts calls that launch the
loop.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.micro_state import EMPTY
from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.greedy_assign.ref import greedy_assign_ref

SOURCE = _build.KernelSource(
    "greedy_assign",
    pathlib.Path(__file__).resolve().parent / "csrc" / "greedy_assign.cu",
    extra_flags=("-fmad=false",))
# the same kernel with its task steps' phases counted (``step_profile``)
PROFILE_SOURCE = dataclasses.replace(
    SOURCE, name="greedy_assign_profile",
    extra_flags=SOURCE.extra_flags + ("-DGREEDY_STEP_PROFILE",))
PHASES = ("pick and send", "score next", "wait partials", "fold", "push")
KEEP = 4                      # ring depth the kernel is compiled for
MAX_AGE = 40                  # Eq-10 age clip (decay table has 41 entries)
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)
SM_SMEM = 233472              # shared memory of one SM, 1 KB a block reserved
# blocks of a one-wave launch the plan puts on an SM, on average: it takes
# the largest cluster size within this (25 x 500: C = 8, not 16)
MAX_BLOCKS_PER_SM = 2
CLUSTER_SIZES = (1, 2, 4, 8, 16)   # blocks a region; 16 is non-portable
# a task step's time in one wave at each cluster size, in us: a call's
# time over its waves and its longest region's steps, 200 regions x 500
# servers on an H100 (PERF.md §6); weighs the waves of a launch whose
# clusters do not all fit the card at once
STEP_US = {1: 3.932, 2: 1.708, 4: 1.623, 8: 1.545, 16: 1.604}
# threads of the task loop an SM holds at once: its registers leave room
# for one 1024-thread block (the card's count, PERF.md §6)
LOOP_SM_THREADS = 1024
GRANULE = 16                  # a block's first server is a multiple of this
LANES = 4                     # threads that score one server
STAGES = 4                    # prefetched task rows (kStages in the source)
TASK_HEAD = 32                # task record bytes before its embedding


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


class LaunchPlan(NamedTuple):
    """How one launch lays a region over a thread-block cluster: block b
    of ``cluster`` blocks owns servers ``[b * span, (b + 1) * span)`` (cut
    at S_pad), with ``threads`` threads and ``smem`` bytes of dynamic
    shared memory."""

    cluster: int
    span: int
    threads: int
    smem: int

    def ranges(self, s_pad: int) -> list:
        """Each block's (first, end) server, in cluster rank order."""
        return [(min(b * self.span, s_pad), min((b + 1) * self.span, s_pad))
                for b in range(self.cluster)]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def task_bytes(embed_dim: int) -> int:
    """Bytes of one task's record in the pre-pass workspace (mid, has,
    norm, note, work, the locality its predecessor's ring entry gives it,
    then the embedding), 16-byte aligned."""
    return _round_up(TASK_HEAD + 4 * embed_dim, 16)


def workspace_bytes(n_regions: int, n_pad: int, s_pad: int,
                    embed_dim: int) -> int:
    """The pre-pass workspace: one row per (region, task slot) holding
    the task's record and, per server (S_pad rounded up to 16), the
    float64 static score and work penalty and one byte of flags."""
    return n_regions * n_pad * (task_bytes(embed_dim)
                                + 17 * _round_up(s_pad, GRANULE))


def smem_bytes(span: int, embed_dim: int, cluster: int, threads: int) -> int:
    """Dynamic shared memory of one block (``Layout`` in the source): the
    prefetch stages, the cluster's double-buffered (key, index) partials
    (one a warp), each server's float64 queue, speed and switch scale and
    its next keys and queue, the decay table, the rings and the mbarriers
    (one a stage, one a partial buffer)."""
    stage = _round_up(task_bytes(embed_dim) + 17 * span, 16)
    return (STAGES * stage + 2 * cluster * (threads // 32) * 16
            + 48 * span + _round_up(8 * (MAX_AGE + 1), 16)
            + _round_up(span * (16 * embed_dim + 52), 16)
            + _round_up(8 * (STAGES + 2), 16))


def _plan(s_pad: int, embed_dim: int, cluster: int) -> LaunchPlan:
    span = _round_up(-(-s_pad // cluster), GRANULE)
    threads = min(1024, _round_up(LANES * span, 32))
    return LaunchPlan(cluster, span, threads,
                      smem_bytes(span, embed_dim, cluster, threads))


def resident_estimate(plan: LaunchPlan, n_sms: int) -> int:
    """Clusters of ``plan`` a card of ``n_sms`` SMs holds at once, as far
    as shared memory and ``LOOP_SM_THREADS`` allow (the card's own count,
    ``max_resident_clusters``, also weighs where clusters may go)."""
    per_sm = min(SM_SMEM // (plan.smem + 1024),
                 LOOP_SM_THREADS // plan.threads)
    return n_sms * per_sm // plan.cluster


def launch_plan(n_regions: int, s_pad: int, embed_dim: int, n_sms: int,
                cluster: Optional[int] = None,
                resident: Optional[Callable[[LaunchPlan], int]] = None
                ) -> LaunchPlan:
    """The launch plan for R regions of S_pad servers at embedding width
    E on a card of ``n_sms`` SMs.  Sizes in ``CLUSTER_SIZES`` qualify
    when every block owns at least one server and its shared memory fits
    ``SMEM_LIMIT``.  ``resident(plan)`` counts the clusters of a plan the
    card holds at once (the card's own count in the wrapper,
    ``resident_estimate`` by default).  Where some size's R clusters are
    all held at once with at most ``MAX_BLOCKS_PER_SM`` blocks an SM on
    average, the plan takes the largest such size.  Otherwise the
    clusters run in waves (nothing couples two regions' clusters): the
    size that minimises ``waves * STEP_US[C]``, where waves is R over the
    clusters held at once, rounded up, and ``STEP_US`` is a task step's
    time at each size (on-card sweep, PERF.md §6).  ``cluster`` forces a
    size (the on-card sweep).  Raises when no size qualifies: one
    region's block overflows shared memory."""
    plans = {}
    for c in CLUSTER_SIZES:
        plan = _plan(s_pad, embed_dim, c)
        if (c - 1) * plan.span < s_pad and plan.smem <= SMEM_LIMIT:
            plans[c] = plan
    if cluster is not None:
        if cluster not in plans:
            raise ValueError(
                f"greedy_assign: cluster size {cluster} cannot run "
                f"{s_pad} servers at embed width {embed_dim} (sizes that "
                f"can: {sorted(plans)})")
        return plans[cluster]
    if not plans:
        raise ValueError(
            f"greedy_assign: {s_pad} servers at embed width {embed_dim} "
            f"cannot run: no cluster size in {CLUSTER_SIZES} keeps a "
            f"block's shared memory within {SMEM_LIMIT} B")
    count = resident or functools.partial(resident_estimate, n_sms=n_sms)
    held = {c: count(plan) for c, plan in plans.items()}
    fits = [c for c in plans if held[c] >= n_regions
            and c * n_regions <= MAX_BLOCKS_PER_SM * n_sms]
    if fits:
        return plans[max(fits)]
    costs = {c: -(-n_regions // h) * STEP_US[c]
             for c, h in held.items() if h > 0}
    if not costs:
        raise ValueError(
            f"greedy_assign: the card holds no cluster of any size in "
            f"{sorted(plans)} for {s_pad} servers at embed width "
            f"{embed_dim}")
    return plans[min(costs, key=costs.get)]


@functools.cache
def _lib(source: _build.KernelSource = SOURCE):
    """The launcher and the plan queries, bound once per process (the
    build, the source digest and the ctypes signatures stay off the
    per-slot path)."""
    lib = _build.load(source)
    fn = lib.greedy_assign_launch
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    size = ctypes.c_size_t
    fn.argtypes = ([i32] * 12 + [size, i32, i32, ctypes.c_longlong, f64]
                   + [ptr] * 26 + [f64] * 8 + [ptr] * 3)
    fn.restype = ctypes.c_int
    smem = lib.greedy_assign_smem_bytes
    smem.argtypes = [i32] * 6
    smem.restype = size
    resident = lib.greedy_assign_max_clusters
    resident.argtypes = [i32, i32, i32, i32, size]
    resident.restype = i32
    return fn, smem, resident, lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
@functools.cache
def max_resident_clusters(static: bool, embed_dim: int,
                          plan: LaunchPlan) -> int:
    """Clusters of ``plan`` the card keeps resident at once
    (``cudaOccupancyMaxActiveClusters``) for the kernel of this variant
    and embedding width; asked once a process for each."""
    return _lib()[2](int(static), embed_dim, plan.cluster, plan.threads,
                     plan.smem)


def step_profile(x: GreedyInputs, plan: LaunchPlan) -> dict:
    """Cycles a task step spends in each of ``PHASES`` on the card, from
    a build of the kernel that counts them (clock64, lane 0 of each warp
    of the first cluster): phase -> (mean, max) over those warps."""
    run_plan(x, plan, source=PROFILE_SOURCE)
    torch.cuda.synchronize(x.t_mids.device)
    per_warp = len(PHASES) + 1
    buf = (ctypes.c_ulonglong * (16 * 32 * per_warp))()
    err = _lib(PROFILE_SOURCE)[3].greedy_assign_step_cycles(buf)
    if err != 0:
        raise RuntimeError(f"greedy_assign step profile: cudaError {err}")
    counts = torch.tensor(list(buf), dtype=torch.float64).view(
        16, 32, per_warp)[:plan.cluster, :plan.threads // 32]
    cycles = counts[..., :-1] / counts[..., -1:].clamp(min=1)
    return {name: (float(cycles[..., j].mean()), float(cycles[..., j].max()))
            for j, name in enumerate(PHASES)}


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
    refuse_grad("greedy_assign", (getattr(x, f.name)
                                  for f in dataclasses.fields(x)),
                "the assignment is a scheduler's decision; nothing "
                "differentiates through it")
    _check(x)
    r, s_pad, _ = x.l_mids.shape
    static, e = x.static is not None, x.l_emb.shape[3]
    plan = launch_plan(r, s_pad, e, _sm_count(dev.index or 0),
                       resident=lambda p: max_resident_clusters(static, e, p))
    if max_resident_clusters(static, e, plan) <= 0:
        raise RuntimeError(
            f"greedy_assign: the card holds no cluster of {plan}")
    return run_plan(x, plan)


PREPASS, LOOP = 1, 2           # the two launches of a slot's greedy


def run_plan(x: GreedyInputs, plan: LaunchPlan,
             stages: Tuple[int, ...] = (PREPASS, LOOP),
             source: _build.KernelSource = SOURCE
             ) -> Tuple[torch.Tensor, Rings]:
    """Launch the pre-pass and the task loop on a CUDA operand set with
    the given plan (the on-card sweep forces cluster sizes, times the
    pre-pass alone with ``stages=(PREPASS,)`` and profiles the steps with
    ``PROFILE_SOURCE``)."""
    _check(x)
    launch, smem_bytes_of = _lib(source)[:2]
    dev = x.t_mids.device
    r, s_pad, _ = x.l_mids.shape
    n_pad = x.t_mids.shape[1]
    e = x.l_emb.shape[3]
    tb = task_bytes(e)
    if smem_bytes_of(plan.span, e, plan.cluster, plan.threads, tb,
                     MAX_AGE) != plan.smem:
        raise RuntimeError(f"greedy_assign: {plan} disagrees with the "
                           f"kernel's shared-memory layout")
    x = dataclasses.replace(x, **{
        name: getattr(x, name).contiguous() for name in _DTYPES},
        static=None if x.static is None else x.static.contiguous())
    rings = tuple(a.clone() for a in (x.l_mids, x.l_slots, x.l_emb, x.l_nrm))
    out = torch.empty((r, n_pad), dtype=torch.int32, device=dev)
    ws = torch.empty(workspace_bytes(r, n_pad, s_pad, e), dtype=torch.uint8,
                     device=dev)
    s_ws = _round_up(s_pad, GRANULE)
    c = x.consts
    args = (
        r, s_pad, n_pad, e, x.warm_srv.shape[2], int(x.t), EMPTY, MAX_AGE,
        plan.cluster, plan.span, plan.threads, plan.smem, tb, s_ws,
        tb + 17 * s_ws, float(x.slot_s),
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
        out.data_ptr(), ws.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    for stage in stages:
        err = launch(stage, *args)
        if err != 0:
            raise RuntimeError(
                f"greedy_assign kernel launch failed (stage {stage}): "
                f"cudaError {err}")
    if LOOP in stages:
        greedy_assign.launches += 1
    return out, rings


greedy_assign.launches = 0
