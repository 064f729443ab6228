"""Wrapper of the Sinkhorn kernel (``csrc/sinkhorn.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
plain version in ``ref.py``.  There is no fallback between the two.
``launch_plan`` lays each problem over a thread-block cluster, or a team
of warps where one block a problem is faster (R = 1, or R <= 32 with
more blocks than SMs), so the CPU tests pin it; ``run_plan``
launches a given plan (the on-card sweep forces cluster sizes).
``sinkhorn_plan.launches`` counts the wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = _build.KernelSource("sinkhorn", CSRC / "sinkhorn.cu")
# two trivial kernels that chain the kernel's exchanges alone (the floor)
FLOOR_SOURCE = _build.KernelSource("sinkhorn_floor",
                                   CSRC / "sinkhorn_floor.cu")
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)
CARD_SMS = _build.CARD_SMS
TEAM_MAX_R = 32               # a team may take R <= 32 (a row in a warp)
TEAM_WARPS = 4                # one a scheduler partition
TEAM_SIZES = (1, 2, 4)
MAX_CLUSTER = 16              # past 8 a non-portable cluster size
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MIN_SPAN = 8                  # rows a block owns at least, unless forced
REG_TERMS = 8                 # a lane's terms in registers: R <= 256
SLABS = ("registers", "shared", "device")


class SinkhornPlan(NamedTuple):
    """``form`` "team": one block of ``threads`` / 32 warps a problem,
    warp q taking the q-th ``span`` columns (rows) of the other index;
    "cluster": ``cluster`` blocks a problem, each owning ``span`` rows
    and columns, a warp a row.  -cost/reg lives in ``slab`` (registers,
    shared memory, or a device workspace of ``workspace`` floats);
    ``smem`` dynamic shared bytes a block."""

    form: str
    threads: int
    cluster: int
    span: int
    slab: str
    smem: int
    workspace: int


def team_smem(warps: int) -> int:
    """Partials [2][warps][32] (max, sum) and each warp's copies of X_f
    and X_g (the kernel's ``team_smem``)."""
    return warps * 32 * (2 * 8 + 2 * 4)


def cluster_smem(r: int, span: int, slab: str) -> int:
    """Two mbarriers, X_f and X_g of all R regions, log mu and log nu of
    the block's span, and the two slabs when they live in shared memory
    (the kernel's ``cluster_smem``)."""
    return 16 + 4 * (2 * r + 2 * span) + (8 * span * r if slab == "shared"
                                          else 0)


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, r: int, cluster: Optional[int] = None,
                warps: Optional[int] = None) -> SinkhornPlan:
    """The launch for B problems of R regions: a cluster of C blocks a
    problem, each owning span rows and columns, span = ceil(R /
    ``cluster``) or, by default, min(max(ceil(R / 16), ``MIN_SPAN``), R)
    (at R = 64, 8 blocks of 8 rows beat 16 of 4 on the card; at R <= 32,
    blocks of 8 rows beat the team), C = ceil(R / span), min(span, 32)
    warps; -cost/reg in registers while R <= 256, then in shared slabs
    while they fit ``SMEM_LIMIT`` (R <= 672 at C = 16), then in a device
    workspace.  A team of ceil(R / ceil(R / W)) warps instead, W =
    ``warps`` or 4 (25 -> 4 warps of 7 columns), where it wins on the
    card: at R = 1, and at R <= 32 when the B x C blocks would outnumber
    ``CARD_SMS`` (blocks sharing an SM; at B = 64, R >= 20), or with
    ``warps`` given.  B otherwise sizes the workspace only: each problem
    has its own team or cluster."""
    if r < 1:
        raise ValueError(f"sinkhorn_plan: R={r}, need R >= 1")
    if b < 0:
        raise ValueError(f"sinkhorn_plan: B={b}, need B >= 0")
    if cluster is None and r <= TEAM_MAX_R and (
            warps is not None or r == 1
            or b * -(-r // MIN_SPAN) > CARD_SMS):
        w = TEAM_WARPS if warps is None else warps
        if w not in TEAM_SIZES:
            raise ValueError(f"sinkhorn_plan: team of {w} warps, not in "
                             f"{TEAM_SIZES}")
        chunk = -(-r // w)
        w = -(-r // chunk)
        return SinkhornPlan("team", 32 * w, 1, chunk, "registers",
                            team_smem(w), 0)
    c = MAX_CLUSTER if cluster is None else cluster
    if c not in CLUSTER_SIZES:
        raise ValueError(f"sinkhorn_plan: cluster {c} not in "
                         f"{CLUSTER_SIZES}")
    span = -(-r // min(c, r)) if cluster else min(max(-(-r // c), MIN_SPAN),
                                                   r)
    c = -(-r // span)
    if r <= 32 * REG_TERMS and span <= 32:
        slab = "registers"
    elif cluster_smem(r, span, "shared") <= SMEM_LIMIT:
        slab = "shared"
    else:
        slab = "device"
    smem = cluster_smem(r, span, slab)
    if smem > SMEM_LIMIT:
        raise ValueError(f"sinkhorn_plan: R={r}: the {r} regions' X_f and "
                         f"X_g overflow a block's shared memory")
    return SinkhornPlan("cluster", 32 * min(span, 32), c, span, slab, smem,
                        b * c * 2 * span * r if slab == "device" else 0)


@functools.cache
def _lib():
    """The launcher and the shared-bytes formula, bound once per process."""
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.sinkhorn_launch
    fn.argtypes = ([ptr] * 5 + [i32] * 3 + [ctypes.c_float] + [i32] * 5
                   + [ctypes.c_longlong, ptr])
    fn.restype = ctypes.c_int
    smem = lib.sinkhorn_shared_bytes
    smem.argtypes = [i32] * 5
    smem.restype = ctypes.c_longlong
    return fn, smem


def _check(mu: torch.Tensor, nu: torch.Tensor, cost: torch.Tensor) -> None:
    b, r = mu.shape
    if nu.shape != (b, r) or cost.shape != (b, r, r):
        raise ValueError(f"sinkhorn_plan: shapes mu {tuple(mu.shape)}, nu "
                         f"{tuple(nu.shape)}, cost {tuple(cost.shape)}")
    for name, t in (("mu", mu), ("nu", nu), ("cost", cost)):
        if t.dtype != torch.float32 or t.device != mu.device:
            raise ValueError(f"sinkhorn_plan: {name} must be float32 on "
                             f"{mu.device}, got {t.dtype} on {t.device}")


@functools.lru_cache(maxsize=None)
def _agreed(plan: SinkhornPlan, r: int) -> tuple:
    """The launcher and the plan's (team, slab) arguments, once the plan's
    shared bytes agree with the kernel's layout (checked once a plan)."""
    launch, smem_bytes = _lib()
    team, slab = int(plan.form == "team"), SLABS.index(plan.slab)
    if smem_bytes(team, r, plan.threads, plan.span, slab) != plan.smem:
        raise RuntimeError(f"sinkhorn: {plan} disagrees with the kernel's "
                           f"shared-memory layout")
    return launch, team, slab


def _launch(mu, nu, cost, plan, reg, n_iters) -> torch.Tensor:
    b, r = mu.shape
    launch, team, slab = _agreed(plan, r)
    mu, nu, cost = (t.contiguous() for t in (mu, nu, cost))
    out = torch.empty((b, r, r), dtype=torch.float32, device=mu.device)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=mu.device) \
        if plan.workspace else None
    err = launch(mu.data_ptr(), nu.data_ptr(), cost.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(), b, r,
                 n_iters, float(reg), team, plan.threads, plan.cluster,
                 plan.span, slab, plan.smem,
                 torch.cuda.current_stream(mu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn kernel launch failed ({plan}): "
                           f"cudaError {err}")
    return out


def run_plan(mu: torch.Tensor, nu: torch.Tensor, cost: torch.Tensor,
             plan: SinkhornPlan, *, reg: float = 0.05, n_iters: int = 100
             ) -> torch.Tensor:
    """Launch the kernel on CUDA operands with the given plan."""
    _check(mu, nu, cost)
    if mu.device.type != "cuda":
        raise ValueError(f"sinkhorn run_plan: needs CUDA tensors, got "
                         f"{mu.device}")
    return _launch(mu, nu, cost, plan, reg, n_iters)


def sinkhorn_plan(mu: torch.Tensor, nu: torch.Tensor, cost: torch.Tensor, *,
                  reg: float = 0.05, n_iters: int = 100) -> torch.Tensor:
    """(B, R) x (B, R) x (B, R, R) float32 -> (B, R, R) transport plans."""
    if mu.device.type == "cpu":
        return sinkhorn_ref(mu, nu, cost, reg=reg, n_iters=n_iters)
    if mu.device.type != "cuda":
        raise ValueError(f"sinkhorn_plan: unsupported device {mu.device}")
    refuse_grad("sinkhorn_plan", (mu, nu, cost),
                "the transport plan is a scheduler's decision; nothing "
                "differentiates through it")
    _check(mu, nu, cost)
    out = _launch(mu, nu, cost, launch_plan(*mu.shape), reg, n_iters)
    sinkhorn_plan.launches += 1
    return out


sinkhorn_plan.launches = 0
