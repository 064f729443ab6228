"""Wrapper of the decode attention kernel (``csrc/flash_decode.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
plain version in ``ref.py``.  There is no fallback between the two.
``decode_plan`` splits the cache over the card (heads a block, positions
a chunk, stages in the copy ring), so the CPU tests pin it.
``flash_decode.launches`` counts calls that launch the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

SOURCE = _build.KernelSource(
    "flash_decode",
    pathlib.Path(__file__).resolve().parent / "csrc" / "flash_decode.cu",
    ("-Xptxas=-v",))
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)
TILE = 32                     # cache positions a tile (kTile)
WARPS = 4                     # warps a block (kWarps)
MAX_CHUNK = 4096              # positions a block at most
BLOCKS_PER_SM = 2             # the split aims at this many blocks an SM
STAGES = 3                    # K/V tiles in the copy ring, at most
MIN_STAGES, MAX_STAGES = 2, 4
SM_SMEM = 233472              # shared memory of an SM (H100), 1 KB a block
RESIDENT = 3                  # blocks an SM the ring must leave room for


class DecodePlan(NamedTuple):
    """How one launch splits (B, KH, G, C): block ``i`` takes pair ``i //
    n_chunks`` = (b, kh, head tile) in that order, heads ``[tile * gt,
    (tile + 1) * gt)`` (cut at G), and chunk ``i % n_chunks``, positions
    ``[chunk * chunk_len, (chunk + 1) * chunk_len)`` (cut at C); its copy
    ring holds ``stages`` tiles, and it uses ``smem`` bytes of dynamic
    shared memory."""

    gt: int
    n_gtiles: int
    chunk: int
    n_chunks: int
    stages: int
    smem: int

    def blocks(self, b: int, kh: int) -> int:
        return b * kh * self.n_gtiles * self.n_chunks

    def workspace_floats(self, b: int, kh: int, hd: int) -> int:
        """Every block's partial: acc (gt x hd), then (m, l) a head."""
        return b * kh * self.n_gtiles * self.n_chunks * self.gt * (hd + 2)


def _elt(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def smem_bytes(elt: int, hd: int, gt: int, chunk: int, n_chunks: int,
               stages: int) -> int:
    """The kernel's ``smem_bytes``: the K/V ring (rows padded by 16
    bytes), q, the warps' partial scores, the weights, the correction
    factors and denominators, the merge's factors, the tiles' masks and
    list, and three flags."""
    vec, tiles = 16 // elt, chunk // TILE
    return (stages * 2 * TILE * (hd + vec) * elt
            + 4 * (gt * hd + WARPS * gt * 32 + gt * 33 + 2 * gt
                   + gt * n_chunks + 2 * tiles + 3))


def head_tile(g: int) -> int:
    """Query heads a block: G up to 8, rounded up to a power of two."""
    return next(t for t in (1, 2, 4, 8) if t >= min(g, 8))


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, kh: int, g: int, c: int, hd: int, n_sms: int, *,
                dtype: torch.dtype = torch.float32,
                chunk: Optional[int] = None,
                stages: Optional[int] = None) -> DecodePlan:
    """The split for (B, KH, G, C) at head dim ``hd`` on a card of
    ``n_sms`` SMs: ``head_tile(G)`` heads a block; chunks of whole
    32-position tiles, as short as gives ``BLOCKS_PER_SM`` blocks an SM
    and at most ``MAX_CHUNK`` positions; the most stages, up to
    ``STAGES``, at which ``RESIDENT`` blocks fit an SM, else 2 (2 for
    float32 at hd = 128 and in both types at hd = 256, where two stages
    leave room for one block an SM in float32 and two in bfloat16; 3
    else).  ``chunk`` and ``stages`` force a knob (the
    on-card sweep).  Raises on a plan the kernel cannot run."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: hd={hd}, the kernel takes "
                         f"{HEAD_DIMS}")
    if min(b, kh, g, c, n_sms) < 1:
        raise ValueError(f"flash_decode: B={b} KH={kh} G={g} C={c} on "
                         f"{n_sms} SMs")
    gt = head_tile(g)
    n_gtiles = -(-g // gt)
    if chunk is None:
        want = -(-BLOCKS_PER_SM * n_sms // (b * kh * n_gtiles))
        chunk = TILE * -(-c // (want * TILE))
        chunk = min(max(chunk, TILE), MAX_CHUNK)
    if chunk < TILE or chunk % TILE or chunk > MAX_CHUNK:
        raise ValueError(f"flash_decode: chunk {chunk}, the kernel takes a "
                         f"multiple of {TILE} up to {MAX_CHUNK}")
    n_chunks = -(-c // chunk)

    def smem_at(n: int) -> int:
        return smem_bytes(_elt(dtype), hd, gt, chunk, n_chunks, n)
    if stages is None:
        stages = next((n for n in range(STAGES, MIN_STAGES, -1)
                       if RESIDENT * (smem_at(n) + 1024) <= SM_SMEM),
                      MIN_STAGES)
    if not MIN_STAGES <= stages <= MAX_STAGES:
        raise ValueError(f"flash_decode: {stages} stages, the ring takes "
                         f"{MIN_STAGES}-{MAX_STAGES}")
    smem = smem_at(stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_decode: {smem} B of shared memory a block, "
                         f"the card allows {SMEM_LIMIT}")
    return DecodePlan(gt, n_gtiles, chunk, n_chunks, stages, smem)


@functools.cache
def _lib():
    """The launcher and its shared-bytes query, bound once per process."""
    lib = _build.load(SOURCE)
    fn = lib.flash_decode_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 7 + [i32] * 5 + [ctypes.c_float] + [i32] * 5 + [ptr]
    fn.restype = ctypes.c_int
    smem = lib.flash_decode_smem_bytes
    smem.argtypes = [i32] * 6
    smem.restype = i32
    return fn, smem


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> int32 tickets, zeroed once; the kernel's last
# block of each pair leaves its ticket at 0 again
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 2 * (0 if t is None else t.numel())),
                        dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _check(q, k_cache, v_cache, valid) -> None:
    """Raise on any operand the kernel does not take."""
    b, kh, g, hd = q.shape
    c = k_cache.shape[1]
    if (k_cache.shape != (b, c, kh, hd) or v_cache.shape != (b, c, kh, hd)
            or valid.shape != (b, c)):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} {tuple(v_cache.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: hd={hd}, the kernel takes "
                         f"{HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_decode: dtype {q.dtype}, the kernel takes "
                         f"{list(DTYPES)}")
    for name, t, dtype in (("k_cache", k_cache, q.dtype),
                           ("v_cache", v_cache, q.dtype),
                           ("valid", valid, torch.int32)):
        if t.dtype != dtype or t.device != q.device:
            raise ValueError(f"flash_decode: {name} must be {dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """q: (B, KH, G, hd); caches: (B, C, KH, hd); valid: (B, C) int32 ->
    (B, KH, G, hd) in q's type (float32 or bfloat16)."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    refuse_grad("flash_decode", (q, k_cache, v_cache),
                "decode attention is not trained: the train step's "
                "attention is flash_prefill's, through prefill_attention")
    _check(q, k_cache, v_cache, valid)
    b, kh, g, hd = q.shape
    plan = decode_plan(b, kh, g, k_cache.shape[1], hd,
                       _sms(q.device.index), dtype=q.dtype)
    return _run(q, k_cache, v_cache, valid, plan)


def run_plan(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
             valid: torch.Tensor, plan: DecodePlan) -> torch.Tensor:
    """Launch the kernel on CUDA operands with the given plan (the on-card
    sweep forces the chunk length)."""
    _check(q, k_cache, v_cache, valid)
    return _run(q, k_cache, v_cache, valid, plan)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (cp.async's pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _run(q, k_cache, v_cache, valid, plan: DecodePlan) -> torch.Tensor:
    b, kh, g, hd = q.shape
    c = k_cache.shape[1]
    launch, smem_of = _lib()
    code = DTYPES[q.dtype]
    if (plan.gt != head_tile(g) or plan.n_chunks != -(-c // plan.chunk)
            or smem_of(code, hd, plan.gt, plan.chunk, plan.n_chunks,
                       plan.stages) != plan.smem):
        raise RuntimeError(f"flash_decode: {plan} does not fit q "
                           f"{tuple(q.shape)}, C={c}, {q.dtype}")
    q, k_cache, v_cache = (_aligned(t) for t in (q, k_cache, v_cache))
    valid = valid.contiguous()
    out = torch.empty_like(q)
    ws = torch.empty(plan.workspace_floats(b, kh, hd), dtype=torch.float32,
                     device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream, b * kh * plan.n_gtiles)
    err = launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 valid.data_ptr(), out.data_ptr(), ws.data_ptr(),
                 tickets.data_ptr(), b, kh, g, c, hd, hd ** -0.5, code,
                 plan.gt, plan.chunk, plan.stages, plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError "
                           f"{err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     cache_positions: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention against a (possibly rotating) cache.

    q: (B, 1, H, hd); caches: (B, C, KH, hd); pos: (B,); cache_positions:
    (B, C) absolute position held by each slot (-1 = empty).  Attends to
    slots with 0 <= cache_pos <= pos."""
    b, _, h, hd = q.shape
    kh = k_cache.shape[2]
    valid = ((cache_positions >= 0)
             & (cache_positions <= pos[:, None])).to(torch.int32)
    o = flash_decode(q.reshape(b, kh, h // kh, hd), k_cache, v_cache, valid)
    return o.reshape(b, 1, h, hd)
