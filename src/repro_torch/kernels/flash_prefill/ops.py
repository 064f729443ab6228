"""Wrapper of the prefill attention kernel (``csrc/flash_prefill.cu``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
plain version in ``ref.py``.  There is no fallback between the two.
``launch_plan`` gives the kernel's tiling (query rows a block, keys a
tile, ring stages, the blocks' order, shared memory, precision scheme),
so the CPU tests pin it.  ``flash_prefill.launches`` counts calls that
launch the kernel.  Its gradient is ``autograd.py``'s, which
``prefill_attention`` takes under grad; on CUDA operands that require
grad, ``flash_prefill`` itself raises rather than return an output that
autograd cannot see through.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.flash_prefill import autograd
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

SOURCE = _build.KernelSource(
    "flash_prefill",
    pathlib.Path(__file__).resolve().parent / "csrc" / "flash_prefill.cu",
    ("-Xptxas=-v",))
HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)
SM_SMEM = 233472              # shared memory of an SM (H100), 1 KB a block
WG_ROWS = 64                  # query rows a warpgroup (kWgRows, wgmma's M)
ROWS = (64, 128)              # query rows a block: one or two warpgroups
KEY_TILES = {torch.float32: (32, 64), torch.bfloat16: (64,)}
MIN_STAGES, MAX_STAGES = 2, 4
PRECISION = {torch.float32: "3xtf32", torch.bfloat16: "bf16"}
N_SMS = 132                   # SMs of an H100 SXM, where no card is asked


class PrefillPlan(NamedTuple):
    """How one launch tiles (B, KH, G, S): block ``i`` takes pair ``i %
    (B KH)`` = (b, kh) and query-row tile ``n_qtiles - 1 - i // (B KH)``
    (rows ordered (s, g), ``rows`` a tile, heaviest first); each of its
    ``rows / 64`` warpgroups walks the key tiles of ``bk`` keys that hold
    a visible key for its 64 rows, through a ring of ``stages`` slots, in
    ``smem`` bytes of dynamic shared memory.  ``precision`` is the
    products' scheme: "3xtf32" (float32) or "bf16"."""

    rows: int
    bk: int
    stages: int
    n_qtiles: int
    n_ktiles: int
    smem: int
    precision: str

    def blocks(self, b: int, kh: int) -> int:
        return self.n_qtiles * b * kh

    def workspace_bytes(self, b: int, kh: int, hd: int) -> int:
        """The K/V tile images ``kv_images_kernel`` writes."""
        return b * kh * self.n_ktiles * image_bytes(
            4 if self.precision == "3xtf32" else 2, hd, self.bk)

    def units(self, b: int, kh: int, g: int, s: int,
              window: Optional[int]) -> Iterator[Tuple[int, int, int, int,
                                                       int, int, int]]:
        """Every warpgroup's work in launch order, as the kernel derives
        it: (block, b, kh, first row, end row, first key tile, last key
        tile); rows past G S are dropped, and a warpgroup with none walks
        no tile."""
        pairs, n_rows = b * kh, g * s
        for i in range(self.blocks(b, kh)):
            pair, qt = i % pairs, self.n_qtiles - 1 - i // pairs
            for wg in range(self.rows // WG_ROWS):
                r0 = qt * self.rows + WG_ROWS * wg
                if r0 >= n_rows:
                    continue
                r1 = min(r0 + WG_ROWS, n_rows)
                lo, hi = r0 // g, (r1 - 1) // g
                first = max(0, lo - window + 1) // self.bk if window else 0
                yield i, pair // kh, pair % kh, r0, r1, first, hi // self.bk


def _elt(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def _depth(elt: int, hd: int) -> int:
    """Q K^T's depth in shared memory: hd, padded to a 128-byte row."""
    return max(hd, 128 // elt)


def image_bytes(elt: int, hd: int, bk: int) -> int:
    """One key tile's image: K (bk x depth) and V^T (hd x bk), float32 as
    a hi and a lo part (the kernel's ``image_bytes``)."""
    return (2 if elt == 4 else 1) * (bk * _depth(elt, hd) * elt
                                     + hd * bk * elt)


def smem_bytes(elt: int, hd: int, bk: int, rows: int, stages: int) -> int:
    """The kernel's ``smem_bytes``: 1024 bytes to align the base, the part
    of every warpgroup's Q not held in registers (bf16 Q; float32 lo at
    hd = 128), the ring, an mbarrier a stage."""
    q_smem = rows * _depth(elt, hd) * elt if elt == 2 or hd > 64 else 0
    return 1024 + q_smem + stages * image_bytes(elt, hd, bk) + 8 * stages


def resident(smem: int) -> int:
    """Blocks of ``smem`` dynamic shared bytes that fit an SM."""
    return SM_SMEM // (smem + 1024)


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, kh: int, g: int, s: int, hd: int,
                window: Optional[int], dtype: torch.dtype, *,
                n_sms: int = N_SMS, rows: Optional[int] = None,
                bk: Optional[int] = None,
                stages: Optional[int] = None) -> PrefillPlan:
    """The tiling of (B, KH, G, S) at head dim ``hd``: 64 query rows a
    block (one warpgroup), or 128 (two warpgroups sharing each K/V tile)
    where two 64-row blocks do not fit an SM and 128-row tiles still give
    two blocks for each of the card's ``n_sms`` SMs; the longest key
    tile at which two blocks of two stages fit an SM, else 32 keys; then
    the most stages, up to 4, that still fit as many blocks an SM as the
    grid gives each SM (at most what two stages fit).  ``rows``, ``bk``
    and ``stages`` force a knob (the on-card sweep).  Raises on a plan
    the kernel cannot run."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: hd={hd}, the kernel takes "
                         f"{HEAD_DIMS}")
    if dtype not in DTYPES:
        raise ValueError(f"flash_prefill: dtype {dtype}, the kernel takes "
                         f"{list(DTYPES)}")
    if min(b, kh, g, s) < 1 or (window is not None and window < 1):
        raise ValueError(f"flash_prefill: B={b} KH={kh} G={g} S={s} "
                         f"window={window}")
    elt = _elt(dtype)

    def fit(rows_, bk_, stages_):
        return resident(smem_bytes(elt, hd, bk_, rows_, stages_))
    if rows is None:
        small = min(KEY_TILES[dtype])
        rows = ROWS[1] if (fit(ROWS[0], small, MIN_STAGES) < 2
                           and fit(ROWS[1], small, MIN_STAGES) >= 1
                           and b * kh * -(-g * s // ROWS[1]) >= 2 * n_sms) \
            else ROWS[0]
    if rows not in ROWS:
        raise ValueError(f"flash_prefill: {rows} rows a block, the kernel "
                         f"takes {ROWS}")
    if bk is None:
        bk = next((n for n in sorted(KEY_TILES[dtype], reverse=True)
                   if fit(rows, n, MIN_STAGES) >= 2), min(KEY_TILES[dtype]))
    if bk not in KEY_TILES[dtype]:
        raise ValueError(f"flash_prefill: key tile {bk}, the kernel takes "
                         f"{KEY_TILES[dtype]} for {dtype}")
    if stages is None:
        want = min(fit(rows, bk, MIN_STAGES),
                   -(-b * kh * -(-g * s // rows) // n_sms))
        stages = max(n for n in range(MIN_STAGES, MAX_STAGES + 1)
                     if n == MIN_STAGES or fit(rows, bk, n) >= want)
    if not MIN_STAGES <= stages <= MAX_STAGES:
        raise ValueError(f"flash_prefill: {stages} stages, the ring takes "
                         f"{MIN_STAGES}-{MAX_STAGES}")
    smem = smem_bytes(elt, hd, bk, rows, stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_prefill: {smem} B of shared memory a block "
                         f"(rows {rows}, key tile {bk}, {stages} stages, hd "
                         f"{hd}), the card allows {SMEM_LIMIT}")
    return PrefillPlan(rows, bk, stages, -(-g * s // rows), -(-s // bk), smem,
                       PRECISION[dtype])


@functools.cache
def _lib():
    """The launcher and its size queries, bound once per process."""
    lib = _build.load(SOURCE)
    fn = lib.flash_prefill_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 5 + [i64] + [i32] * 6 + [ctypes.c_float]
                   + [i32] * 5 + [i64] * 14 + [ptr])
    fn.restype = ctypes.c_int
    smem = lib.flash_prefill_smem_bytes
    smem.argtypes = [i32] * 5
    smem.restype = i32
    ws = lib.flash_prefill_workspace_bytes
    ws.argtypes = [i32] * 6
    ws.restype = i64
    return fn, smem, ws


def _check(q, k, v, window) -> None:
    """Raise on any operand the kernel does not take."""
    b, kh, g, s, hd = q.shape
    if k.shape != (b, kh, s, hd) or v.shape != (b, kh, s, hd):
        raise ValueError(f"flash_prefill: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: hd={hd}, the kernel takes "
                         f"{HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_prefill: window={window} must be >= 1")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_prefill: {name} must be {q.dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_prefill: dtype {q.dtype}, the kernel takes "
                         f"{list(DTYPES)}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window=None) -> torch.Tensor:
    """q: (B, KH, G, S, hd); k, v: (B, KH, S, hd) -> (B, KH, G, S, hd),
    float32 or bfloat16.  Causal self-attention with an optional sliding
    window.  Views with hd contiguous launch without a copy (permuted
    views of (B, S, H, hd) included); the output has q's strides."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    refuse_grad("flash_prefill", (q, k, v),
                "its gradient is autograd.flash_prefill_grad's, which "
                "prefill_attention takes under grad")
    _check(q, k, v, window)
    b, kh, g, s, hd = q.shape
    if q.numel() == 0:
        return torch.empty_like(q)
    return _run(q, k, v, window,
                launch_plan(b, kh, g, s, hd, window, q.dtype,
                            n_sms=_sms(q.device.index)))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def run_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             plan: PrefillPlan, *, window=None) -> torch.Tensor:
    """Launch the kernel on CUDA operands with the given plan (the on-card
    sweep forces its knobs)."""
    _check(q, k, v, window)
    return _run(q, k, v, window, plan)


def _run(q, k, v, window, plan: PrefillPlan) -> torch.Tensor:
    b, kh, g, s, hd = q.shape
    launch, smem_of, ws_of = _lib()
    code = DTYPES[q.dtype]
    n_ws = plan.workspace_bytes(b, kh, hd)
    if (plan.precision != PRECISION[q.dtype]
            or plan.n_qtiles != -(-g * s // plan.rows)
            or plan.n_ktiles != -(-s // plan.bk)
            or smem_of(code, hd, plan.bk, plan.rows, plan.stages) != plan.smem
            or ws_of(code, b, kh, s, hd, plan.bk) != n_ws):
        raise RuntimeError(f"flash_prefill: {plan} does not fit q "
                           f"{tuple(q.shape)}, {q.dtype}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    ws = torch.empty(n_ws, dtype=torch.uint8, device=q.device)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), n_ws, b, kh, g, s, hd, window or 0,
                 hd ** -0.5, code, plan.rows, plan.bk, plan.stages, plan.smem,
                 *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:4],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: cudaError "
                           f"{err}")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window=None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KH, hd) -> (B, S, H, hd), causal;
    head h is (h // G, h % G).  Permuted views in, no copies.  Under
    grad (grad mode on and an operand requiring grad) the call goes
    through :func:`autograd.flash_prefill_grad`, the same forward with
    its backward; otherwise straight to :func:`flash_prefill`."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qr = q.reshape(b, s, kh, h // kh, hd).permute(0, 2, 3, 1, 4)
    attend = flash_prefill
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        attend = autograd.flash_prefill_grad
    o = attend(qr, k.transpose(1, 2), v.transpose(1, 2), window=window)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
