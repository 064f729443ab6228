"""PyTorch/CUDA port of the TORTA scheduler and its slotted simulator.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``sim``, ``workload``, ``api``, ``obs``, ``core``,
``kernels``) so each module's counterpart is easy to find, and imports
nothing from it.  Host-side bookkeeping stays numpy exactly where the
reference keeps it on the host (seeded RNG draws, the EMA forecast, the
same-server conflict walk, the regional power reduction); the slot's
device work runs in PyTorch and in the hand-written CUDA kernels under
``kernels/``.

Every entry point takes an explicit ``device`` and defaults to
``"cuda"``.  There is no fallback: without a card, :func:`resolve_device`
raises, and only a caller that asks for ``device="cpu"`` (the tests) runs
the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and no card is
    visible (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA device required (device={str(device)!r}) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels")
    return dev
