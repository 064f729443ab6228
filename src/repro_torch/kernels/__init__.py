"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version (``ref.py``), its wrapper (``ops.py``) and its CUDA source
(``csrc/``).  Nothing here imports a kernel library or builds anything at
import time: a kernel is compiled the first time its wrapper meets a CUDA
tensor."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, operands, missing: str) -> None:
    """Raise ``NotImplementedError`` where autograd would record a launch
    of ``kernel``: grad mode is on and a floating-point tensor among
    ``operands`` requires grad.  A kernel writes its output through
    ctypes into a fresh tensor with no ``grad_fn``, so a gradient would
    silently stop there; ``missing`` names the backward the port lacks.
    The wrappers call this on their CUDA path only: on the CPU they run
    the plain versions, which autograd differentiates."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.requires_grad for t in operands):
        raise NotImplementedError(
            f"{kernel}: an operand requires grad, but the kernel has no "
            f"backward on the card ({missing})")
