"""Causal GQA prefill attention: CUDA kernel, wrapper and plain version."""
from repro_torch.kernels.flash_prefill.ops import (flash_prefill,
                                                   prefill_attention)
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
