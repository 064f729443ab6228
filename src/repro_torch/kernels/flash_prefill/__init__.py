"""Causal GQA prefill attention: CUDA kernel, wrapper, its gradient and
plain version."""
from repro_torch.kernels.flash_prefill.ops import (flash_prefill,
                                                   prefill_attention)
from repro_torch.kernels.flash_prefill.autograd import (flash_prefill_bwd,
                                                        flash_prefill_grad)
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
