"""Batched Sinkhorn: CUDA kernel, wrapper and plain version."""
from repro_torch.kernels.sinkhorn.ops import sinkhorn_plan
from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref
