"""Fused multi-region micro greedy: CUDA kernel, wrapper and plain
version."""
from repro_torch.kernels.greedy_assign.ops import (MAX_AGE, GreedyInputs,
                                                   ScoreConsts, greedy_assign)
from repro_torch.kernels.greedy_assign.ref import greedy_assign_ref
