"""Mamba-1 selective scan: CUDA kernel, wrapper and plain version."""
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
