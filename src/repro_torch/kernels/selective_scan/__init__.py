"""Mamba-1 selective scan: CUDA kernels (forward and backward), wrappers,
their autograd path and plain versions."""
from repro_torch.kernels.selective_scan.ops import (selective_scan,
                                                    selective_scan_bwd)
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
from repro_torch.kernels.selective_scan.autograd import (SelectiveScan,
                                                         selective_scan_grad)
