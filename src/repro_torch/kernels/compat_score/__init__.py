"""Task-server compatibility scores (hw+load, and the fused hw+load+warm):
CUDA kernels, wrappers and plain versions."""
from repro_torch.kernels.compat_score.ops import (compat_score, fused_score,
                                                  score_matrix)
from repro_torch.kernels.compat_score.ref import (compat_score_ref,
                                                  fused_score_ref)
