"""Decode attention against a KV cache: CUDA kernel, wrapper and plain
version."""
from repro_torch.kernels.flash_decode.ops import (decode_attention,
                                                  flash_decode)
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
