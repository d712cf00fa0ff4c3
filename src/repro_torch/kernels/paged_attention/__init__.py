"""Paged single-token decode attention: plain version, CUDA kernel, op."""
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_decode_attention_kernel,
    split_span,
)
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

__all__ = [
    "paged_decode_attention",
    "paged_decode_attention_kernel",
    "paged_decode_attention_ref",
    "split_span",
]
