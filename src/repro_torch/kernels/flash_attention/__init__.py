"""Fused causal/windowed GQA attention: plain version, CUDA kernel, op."""
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["mha", "flash_attention_kernel", "attention_ref"]
