"""Fused last-token sampling: plain version, CUDA argmax kernel, op."""
from repro_torch.kernels.sample.ops import sample_last
from repro_torch.kernels.sample.ref import sample_last_ref
from repro_torch.kernels.sample.sample import argmax_last_kernel

__all__ = ["sample_last", "sample_last_ref", "argmax_last_kernel"]
