"""Public stream-reduce ops: dispatch by the tensor's device alone.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
takes the plain version. ``impl="ref"`` runs the plain version on
purpose (tests and the chip smoke); the stream channel never passes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.stream_reduce.ref import chunk_accumulate_ref, histogram_ref
from repro_torch.kernels.stream_reduce.stream_reduce import (
    chunk_accumulate_kernel,
    histogram_kernel,
)


def _check_impl(impl):
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r} (use 'ref' or None)")


def accumulate(elements: torch.Tensor, *, impl: str | None = None) -> torch.Tensor:
    """(n, S) -> (S,) f32 column sum (the reducer group's chunk fold)."""
    _check_impl(impl)
    if impl is None and elements.is_cuda:
        return chunk_accumulate_kernel(elements)
    return chunk_accumulate_ref(elements)


def keyed_histogram(keys: torch.Tensor, counts: torch.Tensor, n_bins: int, *,
                    impl: str | None = None) -> torch.Tensor:
    """keys (N,) int32 (negative = padding), counts (N,) -> (n_bins,) f32."""
    _check_impl(impl)
    if impl is None and keys.is_cuda:
        return histogram_kernel(keys, counts, n_bins)
    return histogram_ref(keys, counts, n_bins)


__all__ = ["accumulate", "keyed_histogram"]
