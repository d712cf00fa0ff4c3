"""Public stream-reduce ops: dispatch by the tensor's device alone.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
takes the plain version. ``impl="ref"`` runs the plain version on
purpose (tests and the chip smoke); the stream channel never passes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.stream_reduce.ref import chunk_accumulate_ref, histogram_ref
from repro_torch.kernels.stream_reduce.stream_reduce import (
    check_hist_out,
    chunk_accumulate_kernel,
    histogram_kernel,
)


def _check_impl(impl):
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r} (use 'ref' or None)")


def accumulate(elements: torch.Tensor, *, out: torch.Tensor | None = None,
               impl: str | None = None) -> torch.Tensor:
    """(n, S) -> (S,) f32 column sum (the reducer group's chunk fold),
    into ``out`` (which may be a row of ``elements``) where given."""
    _check_impl(impl)
    if impl is None and elements.is_cuda:
        return chunk_accumulate_kernel(elements, out=out)
    return chunk_accumulate_ref(elements, out=out)


def keyed_histogram(keys: torch.Tensor, counts: torch.Tensor, n_bins: int, *,
                    out: torch.Tensor | None = None, impl: str | None = None) -> torch.Tensor:
    """keys (N,) int32 (negative = padding), counts (N,) -> (n_bins,) f32;
    with ``out`` (a contiguous (n_bins,) f32 accumulator on the keys'
    device) the sums are added into it in place."""
    _check_impl(impl)
    if impl is None and keys.is_cuda:
        return histogram_kernel(keys, counts, n_bins, out=out)
    if out is not None:
        check_hist_out(out, keys, n_bins)
    return histogram_ref(keys, counts, n_bins, out=out)


__all__ = ["accumulate", "keyed_histogram"]
