"""Plain PyTorch versions of the stream-reduce kernels.

`chunk_accumulate_ref` is the reference's `chunk_accumulate_ref`: the
column sum of an (n, S) buffer in f32. It is also the one PyTorch call
that computes the kernel's function (`torch.sum(x, 0)`).

`histogram_ref` computes what the TPU kernel `histogram` computes: keys
< 0 (padding) and keys >= ``n_bins`` add nothing. The reference's own
`histogram_ref` differs from its kernel there: it clamps keys >= n_bins
into the last bin (ROADMAP C); on keys in range the three agree.
"""
from __future__ import annotations

import torch


def chunk_accumulate_ref(elements: torch.Tensor) -> torch.Tensor:
    """(n, S) any float -> (S,) f32: out[j] = sum_k elements[k, j]."""
    return elements.float().sum(0)


def histogram_ref(keys: torch.Tensor, counts: torch.Tensor, n_bins: int, *,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """keys (N,) int, counts (N,) float -> (n_bins,) f32 keyed sums, added
    into ``out`` (a (n_bins,) f32 accumulator) where one is given."""
    valid = (keys >= 0) & (keys < n_bins)
    if out is None:
        out = torch.zeros((n_bins,), dtype=torch.float32, device=keys.device)
    return out.index_add_(0, keys[valid].long(), counts[valid].float())


__all__ = ["chunk_accumulate_ref", "histogram_ref"]
