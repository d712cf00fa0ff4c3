"""Public fused last-token sampling op.

`sample_last(logits)` is the engines' greedy sampler: slice the last
position and reduce the vocab axis. Dispatch is by the tensor's device
alone: k=1 on a CUDA tensor launches the CUDA argmax kernel, on a CPU
tensor it takes the plain version. k>1 takes `torch.topk` on the last
row, as the reference takes `lax.top_k` there. With ``key=`` (k=1 only)
it is the seeded categorical draw, plain PyTorch on every device, as
the reference's is plain jnp. ``impl="ref"`` runs the plain version on
purpose (tests and the chip smoke); the engine never passes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sample.ref import sample_last_ref, sample_last_seeded_ref
from repro_torch.kernels.sample.sample import argmax_last_kernel


def sample_last(logits: torch.Tensor, *, k: int = 1, key=None,
                impl: str | None = None) -> torch.Tensor:
    """Greedy (k=1 -> (B,) int32) or top-k (-> (B, k) int32) ids of the
    last position of (B, S, V) logits; with ``key`` (a `utils.prng.Key`,
    k=1 only) a seeded draw from its softmax."""
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r} (use 'ref' or None)")
    if key is not None:
        if k != 1:
            raise ValueError("seeded sampling (key=) requires k=1")
        return sample_last_seeded_ref(logits, key)
    if k == 1 and impl is None and logits.is_cuda:
        return argmax_last_kernel(logits[:, -1])
    return sample_last_ref(logits, k)
