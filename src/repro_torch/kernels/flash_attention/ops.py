"""Public flash-attention op in the model layout, the one prefill calls
once per layer on the card.

`mha(q, k, v)` takes ``(B, S, H, d)`` tensors, as `models.layers` keeps
them, and hands the kernel transposed views (no copy). Dispatch is by
the tensor's device alone: a CPU tensor takes the plain version
(`ref.attention_ref`), a CUDA tensor launches the CUDA kernel or raises.
``impl="ref"`` runs the plain version on purpose (tests and the chip
smoke use it to hold the kernel against it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def mha(
    q: torch.Tensor,  # (B, Sq, H, d)
    k: torch.Tensor,  # (B, Sk, Kv, d)
    v: torch.Tensor,  # (B, Sk, Kv, d)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """Causal/windowed GQA attention -> (B, Sq, H, d) in q's dtype."""
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r} (use 'ref' or None)")
    fn = flash_attention_kernel if impl is None and q.is_cuda else attention_ref
    out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             causal=causal, window=window, scale=scale)
    return out.transpose(1, 2)
