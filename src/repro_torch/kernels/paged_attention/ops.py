"""Public paged decode-attention op, the one the decode step calls once
per layer.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version (`ref.py`), a CUDA tensor launches the CUDA kernel or raises.
``impl="ref"`` runs the plain version on purpose (tests and the chip
smoke use it to hold the kernel against it). The engine never passes
``impl``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.paged_attention import (
    paged_decode_attention_kernel,
)
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref


def paged_decode_attention(
    q: torch.Tensor,         # (B, 1, H, hd)
    k_new: torch.Tensor,     # (B, d_kv)
    v_new: torch.Tensor,     # (B, d_kv)
    k_blocks: torch.Tensor,  # (nb, bs, d_kv) fp or int8 pool, one layer
    v_blocks: torch.Tensor,
    table: torch.Tensor,     # (B, mb) int32
    pos: torch.Tensor,       # (B,) int32
    *,
    n_kv: int,
    window: int,
    scale: float,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    dequant_dtype=None,  # int8 plain path only; the kernel dequantises in f32
    impl: str | None = None,
) -> torch.Tensor:
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r} (use 'ref' or None)")
    if impl is None and q.is_cuda:
        return paged_decode_attention_kernel(
            q, k_new, v_new, k_blocks, v_blocks, table, pos,
            n_kv=n_kv, window=window, scale=scale, k_scale=k_scale, v_scale=v_scale,
        )
    kw = {} if dequant_dtype is None else {"dequant_dtype": dequant_dtype}
    return paged_decode_attention_ref(
        q, k_new, v_new, k_blocks, v_blocks, table, pos,
        n_kv=n_kv, window=window, scale=scale, k_scale=k_scale, v_scale=v_scale, **kw,
    )
