"""Plain PyTorch paged decode attention: the kernel's reference.

A port, op for op, of the reference's `paged_attention/ref.py`: gather a
slot's blocks into a contiguous view (``-1`` table entries clamp to the
zero block 0), lane-insert the step's new K/V row at each slot's cursor
(a cursor at or past the view length writes nothing), then run
`layers.attention_decode`. int8 pools are dequantised with their per-row
scales to ``dequant_dtype`` first. CPU tensors take this path; the CUDA
kernel is held against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers


def gather_blocks(blocks: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One layer's block-table gather: (nb, bs, d), (B, mb) -> (B, mb*bs, d)."""
    _, bs, d = blocks.shape
    b, mb = table.shape
    picked = blocks.index_select(0, table.clamp(min=0).reshape(-1).long())
    return picked.reshape(b, mb * bs, d)


def dequant_blocks(q8: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """(nb, bs, d) int8 + (nb, bs) per-row scales -> fp blocks."""
    return (q8.float() * scale[..., None]).to(dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,         # (B, 1, H, hd)
    k_new: torch.Tensor,     # (B, d_kv) this step's K row (flattened layout)
    v_new: torch.Tensor,     # (B, d_kv)
    k_blocks: torch.Tensor,  # (nb, bs, d_kv) one layer's pool (fp or int8)
    v_blocks: torch.Tensor,
    table: torch.Tensor,     # (B, mb) int32, -1 = unmapped
    pos: torch.Tensor,       # (B,) int32 per-slot cursors
    *,
    n_kv: int,
    window: int,
    scale: float,
    k_scale: torch.Tensor | None = None,  # (nb, bs) f32, int8 pools only
    v_scale: torch.Tensor | None = None,
    dequant_dtype=torch.bfloat16,
) -> torch.Tensor:
    """One decode step of attention over a block pool -> (B, 1, H, hd)."""
    if k_blocks.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 KV blocks need k_scale/v_scale")
        k_blocks = dequant_blocks(k_blocks, k_scale, dequant_dtype)
        v_blocks = dequant_blocks(v_blocks, v_scale, dequant_dtype)
    kc = gather_blocks(k_blocks, table)
    vc = gather_blocks(v_blocks, table)
    lane = (torch.arange(kc.shape[1], device=kc.device)[None, :]
            == pos.long()[:, None])[:, :, None]
    kc = torch.where(lane, k_new[:, None, :].to(kc.dtype), kc)
    vc = torch.where(lane, v_new[:, None, :].to(vc.dtype), vc)
    return layers.attention_decode(q, kc, vc, n_kv, pos + 1, window, scale)


__all__ = ["paged_decode_attention_ref", "gather_blocks", "dequant_blocks"]
