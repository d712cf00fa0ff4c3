"""Plain PyTorch last-token sampling: the kernel's reference.

A port of the reference's `sample/ref.py`: k=1 is the argmax of the last
position (ties to the first maximal index), k>1 the top-k ids of that
row. The seeded draw (``key=``) belongs to speculative decoding and is
not ported yet (ROADMAP A6).
"""
from __future__ import annotations

import torch


def sample_last_ref(logits: torch.Tensor, k: int = 1) -> torch.Tensor:
    """(B, S, V) logits -> (B,) int32 token ids (k=1) or (B, k) int32."""
    last = logits[:, -1]
    if k == 1:
        return torch.argmax(last, dim=-1).to(torch.int32)
    return torch.topk(last, k, dim=-1).indices.to(torch.int32)


__all__ = ["sample_last_ref"]
