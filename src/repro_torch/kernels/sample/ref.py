"""Plain PyTorch last-token sampling: the kernel's reference.

A port of the reference's `sample/ref.py`: k=1 is the argmax of the last
position (ties to the first maximal index), k>1 the top-k ids of that
row, and the seeded draw a categorical over the last position from the
port's counter-based generator (`utils.prng`), plain PyTorch on every
device as the reference's is plain jnp.
"""
from __future__ import annotations

import torch

from repro_torch.utils import prng


def sample_last_ref(logits: torch.Tensor, k: int = 1) -> torch.Tensor:
    """(B, S, V) logits -> (B,) int32 token ids (k=1) or (B, k) int32."""
    last = logits[:, -1]
    if k == 1:
        return torch.argmax(last, dim=-1).to(torch.int32)
    return torch.topk(last, k, dim=-1).indices.to(torch.int32)


def sample_last_seeded_ref(logits: torch.Tensor, key: prng.Key) -> torch.Tensor:
    """Seeded categorical over the last position: (B, S, V) logits and a
    key -> (B,) int32 ids, by the Gumbel-max trick. A fixed key and logits
    give a fixed draw, ties included (the Gumbel noise breaks them), which
    is what lets speculative rejection sampling replay."""
    return prng.categorical(key, logits[:, -1], dim=-1).to(torch.int32)


__all__ = ["sample_last_ref", "sample_last_seeded_ref"]
