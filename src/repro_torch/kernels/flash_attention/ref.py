"""Plain PyTorch attention: the flash kernel's reference.

A port of the reference's `flash_attention/ref.py`: kernel layout
``(B, H, Sq, d)`` for q and ``(B, Kv, Sk, d)`` for k and v, scores and
softmax in f32, KV repeated for GQA (query head ``h`` reads KV head
``h // (H / Kv)``), start-aligned positions (a pair is live iff
``q_pos >= k_pos`` when causal and ``q_pos - k_pos < window`` when
``window > 0``), the result in q's dtype. CPU tensors take this path; the
CUDA kernel is held against it on the card. The score tensor is scaled
and masked in place, which keeps two ``(B, H, Sq, Sk)`` f32 tensors
alive at the peak instead of four.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, d)
    k: torch.Tensor,  # (B, Kv, Sk, d)
    v: torch.Tensor,  # (B, Kv, Sk, d)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    _, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kv != h:
        k = torch.repeat_interleave(k, h // kv, dim=1)
        v = torch.repeat_interleave(v, h // kv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s.mul_(scale)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= (qp - kp) < window
    s.masked_fill_(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
