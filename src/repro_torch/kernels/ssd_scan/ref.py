"""Plain versions of the SSD scan: the kernel's reference.

`ssd_ref` is the model's own chunked scan (`models.ssm.ssd_chunked`) and
returns ``(y, final_state)``, the two outputs of the CUDA kernel (the
reference's `ssd_ref` returns y alone; prefill needs the state too).
`ssd_naive` is the O(S) per-step recurrence both must match.
"""
from __future__ import annotations

import torch

from repro_torch.models.ssm import ssd_chunked


def ssd_ref(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """-> (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32)."""
    return ssd_chunked(x, dt, A, Bm, Cm, chunk)


def ssd_naive(x, dt, A, Bm, Cm):
    """Per-step recurrence h <- exp(dt A) h + dt x B^T, y = h C, in f32.
    -> (y in x's dtype, final_state f32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    A = A.float()
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()
        decay = torch.exp(dtt * A)  # (b,h)
        outer = torch.einsum("bh,bhp,bn->bhpn", dtt, x[:, t].float(), Bm[:, t].float())
        state = decay[..., None, None] * state + outer
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), state
