"""Public SSD-scan op, the one `models.ssm.mamba_block` calls once per
layer of a prefill.

`ssd(x, dt, A, Bm, Cm, chunk=...)` -> ``(y, final_state)``. Dispatch is
by the tensor's device alone: a CPU tensor takes the plain version
(`ref.ssd_ref`, the model's chunked scan), a CUDA tensor launches the
CUDA kernel or raises. ``impl="ref"`` runs the plain version on purpose
(tests and the chip smoke use it to hold the kernel against it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_kernel


def ssd(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) f32
    A: torch.Tensor,   # (H,) f32
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 256,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan from a zero state -> (y (B,S,H,P) in x's dtype,
    final_state (B,H,P,N) f32)."""
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r} (use 'ref' or None)")
    fn = ssd_scan_kernel if impl is None and x.is_cuda else ssd_ref
    return fn(x, dt, A, Bm, Cm, chunk=chunk)
