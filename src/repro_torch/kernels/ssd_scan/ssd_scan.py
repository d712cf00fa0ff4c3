"""Wrapper of the hand-written CUDA SSD chunked-scan kernel
(``kernels/csrc/ssd_scan.cu``), which replaces the reference's Pallas
`ssd_scan`.

What the kernel takes: x ``(B, S, H, P)`` and Bm, Cm ``(B, S, N)``, all
f32 or all bf16, read through their strides with only the last
dimension contiguous (so the column slices of the model's conv output
pass in with no copy); dt ``(B, S, H)`` and A ``(H,)`` in f32; head dim
P of 32 or 64; state size N up to 128; chunk Q up to 256. It returns y
``(B, S, H, P)`` in x's dtype (contiguous) and the state after the last
position, ``(B, H, P, N)`` f32. One call is three CUDA launches (chunk
states, the pass over chunks, the outputs) and counts as one launch in
``ssd_scan_kernel.launches``. bf16 inputs run the tensor-core body, f32
inputs the exact CUDA-core body; there is no other route. The wrapper
allocates the f32 scratch (``(B, ceil(S/Q), H, P, ns)`` states, ns = N
for f32 and N rounded up to a multiple of 16 for bf16, and
``(B, ceil(S/Q), H)`` decays), launches on PyTorch's current stream and
never synchronises. The library is built and loaded on the first call,
never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)  # the kernel's template instances
MAX_STATE = 128
MAX_CHUNK = 256


def _entry():
    fn = runtime.load("ssd_scan").ssd_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 13 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ssd_scan_kernel(
    x: torch.Tensor,   # (B, S, H, P) f32 or bf16
    dt: torch.Tensor,  # (B, S, H) f32
    A: torch.Tensor,   # (H,) f32
    Bm: torch.Tensor,  # (B, S, N), x's dtype
    Cm: torch.Tensor,  # (B, S, N), x's dtype
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunked scan on the GPU from a zero state -> (y, final_state)."""
    runtime.require_cuda("ssd_scan_kernel", x, dt, A, Bm, Cm)
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"want x (B,S,H,P), dt (B,S,H), A (H,), Bm and Cm (B,S,N), got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    b, s, h, p = x.shape
    n = Bm.shape[2]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or tuple(Bm.shape[:2]) != (b, s):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm {tuple(Bm.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_scan_kernel: head dim {p} is not one of {HEAD_DIMS}")
    if not 1 <= n <= MAX_STATE or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan_kernel takes 1 <= N <= {MAX_STATE} and 1 <= chunk <= "
                         f"{MAX_CHUNK}, got N={n}, chunk={chunk}")
    if x.dtype not in _CODE or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must all be f32 or all bf16, got {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be f32, got {dt.dtype}, {A.dtype}")
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1 or A.stride(0) != 1:
        raise ValueError("the last dimension of x, Bm and Cm, and A, must be contiguous")
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    if b == 0 or s == 0 or h == 0:
        return y, final
    nc = -(-s // chunk)
    ns = n if x.dtype == torch.float32 else -(-n // 16) * 16
    states = torch.empty((b, nc, h, p, ns), dtype=torch.float32, device=x.device)
    decay = torch.empty((b, nc, h), dtype=torch.float32, device=x.device)
    rc = _entry()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
        final.data_ptr(), states.data_ptr(), decay.data_ptr(), b, s, h, p, n, chunk,
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), y.stride(0), y.stride(1),
        y.stride(2), _CODE[x.dtype], runtime.stream_handle(x),
    )
    runtime.check(rc, "ssd_scan_kernel")
    ssd_scan_kernel.launches += 1
    return y, final


ssd_scan_kernel.launches = 0

__all__ = ["ssd_scan_kernel", "HEAD_DIMS"]
