"""Wrapper of the hand-written CUDA last-token argmax kernel
(``kernels/csrc/argmax_last.cu``), which replaces the reference's Pallas
`argmax_last_kernel`.

Takes the (B, V) last-position rows, strided or not (the last dimension
must be contiguous), and returns (B,) int32. Counts each launch in
``argmax_last_kernel.launches``. The library is built and loaded on the
first call, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = runtime.load("argmax_last").argmax_last
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def argmax_last_kernel(last: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab axis of (B, V) f32/bf16 rows -> (B,) int32."""
    runtime.require_cuda("argmax_last_kernel", last)
    if last.ndim != 2 or last.dtype not in _CODE:
        raise TypeError(f"want (B, V) f32/bf16 rows, got {tuple(last.shape)} {last.dtype}")
    b, vocab = last.shape
    if vocab == 0:
        raise ValueError("argmax over an empty vocabulary")
    if last.stride(1) != 1:
        last = last.contiguous()
    out = torch.empty((b,), dtype=torch.int32, device=last.device)
    if b == 0:
        return out
    rc = _entry()(last.data_ptr(), last.stride(0), b, vocab, _CODE[last.dtype],
                  out.data_ptr(), runtime.stream_handle(last))
    runtime.check(rc, "argmax_last_kernel")
    argmax_last_kernel.launches += 1
    return out


argmax_last_kernel.launches = 0

__all__ = ["argmax_last_kernel"]
