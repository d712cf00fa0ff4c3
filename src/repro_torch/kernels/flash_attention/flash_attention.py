"""Wrapper of the hand-written CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``), which replaces the reference's
Pallas `flash_attention`.

Kernel layout ``(B, H, Sq, d)`` for q and ``(B, Kv, Sk, d)`` for k and
v, read through their strides: only the head dimension must be
contiguous, so the model layout ``(B, S, H, d)`` passes in as a
transposed view with no copy. The output is allocated with q's strides,
so a transposed-view q gives an output whose transpose is contiguous.
In bf16 at head dims 64 and 128 the kernel reads K and V with the TMA
unit, which needs a 16-byte-aligned base and 16-byte-aligned strides: a
K or V view that has neither (rows 129 elements apart, say) is copied to
a contiguous tensor first. Q is read by the kernel's own loads and is
never copied.
The wrapper checks devices, dtypes, shapes and strides, launches on
PyTorch's current stream and counts the launch in
``flash_attention_kernel.launches``. The library is built and loaded on
the first call, never at import.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import runtime

_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instances
TMA_HEAD_DIMS = (64, 128)  # bf16 at these reads K and V through TMA


def tma_readable(t: torch.Tensor) -> bool:
    """Whether the TMA unit can read ``t`` (B, Kv, Sk, d) bf16 through its
    strides: a 16-byte-aligned base, and every stride of a dimension
    longer than 1 positive and a multiple of 16 bytes."""
    if t.data_ptr() % 16:
        return False
    return all(st > 0 and (st * t.element_size()) % 16 == 0
               for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _entry():
    fn = runtime.load("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, sequence) strides in elements."""
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_kernel(
    q: torch.Tensor,  # (B, H, Sq, d) f32 or bf16
    k: torch.Tensor,  # (B, Kv, Sk, d)
    v: torch.Tensor,  # (B, Kv, Sk, d)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused causal/windowed GQA attention on the GPU. Returns
    (B, H, Sq, d) in q's dtype, with q's strides."""
    runtime.require_cuda("flash_attention_kernel", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, H, Sq, d) and k, v (B, Kv, Sk, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    _, n_kv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or n_kv == 0 or h % n_kv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same batch and head dim, H a multiple of Kv)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel: head dim {d} is not one of {HEAD_DIMS}")
    if q.dtype not in _CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be f32 or all bf16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension of q, k and v must be contiguous")
    window = max(int(window), 0)
    if sk == 0 or (window and sq - sk >= window):
        raise ValueError(f"Sq={sq}, Sk={sk}, window={window}: some query rows have no "
                         "live key, which the kernel does not take")
    if sq * (h // n_kv) >= 2**31:
        raise ValueError(f"Sq * H / Kv = {sq * (h // n_kv)} rows exceed the kernel's int32 grid")
    out = torch.empty_like(q)
    if b == 0 or sq == 0 or h == 0:
        return out
    if q.dtype == torch.bfloat16 and d in TMA_HEAD_DIMS:
        k = k if tma_readable(k) else k.contiguous()
        v = v if tma_readable(v) else v.contiguous()
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    rc = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n_kv, sq, sk, d,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        int(causal), window, scale, _CODE[q.dtype], runtime.stream_handle(q),
    )
    runtime.check(rc, "flash_attention_kernel")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0

__all__ = ["flash_attention_kernel", "HEAD_DIMS"]
