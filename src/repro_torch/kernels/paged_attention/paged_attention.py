"""Wrapper of the hand-written CUDA paged decode-attention kernel
(``kernels/csrc/paged_attention.cu``), which replaces the reference's
Pallas `paged_decode_attention_kernel`.

The wrapper checks devices, dtypes, shapes and contiguity, allocates the
output, launches on PyTorch's current stream and counts the launch in
``paged_decode_attention_kernel.launches``. The library is built and
loaded on the first call, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the kernel's limits: a block of 128 threads holds the (rep, hd) group's
# accumulators, at most 16 each, and stages q, one 32-position K/V tile
# and the group's scores in at most 48 KB of shared memory
MAX_GROUP_WIDTH = 128 * 16
SMEM_BYTES = 48 * 1024


def smem_bytes(rep: int, hd: int) -> int:
    """Shared memory the kernel asks for at a (rep, hd) group."""
    return 4 * (rep * hd + 32 * (hd + 1) + 32 * hd + rep * 32 + 3 * rep)


def _entry():
    fn = runtime.load("paged_attention").paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def paged_decode_attention_kernel(
    q: torch.Tensor,         # (B, 1, H, hd) f32 or bf16
    k_new: torch.Tensor,     # (B, d_kv)
    v_new: torch.Tensor,     # (B, d_kv)
    k_blocks: torch.Tensor,  # (nb, bs, d_kv) f32, bf16 or int8 pool, one layer
    v_blocks: torch.Tensor,
    table: torch.Tensor,     # (B, mb) int32
    pos: torch.Tensor,       # (B,) int32
    *,
    n_kv: int,
    window: int,
    scale: float,
    k_scale: torch.Tensor | None = None,  # (nb, bs) f32, int8 pools only
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Streaming-softmax decode attention over a block pool on the GPU.
    Returns (B, 1, H, hd) in q's dtype."""
    runtime.require_cuda("paged_decode_attention_kernel", q, k_new, v_new,
                         k_blocks, v_blocks, table, pos, k_scale, v_scale)
    b, one, h, hd = q.shape
    if one != 1 or h % n_kv:
        raise ValueError(f"q must be (B, 1, H, hd) with H % n_kv == 0, got {tuple(q.shape)}")
    nb, bs, d_kv = k_blocks.shape
    mb = table.shape[1]
    if d_kv != n_kv * hd or v_blocks.shape != k_blocks.shape:
        raise ValueError(f"pools must be (nb, bs, {n_kv * hd}), got "
                         f"{tuple(k_blocks.shape)} and {tuple(v_blocks.shape)}")
    if q.dtype not in _Q_CODE or k_blocks.dtype not in _KV_CODE:
        raise TypeError(f"unsupported dtypes q={q.dtype} pool={k_blocks.dtype}")
    if v_blocks.dtype != k_blocks.dtype:
        raise TypeError("k and v pools must share a dtype")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("table and pos must be int32")
    if table.shape[0] != b or pos.shape != (b,) or k_new.shape != (b, d_kv) \
            or v_new.shape != (b, d_kv):
        raise ValueError("table (B, mb), pos (B,) and k_new/v_new (B, d_kv) must match q")
    rep = h // n_kv
    if rep * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"paged_decode_attention_kernel: a KV group of {rep} query heads of "
                         f"{hd} ({rep * hd} outputs) exceeds the kernel's {MAX_GROUP_WIDTH}")
    if smem_bytes(rep, hd) > SMEM_BYTES:
        raise ValueError(f"paged_decode_attention_kernel: a KV group of {rep} query heads of "
                         f"{hd} needs {smem_bytes(rep, hd)} bytes of shared memory, over the "
                         f"kernel's {SMEM_BYTES}")
    quantized = k_blocks.dtype == torch.int8
    if quantized:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 KV blocks need k_scale/v_scale")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != (nb, bs) or not s.is_contiguous():
                raise ValueError("scales must be contiguous f32 (nb, bs)")
    else:
        k_scale = v_scale = None
    if not (k_blocks.is_contiguous() and v_blocks.is_contiguous()):
        raise ValueError("pools must be contiguous")
    q = q.contiguous()
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    table = table.contiguous()
    pos = pos.contiguous()
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    if b == 0:
        return out[:, None]
    rc = _entry()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_blocks.data_ptr(),
        v_blocks.data_ptr(), _ptr(k_scale), _ptr(v_scale), table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, n_kv, rep, hd, bs, mb, int(window),
        float(scale), _Q_CODE[q.dtype], _KV_CODE[k_blocks.dtype], runtime.stream_handle(q),
    )
    runtime.check(rc, "paged_decode_attention_kernel")
    paged_decode_attention_kernel.launches += 1
    return out[:, None]


paged_decode_attention_kernel.launches = 0

__all__ = ["paged_decode_attention_kernel"]
