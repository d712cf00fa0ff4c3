"""Wrapper of the hand-written CUDA paged decode-attention kernel
(``kernels/csrc/paged_attention.cu``), which replaces the reference's
Pallas `paged_decode_attention_kernel`.

The wrapper checks devices, dtypes, shapes and contiguity, picks the
split (`split_span`), allocates the output and the splits' f32 scratch,
launches on PyTorch's current stream and counts the launch in
``paged_decode_attention_kernel.launches``. The library is built and
loaded on the first call, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the kernel's limits: a warp serves up to 4 query heads of a KV group (4
# warps), a block of 128 threads holds the group's (rep, hd) accumulators,
# at most 16 each, one output column per thread (so hd divides 128), and a
# split block stages three tiles of 32 K and V rows,
# q in f32, the tile's probabilities and the split's page list in at most
# the 227 KB of shared memory a block may have
MAX_GROUP_HEADS = 16
MAX_GROUP_WIDTH = 128 * 16
SMEM_BYTES = 227 * 1024
TILE = 32  # pool positions per tile
STAGES = 3  # tiles in flight in a split block
# split the walk until B * n_kv * n_splits reaches two blocks per SM of an H100
TARGET_BLOCKS = 2 * 132


def split_span(b: int, n_kv: int, total: int, bs: int) -> int:
    """Positions per split for a batch of ``b`` slots, ``n_kv`` KV heads and
    a view of ``total = mb * bs`` positions: the largest multiple of the
    block size ``bs`` (or of the 32-position tile, where a block holds
    more positions than a split should) that still gives at least
    `TARGET_BLOCKS` split blocks. A function of shapes only, never of the
    cursors, which live on the device."""
    raw = max(1, total * b * n_kv // TARGET_BLOCKS)
    unit = bs if bs <= raw else TILE
    return max(unit, raw // unit * unit)


def smem_bytes(rep: int, hd: int, elt: int, span: int, bs: int) -> int:
    """Shared memory a split block asks for at a (rep, hd) group over a
    pool of ``elt``-byte elements (mirrors ``split_smem`` in the source)."""
    n_pages = -(-span // bs) + 1
    return 2 * STAGES * TILE * (hd * elt + 16) + 2 * STAGES * TILE * 4 \
        + 4 * (rep * hd + rep * TILE + rep) + 4 * n_pages


def _entry():
    fn = runtime.load("paged_attention").paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
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
    """Split-K streaming-softmax decode attention over a block pool on the
    GPU: two launches (the split walk, then the combine), counted as one.
    Each split covers `split_span` positions of the view. Returns
    (B, 1, H, hd) in q's dtype."""
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
    elt = k_blocks.element_size()
    span = split_span(b, n_kv, mb * bs, bs)
    what = f"paged_decode_attention_kernel: a KV group of {rep} query heads of {hd}"
    if rep > MAX_GROUP_HEADS:
        raise ValueError(f"{what} exceeds the kernel's {MAX_GROUP_HEADS} query heads per group")
    if rep * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"{what} ({rep * hd} outputs) exceeds the kernel's {MAX_GROUP_WIDTH}")
    if 128 % hd:
        raise ValueError(f"{what}: the kernel takes head dims that divide 128")
    if (hd * elt) % 16:
        raise ValueError(f"{what}: a row of {hd} x {elt} bytes is not a whole number of the "
                         "kernel's 16-byte copies")
    need = smem_bytes(rep, hd, elt, span, bs)
    if need > SMEM_BYTES:
        raise ValueError(f"{what} needs {need} bytes of shared memory, over the kernel's "
                         f"{SMEM_BYTES}")
    n_splits = -(-(mb * bs) // span)  # about TARGET_BLOCKS / (B * n_kv): a few KB to combine
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
    if k_blocks.data_ptr() % 16 or v_blocks.data_ptr() % 16:
        raise ValueError("pools must start on a 16-byte boundary (the kernel's copies)")
    q = q.contiguous()
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    table = table.contiguous()
    pos = pos.contiguous()
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    if b == 0:
        return out[:, None]
    # per split: the unnormalised (rep, hd) accumulator and (m, l) per head
    part_acc = torch.empty((b, n_kv, n_splits, rep, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, n_kv, n_splits, rep, 2), dtype=torch.float32, device=q.device)
    rc = _entry()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_blocks.data_ptr(),
        v_blocks.data_ptr(), _ptr(k_scale), _ptr(v_scale), table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        b, n_kv, rep, hd, bs, mb, int(window), span,
        float(scale), _Q_CODE[q.dtype], _KV_CODE[k_blocks.dtype], runtime.stream_handle(q),
    )
    runtime.check(rc, "paged_decode_attention_kernel")
    paged_decode_attention_kernel.launches += 1
    return out[:, None]


paged_decode_attention_kernel.launches = 0

__all__ = ["paged_decode_attention_kernel", "split_span"]
