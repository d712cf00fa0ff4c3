"""KV-cache operators of the serving path: slot migration, the paged
block pool's gather and fill, and the int8 row codec.

The reference's operators are pure (`.at[].set` returns a new array);
the port's writers update their destination tensors IN PLACE and return
them, so a pool is never copied. Block 0 of a pool is the permanent zero
block: table entries of -1 clamp to it on gather, which makes the
gathered view of a partly allocated slot equal to the zero-extended
dense cache.
"""
from __future__ import annotations

import torch


def migrate_cache_into_slot(dst_cache: dict, src_cache: dict, slot: int) -> dict:
    """Write a batch-1 cache ``(L, 1, s, d)`` into slot ``slot`` of a
    batched ``(L, B, S, d)`` cache, zero-extended to S so the previous
    occupant's KV never leaks. In place; the shared ``pos`` advances to
    ``max(dst pos, src pos)``."""
    for key, src in src_cache.items():
        if key == "pos":
            continue
        if src.shape[1] != 1:
            raise ValueError(f"{key}: source cache must be batch-1, got {tuple(src.shape)}")
        dst = dst_cache[key]
        s = src.shape[2]
        dst[:, slot, s:] = 0
        dst[:, slot, :s] = src[:, 0].to(dst.dtype)
    if "pos" in dst_cache and "pos" in src_cache:
        dst_cache["pos"] = torch.maximum(dst_cache["pos"],
                                         torch.as_tensor(src_cache["pos"]).to(dst_cache["pos"]))
    return dst_cache


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Block-table gather: (L, n_blocks, bs, d), (B, mb) -> (L, B, mb*bs, d).
    Entries < 0 read block 0, the zero block."""
    ln, _, bs, d = pool.shape
    b, mb = table.shape
    picked = pool.index_select(1, table.clamp(min=0).reshape(-1).long())
    return picked.reshape(ln, b, mb * bs, d)


def paged_gather_cache(k_pool, v_pool, table, lens) -> dict:
    """The full decode-view cache: gathered k/v + per-slot cursors."""
    return {
        "k": paged_gather(k_pool, table),
        "v": paged_gather(v_pool, table),
        "pos": torch.as_tensor(lens, dtype=torch.int32, device=k_pool.device),
    }


def blockify_cache_leaf(leaf: torch.Tensor, start: int, n_blocks: int,
                        block_size: int) -> torch.Tensor:
    """(L, 1, s, d) per-request cache leaf -> (L, n_blocks, bs, d) block
    rows covering positions [start, start + n_blocks*bs), zero-padded
    past the leaf's end."""
    ln, one, s, d = leaf.shape
    if one != 1:
        raise ValueError(f"per-request cache leaf must be batch-1, got {tuple(leaf.shape)}")
    span = n_blocks * block_size
    window = torch.zeros((ln, span, d), dtype=leaf.dtype, device=leaf.device)
    take = max(0, min(s - start, span))
    window[:, :take] = leaf[:, 0, start : start + take]
    return window.reshape(ln, n_blocks, block_size, d)


def migrate_cache_into_blocks(k_pool, v_pool, cache1: dict, block_ids: torch.Tensor,
                              *, start: int, block_size: int):
    """Write a batch-1 prefill cache's positions [start, ...) into the
    freshly allocated pool blocks ``block_ids``, in place. ``start`` is
    the shared-prefix boundary (0 on a cold admit)."""
    n = int(block_ids.shape[0])
    if n == 0:
        return k_pool, v_pool
    ids = block_ids.to(device=k_pool.device, dtype=torch.long)
    k_pool[:, ids] = blockify_cache_leaf(cache1["k"].to(k_pool.dtype), start, n, block_size)
    v_pool[:, ids] = blockify_cache_leaf(cache1["v"].to(v_pool.dtype), start, n, block_size)
    return k_pool, v_pool


# -- int8 KV blocks ------------------------------------------------------------
#
# An int8 pool stores each (layer, token) row as int8 plus one f32
# symmetric scale (scale = max|x|/127 + eps, round half to even, clip).
# Quantized zeros decode to exact zeros, so the zero block and fresh-block
# zeroing behave as in the fp pool.

def kv_quantize(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., d) fp -> ((..., d) int8, (...) f32 scales), computed in f32."""
    buf = rows.float()
    scale = torch.amax(torch.abs(buf), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(buf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of `kv_quantize`: (..., d) int8 + (...) scales -> fp."""
    return (q.float() * scale[..., None]).to(dtype)


def paged_gather_cache_int8(k_pool, v_pool, k_scale, v_scale, table, lens, *,
                            dtype=torch.bfloat16) -> dict:
    """Dense decode view of an int8 pool: gather blocks + scales, dequantize."""
    ln = k_pool.shape[0]
    b, mb = table.shape
    bs = k_pool.shape[2]
    idx = table.clamp(min=0).reshape(-1).long()
    ks = k_scale.index_select(1, idx).reshape(ln, b, mb * bs)
    vs = v_scale.index_select(1, idx).reshape(ln, b, mb * bs)
    return {
        "k": kv_dequantize(paged_gather(k_pool, table), ks, dtype),
        "v": kv_dequantize(paged_gather(v_pool, table), vs, dtype),
        "pos": torch.as_tensor(lens, dtype=torch.int32, device=k_pool.device),
    }


def migrate_cache_into_blocks_int8(k_pool, v_pool, k_scale, v_scale, cache1: dict,
                                   block_ids: torch.Tensor, *, start: int, block_size: int):
    """int8 `migrate_cache_into_blocks`: blockify, quantize per token row,
    write data + scales in place."""
    n = int(block_ids.shape[0])
    if n == 0:
        return k_pool, v_pool, k_scale, v_scale
    ids = block_ids.to(device=k_pool.device, dtype=torch.long)
    kq, ks = kv_quantize(blockify_cache_leaf(cache1["k"], start, n, block_size))
    vq, vs = kv_quantize(blockify_cache_leaf(cache1["v"], start, n, block_size))
    k_pool[:, ids] = kq
    v_pool[:, ids] = vq
    k_scale[:, ids] = ks
    v_scale[:, ids] = vs
    return k_pool, v_pool, k_scale, v_scale
