"""Stream operators (the paper's `MPIStream_Attach` payload, Sec. III-A)
and the KV-cache operators of the serving path: slot migration, the
paged block pool's gather and fill, and the int8 row codec.

A stream operator is a fold ``(acc, element, k) -> acc`` applied on the
consumer group to every arriving element (k = the element's index in its
stream), plus an ``init`` constructor, so it composes with
`StreamChannel.stream_fold` and `ServiceGraph.run`. The four here match
the paper's case studies:

  * `sum_op`            -- decoupled reduce (MapReduce, gradient reduction)
  * `histogram_op`      -- keyed word-count reduce (MapReduce), through
                           the keyed-histogram kernel on the card
  * `buffer_op`         -- aggressive buffering for a decoupled I/O group
  * `workload_stats_op` -- min/max/median workload analytics (Listing 1)

The reference's operators are pure (`.at[].set` returns a new array);
the port's operators and writers update their accumulator or destination
IN PLACE and return it, so neither a pool nor a histogram is copied per
element. A caller that needs an earlier state keeps a clone
(`dataflow.delta_emitter` does). Block 0 of a pool is the permanent zero
block: table entries of -1 clamp to it on gather, which makes the
gathered view of a partly allocated slot equal to the zero-extended
dense cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.kernels.stream_reduce import ops as reduce_ops


@dataclasses.dataclass(frozen=True)
class StreamOperator:
    """A named fold: ``init()`` makes a fresh state, ``apply(acc, element,
    k)`` folds one element into it (in place) and returns it."""

    name: str
    init: Callable[[], Any]
    apply: Callable[[Any, torch.Tensor, int], Any]


# -- decoupled reduce ---------------------------------------------------------

def sum_op(chunk_elems: int, dtype=torch.float32, *, device=None) -> StreamOperator:
    """acc <- acc + element: the decoupled reduction operator. ``device``:
    where the state lives (cuda unless named)."""
    dev = resolve_device(device)

    def apply(acc, elem, k):
        return acc.add_(elem.to(dtype))

    return StreamOperator(name="sum", init=lambda: torch.zeros((chunk_elems,), dtype=dtype,
                                                                device=dev), apply=apply)


# -- keyed histogram (MapReduce word count) ----------------------------------

def histogram_fold(n_bins: int, keys_per_elem: int) -> Callable:
    """The fold of `histogram_op`: an element ``[keys | counts]`` (each
    ``keys_per_elem`` wide, keys as floats) adds counts[i] to
    acc[keys[i]] through `keyed_histogram(..., out=acc)`, the kernel on a
    CUDA tensor. Negative keys are padding; keys past the last bin are
    clamped into it first, as the reference clips them (the kernel alone
    would drop them). Keys are exact as f32 below 2^24."""

    def apply(acc, elem, k):
        keys = elem[:keys_per_elem].to(torch.int32).clamp_(max=n_bins - 1)
        counts = elem[keys_per_elem:2 * keys_per_elem]
        return reduce_ops.keyed_histogram(keys, counts, n_bins, out=acc)

    return apply


def histogram_op(n_bins: int, keys_per_elem: int, *, device=None) -> StreamOperator:
    """acc[key] += count for every (key, count) pair of an element packed
    ``[keys | counts]``; key < 0 marks padding (`histogram_fold`)."""
    dev = resolve_device(device)
    return StreamOperator(name="histogram",
                          init=lambda: torch.zeros((n_bins,), dtype=torch.float32, device=dev),
                          apply=histogram_fold(n_bins, keys_per_elem))


def pack_kv(keys: torch.Tensor, counts: torch.Tensor, elem_width: int) -> torch.Tensor:
    """Pack (keys, counts) into `histogram_op`'s element layout, zero-padded
    to ``elem_width``."""
    pad = max(elem_width - 2 * keys.shape[0], 0)
    return torch.cat([keys.float(), counts.float(), keys.new_zeros((pad,), dtype=torch.float32)])


# -- buffering I/O group -------------------------------------------------------

def buffer_op(capacity_chunks: int, chunk_elems: int, dtype=torch.float32, *,
              device=None) -> StreamOperator:
    """Append arriving elements into a preallocated ring buffer. State =
    (buffer (capacity, S), write pointer as a 0-d int32 tensor); the
    decoupled I/O group drains it to host storage off the critical path."""
    dev = resolve_device(device)

    def init():
        return (torch.zeros((capacity_chunks, chunk_elems), dtype=dtype, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))

    def apply(state, elem, k):
        buf, ptr = state
        row = (ptr % capacity_chunks).reshape(1).long()
        buf.index_copy_(0, row, elem.to(dtype)[None])
        return buf, ptr + 1

    return StreamOperator(name="buffer", init=init, apply=apply)


# -- workload analytics (paper Listing 1) --------------------------------------

def workload_stats_op(max_samples: int, *, device=None) -> StreamOperator:
    """Collect scalar workload samples (slot 0 of each element); finalize
    to (min, max, median) with `finalize_workload_stats`: three reductions
    that would otherwise be three global collectives."""
    dev = resolve_device(device)

    def init():
        return (torch.full((max_samples,), float("nan"), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))

    def apply(state, elem, k):
        samples, n = state
        slot = n.clamp(max=max_samples - 1).reshape(1).long()
        samples.index_copy_(0, slot, elem[:1].float())
        return samples, n + 1

    return StreamOperator(name="workload_stats", init=init, apply=apply)


def finalize_workload_stats(state) -> dict[str, torch.Tensor]:
    """{min, max, median, count} of the collected samples; the median of an
    even count is the mean of the two middle samples (numpy's)."""
    samples, n = state
    valid = ~torch.isnan(samples)
    inf = torch.tensor(float("inf"), device=samples.device)
    kept = torch.sort(samples[valid]).values
    m = kept.numel()
    med = (kept[(m - 1) // 2] + kept[m // 2]) * 0.5 if m else inf.new_tensor(float("nan"))
    return {"min": torch.where(valid, samples, inf).min(),
            "max": torch.where(valid, samples, -inf).max(),
            "median": med, "count": n}


# -- KV-cache operators --------------------------------------------------------


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
