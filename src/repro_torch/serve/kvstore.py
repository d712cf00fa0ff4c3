"""KV stores of the port: dense (continuous mode) and paged (block pool,
per-slot block tables, prefix cache).

The host bookkeeping is the reference's, step for step: for the same
sequence of operations the tables, ``lens``, refcounts, free heap, LRU
order and ``peak_blocks`` come out identical (tests/test_torch_kvstore.py
holds them against the JAX stores). The device halves update the pools
IN PLACE where the reference rebinds `.at[].set` results.

  * `DenseKVStore` — one ``(L, slots, max_len, d)`` reservation per
    cache leaf (an SSM cache's ``ssm_state``/``ssm_conv`` per slot). In
    aligned mode (``ragged=False``) its cache is the decode step's whole
    cache with the shared cursor; in ragged (continuous) mode its
    `kernel_view` feeds the paged decode kernel as a one-block-per-slot
    pool through an identity table.
  * `PagedKVStore` — pools ``(L, n_blocks, block_size, d)`` in the cache
    dtype or int8 (+ f32 per-row scales); block 0 is the permanent zero
    block and ``-1`` table entries read it.
  * `PrefixCache` — prompt-prefix keyed, refcounted sharing of full
    blocks, LRU-bounded; whole-prompt entries skip prefill.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.operators import (
    kv_quantize,
    migrate_cache_into_blocks,
    migrate_cache_into_blocks_int8,
    migrate_cache_into_slot,
    paged_gather,
    paged_gather_cache,
    paged_gather_cache_int8,
)
from repro_torch.serve.api import KVSpec


def make_kvstore(model, slots: int, max_len: int, spec: KVSpec, *, ragged: bool):
    """Build the KV store a `KVSpec` describes. ``ragged``: per-slot
    cursors (continuous mode); the paged store is always ragged."""
    if spec.kind == "paged":
        return PagedKVStore(model, slots, max_len, spec)
    return DenseKVStore(model, slots, max_len, ragged=ragged)


def _ids(xs, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(xs, np.int64), device=device)


def _cursors(slots: int, max_len: int, lens, active) -> np.ndarray:
    """Decode cursors: an active slot's length, ``max_len`` for the rest
    (their lane write and new-row fold then touch nothing)."""
    pos = np.full(slots, max_len, np.int32)
    for i in active or ():
        pos[i] = lens[i]
    return pos


# ---------------------------------------------------------------------------
# dense store
# ---------------------------------------------------------------------------


class DenseKVStore:
    """One contiguous ``max_len`` reservation per slot.

    ``ragged=False`` (aligned mode): the store's cache is the decode
    step's whole cache, with the shared scalar cursor that admission
    advances to the longest prompt (`migrate_cache_into_slot`).
    ``ragged=True`` (continuous mode): per-slot lengths on the host,
    handed to the decode step as a ``(B,)`` cursor vector."""

    kind = "dense"
    block_size: int | None = None  # not page-limited

    def __init__(self, model, slots: int, max_len: int, *, ragged: bool = False):
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.ragged = ragged
        self.cache = model.init_cache(slots, max_len)
        self.lens = np.zeros(slots, np.int64)

    def view(self, active: Sequence[int] | None = None) -> dict:
        if not self.ragged:
            return self.cache
        pos = _cursors(self.slots, self.max_len, self.lens, active)
        return {"k": self.cache["k"], "v": self.cache["v"],
                "pos": torch.as_tensor(pos, device=self.device)}

    def absorb(self, cache: dict, active: Sequence[int]) -> None:
        """Take back the aligned decode step's cache (the step updated it
        in place) and advance the active slots' lengths."""
        if self.ragged:
            raise RuntimeError("absorb takes an aligned decode step's cache; continuous mode "
                               "scatters rows with absorb_rows")
        self.cache = cache
        for i in active:
            self.lens[i] = min(self.lens[i] + 1, self.max_len)

    def kernel_view(self, active: Sequence[int] | None = None) -> dict:
        """The dense cache as a trivially paged pool: one block of
        ``max_len`` tokens per slot, identity block table (continuous
        mode only)."""
        if not self.ragged:
            raise RuntimeError("kernel_view needs ragged mode (per-slot cursors)")
        pos = _cursors(self.slots, self.max_len, self.lens, active)
        return {
            "k_pool": self.cache["k"],
            "v_pool": self.cache["v"],
            "tables": torch.arange(self.slots, dtype=torch.int32, device=self.device)[:, None],
            "pos": torch.as_tensor(pos, device=self.device),
            "rows_like": self.cache["k"].new_zeros((0,)),
        }

    def absorb_rows(self, rows_k: torch.Tensor, rows_v: torch.Tensor,
                    active: Sequence[int]) -> None:
        """Write the decode step's per-slot K/V rows (L, B, d) at each
        active slot's cursor, in place."""
        idx = [i for i in active if self.lens[i] < self.max_len]
        if idx:
            sl = _ids(idx, self.device)
            at = _ids(self.lens[idx], self.device)
            self.cache["k"][:, sl, at] = rows_k[:, sl].to(self.cache["k"].dtype)
            self.cache["v"][:, sl, at] = rows_v[:, sl].to(self.cache["v"].dtype)
        for i in active:
            self.lens[i] = min(self.lens[i] + 1, self.max_len)

    def truncate(self, slot: int, new_len: int) -> None:
        """Roll a slot back to ``new_len`` tokens: zero its rows past the
        new cursor and rewind the host length. No-op at or below."""
        new_len = int(new_len)
        old = int(self.lens[slot])
        if new_len >= old:
            return
        self.cache["k"][:, slot, new_len:old] = 0
        self.cache["v"][:, slot, new_len:old] = 0
        self.lens[slot] = new_len

    def admit(self, slot: int, cache1: dict, length: int, *,
              tokens=None, logits=None, first=None) -> dict:
        """Migrate a batch-1 prefill cache into ``slot`` (every leaf; a
        ``pos`` in ``cache1`` advances the shared cursor)."""
        migrate_cache_into_slot(self.cache, cache1, slot)
        self.lens[slot] = length
        return {"prefix_tokens": 0}

    def full_hit(self, tokens):
        return None

    def free(self, slot: int) -> None:
        self.lens[slot] = 0  # KV stays; the next admit zero-extends over it

    def free_tokens(self) -> int:
        """Every free slot holds ``max_len`` tokens; partly filled slots
        contribute nothing."""
        return int(np.sum(self.lens == 0)) * self.max_len

    def covered_tokens(self, tokens, length: int) -> int:
        return 0

    @property
    def stats(self) -> dict:
        return {"kind": "dense", "live_tokens": int(self.lens.sum()),
                "reserved_tokens": self.slots * self.max_len}

    def slot_cache(self, slot: int) -> dict:
        """Slot ``slot`` as a batch-1 cache (views of every leaf), with
        the shared cursor in aligned mode and the slot's length in ragged
        mode: what `admit` takes back."""
        pos = (self.cache["pos"] if not self.ragged
               else torch.tensor(int(self.lens[slot]), dtype=torch.int32, device=self.device))
        return {k: (pos if k == "pos" else v[:, slot : slot + 1]) for k, v in self.cache.items()}


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FullEntry:
    """A whole previously served prompt: its full blocks by reference,
    the tail-block KV rows and the last-position logits (kept as device
    copies, so a repeat submission skips prefill with no host round
    trip)."""

    length: int
    blocks: tuple[int, ...]
    k_tail: torch.Tensor  # (L, length % bs, d)
    v_tail: torch.Tensor
    logits: torch.Tensor  # (V,)
    first: int  # greedy first token


class PrefixCache:
    """Prefix-keyed registry of shared KV blocks, LRU-bounded. Keys are
    exact token bytes (``("chain", tokens[:j*bs])`` per full-block
    boundary, ``("full", tokens)`` per whole prompt). Entries hold
    refcounts on their blocks through the owning store."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.entries: OrderedDict[tuple, object] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    @staticmethod
    def _key(kind: str, tokens, n: int) -> tuple:
        return (kind, np.asarray(tokens[:n], np.int64).tobytes())

    def match_chain(self, tokens, length: int, bs: int, *,
                    touch: bool = True) -> tuple[int, ...]:
        """Longest registered chain covering a prefix of ``tokens``
        (full blocks only, at most ``length`` tokens)."""
        for j in range(int(length) // bs, 0, -1):
            key = self._key("chain", tokens, j * bs)
            entry = self.entries.get(key)
            if entry is not None:
                if touch:
                    self.entries.move_to_end(key)
                return entry
        return ()

    def match_full(self, tokens) -> _FullEntry | None:
        key = self._key("full", tokens, len(tokens))
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def register(self, store: "PagedKVStore", tokens, length: int,
                 row: np.ndarray, cache1=None, logits=None, first=None) -> None:
        bs = store.block_size
        for j in range(1, int(length) // bs + 1):
            key = self._key("chain", tokens, j * bs)
            if key in self.entries:
                self.entries.move_to_end(key)
                continue
            blocks = tuple(int(b) for b in row[:j])
            store._prefix_ref(blocks)
            self.entries[key] = blocks
        if cache1 is not None and logits is not None and first is not None:
            key = self._key("full", tokens, length)
            if key not in self.entries:
                nfull = int(length) // bs
                c = nfull * bs
                blocks = tuple(int(b) for b in row[:nfull])
                store._prefix_ref(blocks)
                self.entries[key] = _FullEntry(
                    length=int(length),
                    blocks=blocks,
                    k_tail=cache1["k"][:, 0, c:length].clone(),
                    v_tail=cache1["v"][:, 0, c:length].clone(),
                    logits=logits.detach().clone(),
                    first=int(first),
                )
            else:
                self.entries.move_to_end(key)
        while len(self.entries) > self.capacity:
            self.evict_one(store)

    def evict_one(self, store: "PagedKVStore") -> bool:
        if not self.entries:
            return False
        _, entry = self.entries.popitem(last=False)
        blocks = entry.blocks if isinstance(entry, _FullEntry) else entry
        store._prefix_unref(blocks)
        return True


# ---------------------------------------------------------------------------
# paged store
# ---------------------------------------------------------------------------


class PagedKVStore:
    """Block-pooled KV with per-slot block tables. A slot's table row
    maps view position ``p`` to ``(table[p // bs], p % bs)``. Requires
    ``max_len % block_size == 0``."""

    kind = "paged"

    def __init__(self, model, slots: int, max_len: int, spec: KVSpec):
        if max_len % spec.block_size:
            raise ValueError(
                f"max_len={max_len} must be a multiple of block_size={spec.block_size}"
            )
        probe = model.init_cache(1, 1)
        if set(probe) != {"k", "v", "pos"}:
            raise ValueError("paged KV needs an attention-only cache (k/v/pos)")
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.spec = spec
        bs = self.block_size = spec.block_size
        self.max_blocks = mb = max_len // bs
        self.quantized = spec.kv_dtype == "int8"
        self._cache_dtype = probe["k"].dtype  # dequant target / fp pool dtype
        # int8 halves the per-token bytes of a bf16 cache: the same pool
        # byte budget holds itemsize-times the pages
        ratio = probe["k"].element_size() if self.quantized else 1
        n_blocks = spec.n_blocks if spec.n_blocks is not None else slots * mb * ratio + 1
        if n_blocks < mb + 1:
            raise ValueError(
                f"n_blocks={n_blocks} cannot hold one full request "
                f"({mb} blocks + the zero block)"
            )
        self.n_blocks = n_blocks
        ln, _, _, dk = probe["k"].shape
        dv = probe["v"].shape[-1]
        pool_dtype = torch.int8 if self.quantized else self._cache_dtype
        self.k_pool = torch.zeros((ln, n_blocks, bs, dk), dtype=pool_dtype, device=self.device)
        self.v_pool = torch.zeros((ln, n_blocks, bs, dv), dtype=pool_dtype, device=self.device)
        if self.quantized:
            self.k_scale = torch.zeros((ln, n_blocks, bs), dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        else:
            self.k_scale = self.v_scale = None
        self.tables = np.full((slots, mb), -1, np.int32)
        self.lens = np.zeros(slots, np.int64)
        self.ref = np.zeros(n_blocks, np.int64)
        self.ref[0] = 1  # the zero block is permanently live
        self._pref = np.zeros(n_blocks, np.int64)  # refs held by the prefix cache
        self._free = list(range(1, n_blocks))
        heapq.heapify(self._free)
        self.peak_blocks = 0
        self.prefix = PrefixCache(spec.prefix_capacity) if spec.prefix_cache else None

    # -- block accounting --------------------------------------------------
    def _alloc(self, n: int) -> list[int]:
        while len(self._free) < n and self.prefix is not None:
            if not self.prefix.evict_one(self):
                break
        if len(self._free) < n:
            raise RuntimeError(
                f"KV block pool exhausted: need {n}, "
                f"{len(self._free)}/{self.n_blocks} free "
                "(page-aware admission should have reserved growth)"
            )
        ids = [heapq.heappop(self._free) for _ in range(n)]
        used = self.n_blocks - 1 - len(self._free)
        self.peak_blocks = max(self.peak_blocks, used)
        return ids

    def _decref(self, b: int) -> None:
        self.ref[b] -= 1
        if self.ref[b] == 0:
            heapq.heappush(self._free, b)

    def _prefix_ref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.ref[b] += 1
            self._pref[b] += 1

    def _prefix_unref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self._pref[b] -= 1
            self._decref(b)

    def _evictable_blocks(self) -> int:
        """Blocks held only by prefix entries: reclaimable by eviction."""
        return int(np.sum((self._pref > 0) & (self.ref == self._pref)))

    def _fill(self, cache1: dict, new_ids, *, start: int) -> None:
        ids = _ids(new_ids, self.device)
        if self.quantized:
            migrate_cache_into_blocks_int8(self.k_pool, self.v_pool, self.k_scale,
                                           self.v_scale, cache1, ids, start=start,
                                           block_size=self.block_size)
        else:
            migrate_cache_into_blocks(self.k_pool, self.v_pool, cache1, ids, start=start,
                                      block_size=self.block_size)

    # -- decode surface ----------------------------------------------------
    def view(self, active: Sequence[int] | None = None) -> dict:
        """The gathered dense view (L, B, max_len, d) + cursors."""
        pos = _cursors(self.slots, self.max_len, self.lens, active)
        tables = torch.as_tensor(self.tables, device=self.device)
        if self.quantized:
            return paged_gather_cache_int8(self.k_pool, self.v_pool, self.k_scale,
                                           self.v_scale, tables, pos, dtype=self._cache_dtype)
        return paged_gather_cache(self.k_pool, self.v_pool, tables, pos)

    def kernel_view(self, active: Sequence[int] | None = None) -> dict:
        """The raw pool + block tables for `decode_step_paged`: no
        gather; int8 pools ride with their scale sidecars."""
        pos = _cursors(self.slots, self.max_len, self.lens, active)
        out = {
            "k_pool": self.k_pool,
            "v_pool": self.v_pool,
            "tables": torch.as_tensor(self.tables, device=self.device),
            "pos": torch.as_tensor(pos, device=self.device),
            "rows_like": torch.zeros((0,), dtype=self._cache_dtype, device=self.device),
        }
        if self.quantized:
            out["k_scale"] = self.k_scale
            out["v_scale"] = self.v_scale
        return out

    def _tail_slots(self, active: Sequence[int]):
        """Host half of a decode append: the slots whose cursor is still
        inside the view, their (block, offset) targets, and any freshly
        allocated tail blocks (block-boundary crossings)."""
        idx = [i for i in active if self.lens[i] < self.max_len]
        if not idx:
            return idx, None, None, None
        fresh = []
        for i in idx:
            b = int(self.lens[i]) // self.block_size
            if self.tables[i, b] < 0:
                (nb,) = self._alloc(1)
                self.ref[nb] = 1
                self.tables[i, b] = nb
                fresh.append(nb)
        pos = self.lens[idx]
        blocks = self.tables[idx, pos // self.block_size]
        offs = pos % self.block_size
        return idx, blocks, offs, fresh

    def absorb_rows(self, rows_k: torch.Tensor, rows_v: torch.Tensor,
                    active: Sequence[int]) -> None:
        """Scatter the decode step's per-slot K/V rows (L, B, d) into each
        active slot's tail block, in place. Fresh tail blocks are zeroed
        first; int8 pools quantize the rows here."""
        idx, blocks, offs, fresh = self._tail_slots(active)
        if idx:
            args = (_ids(idx, self.device), _ids(blocks, self.device),
                    _ids(offs, self.device), _ids(fresh, self.device))
            if self.quantized:
                _paged_scatter_rows_int8(self.k_pool, self.v_pool, self.k_scale,
                                         self.v_scale, rows_k, rows_v, *args)
            else:
                _paged_scatter_rows(self.k_pool, self.v_pool, rows_k, rows_v, *args)
        for i in active:
            self.lens[i] = min(self.lens[i] + 1, self.max_len)

    def truncate(self, slot: int, new_len: int) -> None:
        """Roll a slot back to ``new_len`` tokens: blocks wholly past the
        keep point are dereferenced (table entry back to -1), and the
        kept boundary block, always private, has its rows past the
        cursor zeroed. No-op at or below ``new_len``."""
        new_len = int(new_len)
        old = int(self.lens[slot])
        if new_len >= old:
            return
        bs = self.block_size
        first_dead = -(-new_len // bs)
        for b_idx in range(first_dead, self.max_blocks):
            b = int(self.tables[slot, b_idx])
            if b > 0:
                self._decref(b)
                self.tables[slot, b_idx] = -1
        rem = new_len % bs
        if rem:
            b = int(self.tables[slot, new_len // bs])
            if not (b > 0 and self.ref[b] == 1):
                raise RuntimeError(f"truncate boundary block {b} must be private")
            if self.quantized:
                _zero_block_tail_int8(self.k_pool, self.v_pool, self.k_scale,
                                      self.v_scale, b, rem)
            else:
                _zero_block_tail(self.k_pool, self.v_pool, b, rem)
        self.lens[slot] = new_len

    # -- admission / retirement --------------------------------------------
    def admit(self, slot: int, cache1: dict, length: int, *,
              tokens=None, logits=None, first=None) -> dict:
        """Install a prefilled request: shared prefix blocks by
        reference, the rest filled from ``cache1``. ``tokens`` enables
        prefix lookup/registration; ``logits``/``first`` also register
        the whole prompt for the skip-prefill path."""
        length = int(length)
        shared: tuple[int, ...] = ()
        if self.prefix is not None and tokens is not None:
            shared = self.prefix.match_chain(tokens, length, self.block_size)
        start = len(shared) * self.block_size
        # take the slot's references on shared blocks BEFORE allocating:
        # _alloc may evict prefix entries
        for b in shared:
            self.ref[b] += 1
        n_new = -((start - length) // self.block_size) if length > start else 0
        new_ids = self._alloc(n_new)
        if n_new:
            self._fill(cache1, new_ids, start=start)
        row = np.full(self.max_blocks, -1, np.int32)
        row[: len(shared)] = shared
        row[len(shared) : len(shared) + n_new] = new_ids
        for b in new_ids:
            self.ref[b] = 1
        self.tables[slot] = row
        self.lens[slot] = length
        if self.prefix is not None and tokens is not None:
            self.prefix.hit_tokens += start
            if start:
                self.prefix.hits += 1
            else:
                self.prefix.misses += 1
            self.prefix.register(self, tokens, length, row,
                                 cache1=cache1, logits=logits, first=first)
        return {"prefix_tokens": start}

    def full_hit(self, tokens) -> _FullEntry | None:
        if self.prefix is None:
            return None
        return self.prefix.match_full(tokens)

    def admit_from_full(self, slot: int, entry: _FullEntry) -> dict:
        """Install a whole cached prompt without prefill: full blocks by
        reference, the tail rows into a fresh private block."""
        row = np.full(self.max_blocks, -1, np.int32)
        row[: len(entry.blocks)] = entry.blocks
        for b in entry.blocks:
            self.ref[b] += 1
        rem = entry.length - len(entry.blocks) * self.block_size
        if rem:
            (nb,) = self._alloc(1)
            self._fill({"k": entry.k_tail[:, None], "v": entry.v_tail[:, None]}, [nb],
                       start=0)
            self.ref[nb] = 1
            row[len(entry.blocks)] = nb
        self.tables[slot] = row
        self.lens[slot] = entry.length
        self.prefix.hits += 1
        self.prefix.hit_tokens += entry.length
        return {"prefix_tokens": entry.length}

    def free(self, slot: int) -> None:
        for b in self.tables[slot]:
            if b > 0:
                self._decref(int(b))
        self.tables[slot] = -1
        self.lens[slot] = 0

    # -- capacity ----------------------------------------------------------
    def free_tokens(self) -> int:
        return (len(self._free) + self._evictable_blocks()) * self.block_size

    def covered_tokens(self, tokens, length: int) -> int:
        """Prefix tokens a future admit would get for free (no LRU touch)."""
        if self.prefix is None:
            return 0
        return len(self.prefix.match_chain(tokens, int(length), self.block_size,
                                           touch=False)) * self.block_size

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    @property
    def pool_bytes(self) -> int:
        """K/V data bytes (the f32 scale sidecar is reported apart)."""
        return (self.k_pool.numel() * self.k_pool.element_size()
                + self.v_pool.numel() * self.v_pool.element_size())

    @property
    def stats(self) -> dict:
        out = {
            "kind": "paged",
            "kv_dtype": self.spec.kv_dtype,
            "pool_bytes": self.pool_bytes,
            "scale_bytes": 0 if not self.quantized else (
                self.k_scale.numel() + self.v_scale.numel()) * 4,
            "block_size": self.block_size,
            "n_blocks": self.n_blocks,
            "blocks_in_use": self.blocks_in_use,
            "peak_blocks": self.peak_blocks,
            "evictable_blocks": self._evictable_blocks(),
            "live_tokens": int(self.lens.sum()),
            "live_block_demand": int(sum(
                -(-int(n) // self.block_size) for n in self.lens if n)),
            "ref_total": int(self.ref.sum()) - 1,
            "prefix_ref_total": int(self._pref.sum()),
        }
        if self.prefix is not None:
            out.update(prefix_hits=self.prefix.hits,
                       prefix_misses=self.prefix.misses,
                       prefix_hit_tokens=self.prefix.hit_tokens,
                       prefix_entries=len(self.prefix.entries))
        return out


# -- device halves (in place) -------------------------------------------------


def _paged_scatter_rows(k_pool, v_pool, rows_k, rows_v, slot_idx, blocks, offs, fresh):
    """Kernel-path append: select the active slots' rows (L, B, d) and
    scatter them to (block, offset); fresh tail blocks (possibly
    recycled) are zeroed first, so everything past a cursor stays zero."""
    if fresh.numel():
        k_pool[:, fresh] = 0
        v_pool[:, fresh] = 0
    k_pool[:, blocks, offs] = rows_k[:, slot_idx].to(k_pool.dtype)
    v_pool[:, blocks, offs] = rows_v[:, slot_idx].to(v_pool.dtype)


def _paged_scatter_rows_int8(k_pool, v_pool, k_scale, v_scale, rows_k, rows_v,
                             slot_idx, blocks, offs, fresh):
    if fresh.numel():
        k_pool[:, fresh] = 0
        v_pool[:, fresh] = 0
        k_scale[:, fresh] = 0
        v_scale[:, fresh] = 0
    kq, ks = kv_quantize(rows_k[:, slot_idx])
    vq, vs = kv_quantize(rows_v[:, slot_idx])
    k_pool[:, blocks, offs] = kq
    v_pool[:, blocks, offs] = vq
    k_scale[:, blocks, offs] = ks
    v_scale[:, blocks, offs] = vs


def _zero_block_tail(k_pool, v_pool, block: int, start: int):
    """Zero one block's rows in [start, block_size)."""
    k_pool[:, block, start:] = 0
    v_pool[:, block, start:] = 0


def _zero_block_tail_int8(k_pool, v_pool, k_scale, v_scale, block: int, start: int):
    _zero_block_tail(k_pool, v_pool, block, start)
    k_scale[:, block, start:] = 0
    v_scale[:, block, start:] = 0


__all__ = ["DenseKVStore", "PagedKVStore", "PrefixCache", "make_kvstore"]
