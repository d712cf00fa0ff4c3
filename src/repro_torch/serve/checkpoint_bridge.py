"""Serving-state checkpoints of the port: the KV pool, block tables and
request queues (the counterpart of the reference's
`serve/checkpoint_bridge.py`, over the port's `io/checkpoint.py`, in the
same on-disk format: each package loads the other's snapshots).

When a fault kills KV that lived only on the dead rows, an in-memory
migration (`fleet.reshard_serving_state`) has nothing to move; the
fallback is a periodic snapshot of the SERVING state, not just the
parameters: the KV store (dense cache, or paged pool, tables, refcounts
and prefix-cache entries), the decode token row, and every request the
engine knows (in a slot with its tokens so far, or queued with its
original arrival tick).

`ServingCheckpointer` drives this through `io.checkpoint.AsyncCheckpointer`
on a tick cadence; `FleetEngine` calls `maybe_save` every tick and
`slot_entry` per orphan on the checkpoint-recovery path. A recovered
request keeps its checkpointed ``out_tokens`` and decodes on from its
saved cursor, and the recovery stall (the ticks between the snapshot and
the fault) is charged to its original ``submitted_tick``.

Encoding (everything must pass plain ``np.save``, no pickle):

  * every key of the tree is a string (`io.checkpoint.restore_tree`);
  * a bf16 leaf is widened to f32 on the host with its dtype name beside
    it (`_pack`) and narrowed back on the store's device (`_unpack`):
    both steps are exact, so the round trip is bit for bit;
  * prefix-cache entries are stored in LRU order with their exact key
    token bytes, and a restore does NOT take references for their blocks
    again: ``ref`` and ``_pref`` are restored verbatim and the free heap
    is rebuilt from every unreferenced block.
"""
from __future__ import annotations

import heapq
from typing import Any

import numpy as np
import torch

from repro_torch.io import checkpoint as ckpt_io
from repro_torch.kernels.runtime import resolve_device
from repro_torch.serve.engine import Request
from repro_torch.serve.kvstore import _FullEntry


# ---------------------------------------------------------------------------
# leaf helpers
# ---------------------------------------------------------------------------


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``bfloat16`` for bf16)."""
    return str(dtype).removeprefix("torch.")


def _host(x: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host array of its own dtype (a copy)."""
    return x.detach().to("cpu", copy=True).numpy()


def _pack(x: torch.Tensor) -> dict:
    """A host-storable array and its original dtype name (bf16 widened)."""
    name = _dtype_name(x.dtype)
    if x.dtype == torch.bfloat16:
        x = x.float()
    return {"data": _host(x), "dtype": np.asarray(name)}


def _unpack(d: dict, device) -> torch.Tensor:
    """`_pack`'s inverse as a tensor on ``device``, narrowed there."""
    x = np.array(d["data"], copy=True)  # a 0-d leaf stays 0-d
    name = str(np.asarray(d["dtype"]))
    return torch.from_numpy(x).to(device).to(getattr(torch, name))


def _flat(arrays, dtype) -> tuple[np.ndarray, np.ndarray]:
    """A ragged list of 1-d arrays -> (flat, offsets)."""
    offs = np.zeros(len(arrays) + 1, np.int64)
    for i, a in enumerate(arrays):
        offs[i + 1] = offs[i] + len(a)
    flat = (np.concatenate([np.asarray(a, dtype) for a in arrays])
            if arrays and offs[-1] else np.zeros(0, dtype))
    return flat, offs


def _unflat(flat, offs, i) -> np.ndarray:
    flat = np.asarray(flat)
    offs = np.asarray(offs, np.int64)
    return flat[offs[i]: offs[i + 1]]


# ---------------------------------------------------------------------------
# KV store snapshot / restore
# ---------------------------------------------------------------------------


def _snapshot_prefix(pc) -> dict:
    """`PrefixCache` entries in LRU order (kinds, exact key tokens, block
    ids; whole-prompt entries carry their tail rows and logits)."""
    kinds, toks, blks, full = [], [], [], {}
    for i, (key, entry) in enumerate(pc.entries.items()):
        kind, tok_bytes = key
        kinds.append(0 if kind == "chain" else 1)
        toks.append(np.frombuffer(tok_bytes, np.int64))
        if isinstance(entry, _FullEntry):
            blks.append(np.asarray(entry.blocks, np.int64))
            full[str(i)] = {
                "length": np.int64(entry.length),
                "first": np.int64(entry.first),
                "logits": _pack(entry.logits),
                "k_tail": _pack(entry.k_tail),
                "v_tail": _pack(entry.v_tail),
            }
        else:
            blks.append(np.asarray(entry, np.int64))
    tok_flat, tok_off = _flat(toks, np.int64)
    blk_flat, blk_off = _flat(blks, np.int64)
    return {
        "kinds": np.asarray(kinds, np.int64),
        "tok_flat": tok_flat, "tok_off": tok_off,
        "blk_flat": blk_flat, "blk_off": blk_off,
        "full": full,
        "hits": np.int64(pc.hits),
        "misses": np.int64(pc.misses),
        "hit_tokens": np.int64(pc.hit_tokens),
        "capacity": np.int64(pc.capacity),
    }


def _restore_prefix(pc, sub: dict, device) -> None:
    kinds = np.asarray(sub["kinds"], np.int64)
    full = sub.get("full", {})  # an empty dict leaves no key paths on disk
    pc.entries.clear()
    for i in range(len(kinds)):
        tokens = np.ascontiguousarray(_unflat(sub["tok_flat"], sub["tok_off"], i))
        blocks = tuple(int(b) for b in _unflat(sub["blk_flat"], sub["blk_off"], i))
        if int(kinds[i]) == 0:
            pc.entries[("chain", tokens.tobytes())] = blocks
        else:
            f = full[str(i)]
            pc.entries[("full", tokens.tobytes())] = _FullEntry(
                length=int(f["length"]),
                blocks=blocks,
                k_tail=_unpack(f["k_tail"], device),
                v_tail=_unpack(f["v_tail"], device),
                logits=_unpack(f["logits"], device),
                first=int(f["first"]),
            )
    pc.hits = int(sub["hits"])
    pc.misses = int(sub["misses"])
    pc.hit_tokens = int(sub["hit_tokens"])
    pc.capacity = int(sub["capacity"])


def snapshot_kvstore(store) -> dict:
    """Host snapshot of a `DenseKVStore` or `PagedKVStore`, bit for bit
    through `restore_kvstore`: paged refcounts, the free set and the
    prefix cache's entry order included."""
    if store.kind == "dense":
        return {
            "kind": np.int64(0),
            "lens": store.lens.copy(),
            "cache": {k: _pack(v) for k, v in store.cache.items()},
        }
    out = {
        "kind": np.int64(1),
        "k_pool": _pack(store.k_pool),
        "v_pool": _pack(store.v_pool),
        "tables": store.tables.copy(),
        "lens": store.lens.copy(),
        "ref": store.ref.copy(),
        "pref": store._pref.copy(),
        "peak": np.int64(store.peak_blocks),
        "cache_dtype": np.asarray(_dtype_name(store._cache_dtype)),
    }
    if store.quantized:
        out["k_scale"] = _host(store.k_scale)
        out["v_scale"] = _host(store.v_scale)
    if store.prefix is not None:
        out["prefix"] = _snapshot_prefix(store.prefix)
    return out


def restore_kvstore(store, snap: dict) -> None:
    """Restore `snapshot_kvstore` output into a store of the same
    geometry, on the store's device."""
    dev = store.device
    kind = int(np.asarray(snap["kind"]))
    if kind == 0:
        if store.kind != "dense":
            raise ValueError("dense snapshot into a non-dense store")
        cache = {k: _unpack(v, dev) for k, v in snap["cache"].items()}
        if set(cache) != set(store.cache):
            raise ValueError(f"cache leaves {sorted(cache)} != {sorted(store.cache)}")
        store.cache = cache
        store.lens = np.asarray(snap["lens"], np.int64).copy()
        return
    if store.kind != "paged":
        raise ValueError("paged snapshot into a non-paged store")
    tables = np.asarray(snap["tables"], np.int32)
    if tables.shape != store.tables.shape:
        raise ValueError(f"snapshot tables {tables.shape} != store {store.tables.shape}")
    ref = np.asarray(snap["ref"], np.int64)
    if len(ref) != store.n_blocks:
        raise ValueError(f"snapshot has {len(ref)} blocks, store {store.n_blocks}")
    store.k_pool = _unpack(snap["k_pool"], dev)
    store.v_pool = _unpack(snap["v_pool"], dev)
    if store.quantized:
        store.k_scale = torch.from_numpy(np.asarray(snap["k_scale"], np.float32)).to(dev)
        store.v_scale = torch.from_numpy(np.asarray(snap["v_scale"], np.float32)).to(dev)
    store.tables = tables.copy()
    store.lens = np.asarray(snap["lens"], np.int64).copy()
    store.ref = ref.copy()
    store._pref = np.asarray(snap["pref"], np.int64).copy()
    store.peak_blocks = int(snap["peak"])
    store._free = [b for b in range(1, store.n_blocks) if store.ref[b] == 0]
    heapq.heapify(store._free)
    if store.prefix is not None:
        if "prefix" in snap:
            _restore_prefix(store.prefix, snap["prefix"], dev)
        else:
            store.prefix.entries.clear()


# ---------------------------------------------------------------------------
# engine snapshot / restore
# ---------------------------------------------------------------------------


def _pack_requests(entries) -> dict:
    """``entries`` are (req, state, slot): state 0 = in a decode slot
    (resumable from its KV), 1 = queued, in prefill or in the handoff
    queue (a cold restore prefills these again from scratch)."""
    reqs = [e[0] for e in entries]
    return {
        "uid": np.asarray([r.uid for r in reqs], np.int64),
        "state": np.asarray([e[1] for e in entries], np.int64),
        "slot": np.asarray([e[2] for e in entries], np.int64),
        "submitted": np.asarray([r.submitted_tick for r in reqs], np.int64),
        "first_tok": np.asarray([r.first_token_tick for r in reqs], np.int64),
        "max_new": np.asarray([r.max_new_tokens for r in reqs], np.int64),
        "tenants": np.asarray([r.tenant for r in reqs]) if reqs else np.zeros(0, "<U1"),
        **dict(zip(("prompt_flat", "prompt_off"), _flat([r.prompt for r in reqs], np.int64))),
        **dict(zip(("out_flat", "out_off"), _flat([r.out_tokens for r in reqs], np.int64))),
    }


def _unpack_requests(tab: dict) -> list[tuple[Request, int, int]]:
    uids = np.asarray(tab["uid"], np.int64)
    tenants = np.asarray(tab["tenants"])
    out = []
    for i in range(len(uids)):
        req = Request(
            uid=int(uids[i]),
            prompt=np.ascontiguousarray(_unflat(tab["prompt_flat"], tab["prompt_off"], i),
                                        np.int32),
            max_new_tokens=int(tab["max_new"][i]),
            out_tokens=[int(t) for t in _unflat(tab["out_flat"], tab["out_off"], i)],
            submitted_tick=int(tab["submitted"][i]),
            first_token_tick=int(tab["first_tok"][i]),
            tenant=str(tenants[i]),
        )
        out.append((req, int(tab["state"][i]), int(tab["slot"][i])))
    return out


def snapshot_engine(eng) -> dict:
    """Snapshot a serving engine (`DisaggEngine`, or anything with its
    slots / kv / tokens / sched surface): the KV store, the decode token
    row and every live request. The ledger and stats are derived and not
    snapshotted; WFQ virtual time resets on a cold restore."""
    entries = [(r, 0, s) for s, r in enumerate(eng.slots) if r is not None]
    queued = list(eng.sched.queued_requests())
    prefill = getattr(eng, "prefill_sched", None)
    if prefill is not None:
        queued += [r for row in prefill.rows for r in row]
    queued += [item[0] for item in getattr(eng, "handoff", ())]
    queued += [item[0] for item in getattr(eng, "restores", ())]
    entries += [(r, 1, -1) for r in queued]
    return {
        "tick": np.int64(eng.tick),
        "tokens": _host(eng.tokens).astype(np.int32),
        "kv": snapshot_kvstore(eng.kv),
        "requests": _pack_requests(entries),
    }


def restore_engine(eng, snap: dict):
    """Restore `snapshot_engine` output into a FRESH engine of the same
    config. Requests in slots land back in them, over the KV restored bit
    for bit, with their decode-input token; queued requests enter the
    scheduler again with their ORIGINAL ``submitted_tick`` (``out_tokens``
    cleared: they prefill again and greedy decoding regenerates the same
    stream), so the ledger charges the whole stall from arrival."""
    tokens = np.asarray(snap["tokens"], np.int32)
    if tokens.shape[0] != len(eng.slots):
        raise ValueError(f"snapshot has {tokens.shape[0]} slots, engine {len(eng.slots)}")
    restore_kvstore(eng.kv, snap["kv"])
    eng.tokens = torch.from_numpy(tokens.copy()).to(eng.tokens.device)
    eng.tick = int(snap["tick"])
    for req, state, slot in _unpack_requests(snap["requests"]):
        req.done = False
        if state == 0:
            if eng.slots[slot] is not None:
                raise ValueError(f"slot {slot} already occupied on restore")
            eng.slots[slot] = req
        else:
            req.out_tokens.clear()
            req.first_token_tick = -1
            eng.sched.submit(req, now=max(req.submitted_tick, 0))
    return eng


def slot_entry_from_snapshot(snap: dict, uid: int, *, device=None):
    """One in-slot request's resume tuple ``(cache1, length, next_token,
    out_tokens)`` from an engine snapshot, the payload
    `DisaggEngine.restores` admits, with ``cache1`` on ``device`` (cuda
    unless named). None when ``uid`` held no slot at snapshot time (it
    comes back by drop-and-retry instead). An int8 pool dequantizes here
    and quantizes again on admit: within the codec's tolerance, not bit
    for bit."""
    dev = resolve_device(device)
    tab = snap["requests"]
    hits = np.nonzero((np.asarray(tab["uid"], np.int64) == int(uid))
                      & (np.asarray(tab["state"], np.int64) == 0))[0]
    if len(hits) == 0:
        return None
    i = int(hits[0])
    slot = int(np.asarray(tab["slot"])[i])
    kv = snap["kv"]
    length = int(np.asarray(kv["lens"])[slot])
    next_tok = int(np.asarray(snap["tokens"])[slot, 0])
    out_tokens = [int(t) for t in _unflat(tab["out_flat"], tab["out_off"], i)]
    pos = torch.tensor(length, dtype=torch.int32, device=dev)
    if int(np.asarray(kv["kind"])) == 0:
        k = _unpack(kv["cache"]["k"], dev)
        v = _unpack(kv["cache"]["v"], dev)
        cache1 = {"k": k[:, slot: slot + 1].clone(), "v": v[:, slot: slot + 1].clone(),
                  "pos": pos}
        return cache1, length, next_tok, out_tokens
    dt = getattr(torch, str(np.asarray(kv["cache_dtype"])))
    k_pool = _unpack(kv["k_pool"], dev)
    v_pool = _unpack(kv["v_pool"], dev)
    tables = np.asarray(kv["tables"], np.int32)
    ln, _, bs, dk = k_pool.shape
    max_len = tables.shape[1] * bs
    k = torch.zeros((ln, 1, max_len, dk), dtype=dt, device=dev)
    v = torch.zeros((ln, 1, max_len, v_pool.shape[-1]), dtype=dt, device=dev)
    if "k_scale" in kv:
        k_scale = torch.from_numpy(np.asarray(kv["k_scale"], np.float32)).to(dev)
        v_scale = torch.from_numpy(np.asarray(kv["v_scale"], np.float32)).to(dev)
    for j, b in enumerate(tables[slot]):
        b = int(b)
        if b <= 0:
            continue
        bk, bv = k_pool[:, b], v_pool[:, b]
        if "k_scale" in kv:  # an int8 pool: dequantize with the block's row scales
            bk = (bk.float() * k_scale[:, b][..., None]).to(dt)
            bv = (bv.float() * v_scale[:, b][..., None]).to(dt)
        k[:, 0, j * bs: (j + 1) * bs] = bk.to(dt)
        v[:, 0, j * bs: (j + 1) * bs] = bv.to(dt)
    k[:, 0, length:] = 0  # zero past the cursor, like the dense view
    v[:, 0, length:] = 0
    return {"k": k, "v": v, "pos": pos}, length, next_tok, out_tokens


# ---------------------------------------------------------------------------
# the cadence wrapper FleetEngine drives
# ---------------------------------------------------------------------------


class ServingCheckpointer:
    """Periodic engine snapshots through `AsyncCheckpointer`.

    ``cadence`` is in engine ticks: `maybe_save(eng, tick)` snapshots
    whenever ``tick % cadence == 0`` (the snapshot is copied to the host
    at once, and the background thread writes it). `slot_entry` serves
    the checkpoint-recovery path per orphaned uid, keeping the loaded
    snapshot per step so that a multi-row fault reads the directory once.
    ``log`` is the writer's: per save its bytes, the seconds `save` blocked
    the caller (``snapshot_s`` + ``wait_s``) and the write's ``write_s``."""

    def __init__(self, directory: str, *, cadence: int = 0, keep: int = 3):
        self.directory = directory
        self.cadence = int(cadence)
        self._writer = ckpt_io.AsyncCheckpointer(directory, keep=keep)
        self.last_step = -1
        self.saves = 0
        self._loaded: tuple[int, Any] | None = None

    @property
    def log(self) -> list[dict]:
        return self._writer.log

    def maybe_save(self, eng, tick: int) -> bool:
        if self.cadence <= 0 or int(tick) % self.cadence != 0:
            return False
        self.save(eng, tick)
        return True

    def save(self, eng, tick: int) -> None:
        self._writer.save(int(tick), snapshot_engine(eng))
        self.last_step = int(tick)
        self.saves += 1

    def wait(self) -> None:
        """Block until the last save commits (raising a write's error)."""
        self._writer.wait()

    def load_latest(self):
        """The newest COMMITted snapshot tree, or None."""
        self._writer.wait()
        step = ckpt_io.latest_step(self.directory)
        if step is None:
            return None
        if self._loaded is None or self._loaded[0] != step:
            self._loaded = (step, ckpt_io.restore_tree(self.directory, step))
        return self._loaded[1]

    def slot_entry(self, uid: int, *, device=None):
        snap = self.load_latest()
        if snap is None:
            return None
        return slot_entry_from_snapshot(snap, uid, device=device)

    def restore_into(self, eng) -> bool:
        """Cold restore: load the newest snapshot into a fresh engine.
        False when the directory holds no committed snapshot."""
        snap = self.load_latest()
        if snap is None:
            return False
        restore_engine(eng, snap)
        return True

    def close(self) -> None:
        self._writer.close()


__all__ = [
    "ServingCheckpointer",
    "restore_engine",
    "restore_kvstore",
    "slot_entry_from_snapshot",
    "snapshot_engine",
    "snapshot_kvstore",
]
