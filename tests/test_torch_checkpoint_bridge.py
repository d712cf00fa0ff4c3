"""PyTorch port, the serving checkpoint bridge (`serve/checkpoint_bridge.py`):
KV-store and engine snapshots, their restores, the resume payload of one
slot and `ServingCheckpointer`, in the port and across the packages (both
write the same on-disk format, `io/checkpoint.py`).

What must hold: a snapshot round trip is bit for bit (pools, tables,
lengths, refcounts, the free set, the prefix cache in LRU order); a cold
restore replays the same streams with every original arrival tick; the
guards raise; a snapshot tree has the reference's key paths, shapes and
dtypes for the same engine state, with equal integer leaves (the float
leaves hold K/V and logits that the two packages compute ~1e-7 apart in
f32 before bf16 rounding, so only their layout is compared); and a
snapshot the reference wrote loads through the port and resumes the
reference's streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build as j_build
from repro.serve import KVSpec as JKVSpec
from repro.serve import Request as JRequest
from repro.serve.checkpoint_bridge import ServingCheckpointer as JServingCheckpointer
from repro.serve.checkpoint_bridge import snapshot_engine as j_snapshot_engine
from repro.serve.disagg import DisaggConfig as JDisaggConfig
from repro.serve.disagg import DisaggEngine as JDisaggEngine
from repro_torch.configs import get_smoke
from repro_torch.io.checkpoint import _leaf_paths
from repro_torch.models.model_zoo import build
from repro_torch.serve import KVSpec, Request
from repro_torch.serve.checkpoint_bridge import (
    ServingCheckpointer,
    restore_engine,
    restore_kvstore,
    slot_entry_from_snapshot,
    snapshot_engine,
    snapshot_kvstore,
)
from repro_torch.serve.disagg import DisaggConfig, DisaggEngine
from repro_torch.serve.fleet import FleetConfig, FleetEngine
from repro_torch.serve.kvstore import _FullEntry
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.treeutil import tree_flatten

NAME = "tinyllama-1.1b"
KINDS = {"paged": dict(kind="paged", block_size=8, prefix_cache=True),
         "int8": dict(kind="paged", block_size=8, kv_dtype="int8"),
         "dense": dict(kind="dense")}


@pytest.fixture(scope="module", autouse=True)
def _one_intraop_thread():
    """One intra-op thread for the smoke shapes: with several test workers
    on the machine, each worker's idle threads spinning against the
    others' slow these host loops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(j_get_smoke(NAME), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke(NAME), dtype=torch.float32)
    jm = j_build(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build(tc, device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return (jm, jp), (tm, tp)


def _cfg(kv: dict, jax_side: bool = False):
    spec = (JKVSpec if jax_side else KVSpec)(**kv)
    return (JDisaggConfig if jax_side else DisaggConfig)(
        n_prefill_rows=1, decode_slots=4, max_len=64, mode="continuous", prefill_chunk=16,
        kv=spec)


def _shared_prompts(vocab: int = 512):
    shared = np.arange(12, dtype=np.int32) % vocab
    return [np.concatenate([shared, np.full(3 + i, i, np.int32)]) for i in range(5)]


def _running(models, kind: str, jax_side: bool = False, ticks: int = 6):
    """An engine of the package mid-flight: 5 prompts behind a shared
    12-token prefix, ``ticks`` ticks."""
    (jm, jp), (tm, tp) = models
    if jax_side:
        eng, req = JDisaggEngine(jm, jp, _cfg(KINDS[kind], True)), JRequest
    else:
        eng, req = DisaggEngine(tm, tp, _cfg(KINDS[kind])), Request
    for i, prompt in enumerate(_shared_prompts()):
        eng.submit(req(uid=i, prompt=prompt, max_new_tokens=6))
    for _ in range(ticks):
        eng.step()
    return eng


def _streams(eng):
    return {r.uid: (list(r.out_tokens), r.submitted_tick) for r in eng.finished}


@pytest.mark.parametrize("kind", list(KINDS))
def test_kvstore_snapshot_round_trip_is_bitwise(models, kind):
    """snapshot_kvstore -> restore_kvstore gives a mid-flight store back
    exactly: pools (and int8 scales), tables, lengths, refcounts, the free
    set, the peak, and the prefix cache's entries in LRU order."""
    src = _running(models, kind).kv
    assert np.any(src.lens > 0), "setup: slots should hold live KV"
    dst = DisaggEngine(*models[1], _cfg(KINDS[kind])).kv
    restore_kvstore(dst, snapshot_kvstore(src))
    np.testing.assert_array_equal(dst.lens, src.lens)
    if kind == "dense":
        for key in src.cache:
            assert torch.equal(dst.cache[key], src.cache[key])
        return
    assert torch.equal(dst.k_pool, src.k_pool) and torch.equal(dst.v_pool, src.v_pool)
    if src.quantized:
        assert torch.equal(dst.k_scale, src.k_scale) and torch.equal(dst.v_scale, src.v_scale)
    np.testing.assert_array_equal(dst.tables, src.tables)
    np.testing.assert_array_equal(dst.ref, src.ref)
    np.testing.assert_array_equal(dst._pref, src._pref)
    assert sorted(dst._free) == sorted(src._free) and dst.peak_blocks == src.peak_blocks
    if src.prefix is None:
        return
    assert src.prefix.entries, "setup: the prefix cache should hold entries"
    assert list(dst.prefix.entries) == list(src.prefix.entries)  # LRU order
    for key, a in src.prefix.entries.items():
        b = dst.prefix.entries[key]
        if isinstance(a, _FullEntry):
            assert (a.length, a.blocks, a.first) == (b.length, b.blocks, b.first)
            for f in ("logits", "k_tail", "v_tail"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        else:
            assert a == b
    assert (dst.prefix.hits, dst.prefix.misses, dst.prefix.hit_tokens) == \
           (src.prefix.hits, src.prefix.misses, src.prefix.hit_tokens)


@pytest.mark.parametrize("kind", list(KINDS))
def test_slot_entry_is_the_live_slot(models, kind):
    """The resume payload of an in-slot request equals the live store's
    `slot_cache` (an int8 pool dequantized alike), with its length, next
    token and tokens so far; a request in no slot has none."""
    eng = _running(models, kind)
    snap = snapshot_engine(eng)
    live = [(i, r) for i, r in enumerate(eng.slots) if r is not None]
    assert live
    for i, req in live:
        cache1, length, next_tok, out_tokens = slot_entry_from_snapshot(snap, req.uid,
                                                                        device="cpu")
        want = eng.kv.slot_cache(i)
        n = int(eng.kv.lens[i])
        assert (length, next_tok, out_tokens) == (n, int(eng.tokens[i, 0]), req.out_tokens)
        for key in ("k", "v"):
            got, ref = cache1[key][:, :, :n], want[key][:, :, :n]
            assert got.dtype == ref.dtype and torch.equal(got, ref)
            assert not cache1[key][:, :, n:].any()
        assert int(cache1["pos"]) == n
    assert slot_entry_from_snapshot(snap, 999, device="cpu") is None


def _fleet(models, **over):
    kw = dict(mode="continuous", n_rows=4, prefill_rows=1, slots_per_row=2, max_len=64,
              prefill_chunk=16, min_rows=2)
    kw.update(over)
    return FleetEngine(*models[1], FleetConfig(**kw))


def test_cold_restore_replays_identical_streams(models, tmp_path):
    """A fresh fleet restored from a mid-flight snapshot finishes the streams
    of the fleet that kept running, each request with its ORIGINAL
    ``submitted_tick``."""
    d = str(tmp_path / "serving")
    live = _fleet(models, ckpt_dir=d, ckpt_cadence=2)
    submitted_at = {}
    rng = np.random.default_rng(0)
    for t in range(3):  # staggered arrivals: submitted_tick varies
        for i in (2 * t, 2 * t + 1):
            r = Request(uid=i, prompt=rng.integers(0, 100, 5 + i).astype(np.int32),
                        max_new_tokens=6)
            live.submit(r)
            submitted_at[i] = r.submitted_tick
        live.step()
    for _ in range(2):
        live.step()
    live.ckpt.save(live.eng, live.eng.tick)
    live.ckpt.wait()  # the restorer below is another instance
    cold = _fleet(models)
    restorer = ServingCheckpointer(d, cadence=0)
    assert restorer.restore_into(cold.eng)
    restorer.close()
    live.drain()
    live.ckpt.close()
    cold.drain()
    assert _streams(cold) == _streams(live)
    assert all(r.submitted_tick == submitted_at[r.uid] for r in cold.finished)
    assert live.ckpt.log and all(e["bytes"] > 0 and "write_s" in e for e in live.ckpt.log)


def test_restore_guards_raise(models):
    fe = _fleet(models)
    rng = np.random.default_rng(0)
    for i in range(8):
        fe.submit(Request(uid=i, prompt=rng.integers(0, 100, 5 + i % 3).astype(np.int32),
                          max_new_tokens=8))
    for _ in range(4):
        fe.step()
    snap = snapshot_engine(fe.eng)
    with pytest.raises(ValueError, match="slots"):
        restore_engine(_fleet(models, n_rows=3).eng, snap)
    with pytest.raises(ValueError, match="occupied"):
        restore_engine(fe.eng, snap)  # the live engine's slots are taken
    with pytest.raises(ValueError, match="paged"):
        restore_kvstore(_fleet(models).eng.kv, snapshot_kvstore(_running(models, "paged").kv))
    with pytest.raises(ValueError, match="dense"):
        restore_kvstore(_running(models, "paged", ticks=0).kv,
                        snapshot_kvstore(_fleet(models).eng.kv))


def _layout(tree, jax_side: bool) -> dict:
    """key path -> (shape, dtype name) of a snapshot tree."""
    if jax_side:
        return {jax.tree_util.keystr(p): (tuple(np.shape(x)), np.asarray(x).dtype.name)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    leaves = tree_flatten(tree)[0]
    return {p: (tuple(np.shape(x)), np.asarray(x).dtype.name)
            for p, x in zip(_leaf_paths(tree), leaves)}


@pytest.mark.parametrize("kind", ["paged", "int8", "dense"])
def test_snapshot_tree_matches_reference(models, kind):
    """The same engine state in both packages gives snapshot trees with
    the same key paths, shapes and dtypes, and the same integer leaves
    (tables, lengths, refcounts, prefix keys, the request table)."""
    t = snapshot_engine(_running(models, kind))
    j = j_snapshot_engine(_running(models, kind, jax_side=True))
    assert _layout(t, False) == _layout(j, True)
    tl = dict(zip(_leaf_paths(t), tree_flatten(t)[0]))
    for path, x in jax.tree_util.tree_flatten_with_path(j)[0]:
        a, b = np.asarray(tl[jax.tree_util.keystr(path)]), np.asarray(x)
        if a.dtype.kind in "iuU":
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_reference_snapshot_resumes_in_the_port(models, tmp_path):
    """A snapshot the reference's `ServingCheckpointer` wrote loads through
    the port's `load_latest` and restores into a fresh port engine, which
    then finishes the streams the reference's engine finishes."""
    d = str(tmp_path / "ref_serving")
    jeng = _running(models, "paged", jax_side=True)
    jck = JServingCheckpointer(d, cadence=0)
    jck.save(jeng, jeng.tick)
    jck.close()
    ck = ServingCheckpointer(d, cadence=0)
    snap = ck.load_latest()
    assert int(snap["tick"]) == jeng.tick
    teng = DisaggEngine(*models[1], _cfg(KINDS["paged"]))
    restore_engine(teng, snap)
    ck.close()
    assert [r.uid if r else None for r in teng.slots] == \
           [r.uid if r else None for r in jeng.slots]
    done_before = {r.uid for r in jeng.finished}
    jeng.drain()
    teng.drain()
    want = {u: s[0] for u, s in _streams(jeng).items() if u not in done_before}
    assert want and {u: s[0] for u, s in _streams(teng).items()} == want
