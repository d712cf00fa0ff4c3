"""PyTorch port, KV operators and stores: `repro_torch.core.operators` and
`repro_torch.serve.kvstore` against their `repro` counterparts.

The operators move and quantize data without arithmetic of their own, so
they are compared bit for bit. The stores are driven through one scripted
sequence of admissions (cold, shared-prefix, whole-prompt hits), decode
appends, truncations and retirements, in a pool small enough to force
prefix-cache eviction; after every operation the host bookkeeping
(tables, lens, refcounts, the free heap, the LRU order, peak blocks,
stats) must be identical, and the pool contents bit-identical.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import operators as jo
from repro.models import build as j_build
from repro.serve import KVSpec as JKVSpec
from repro.serve import make_kvstore as j_make_kvstore
from repro_torch.configs import get_smoke
from repro_torch.core import operators as to
from repro_torch.models.model_zoo import build
from repro_torch.serve import KVSpec, make_kvstore
from repro_torch.utils.convert import tensor_from_numpy

NAME = "tinyllama-1.1b"


def _np(x):
    """Either side's array as numpy, bf16 as its f32 value (exact)."""
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _same(t, j):
    np.testing.assert_array_equal(_np(t), _np(j))


def _bf16(rng, *shape):
    """Random values that bf16 holds exactly, as f32 numpy."""
    return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16), np.float32)


# -- operators -------------------------------------------------------------------


def test_paged_gather_and_blockify_match_reference():
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(2, 6, 4, 8)).astype(np.float32)
    table = np.array([[3, -1, 1], [-1, -1, -1], [5, 2, 4]], np.int32)
    _same(to.paged_gather(torch.from_numpy(pool), torch.from_numpy(table)),
          jo.paged_gather(jnp.asarray(pool), jnp.asarray(table)))
    leaf = rng.normal(size=(2, 1, 10, 8)).astype(np.float32)
    for start, n in [(0, 3), (4, 2), (8, 1), (10, 1), (0, 1)]:
        _same(to.blockify_cache_leaf(torch.from_numpy(leaf), start, n, 4),
              jo.blockify_cache_leaf(jnp.asarray(leaf), start, n, 4))


@pytest.mark.parametrize("quantized", [False, True])
def test_migrate_cache_into_blocks_in_place_matches_reference(quantized):
    rng = np.random.default_rng(1)
    pool = _bf16(rng, 2, 7, 4, 8)
    cache1 = {"k": _bf16(rng, 2, 1, 10, 8), "v": _bf16(rng, 2, 1, 10, 8)}
    ids = np.array([5, 2, 6], np.int32)
    tk = tensor_from_numpy(pool, "cpu").to(torch.bfloat16)
    tv = tk.clone()
    tc = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in cache1.items()}
    jk = jnp.asarray(pool, jnp.bfloat16)
    jc = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache1.items()}
    if quantized:
        tk, ts = to.kv_quantize(tk)
        tv, tvs = tk.clone(), ts.clone()
        jk, js = jo.kv_quantize(jk)
        got = to.migrate_cache_into_blocks_int8(tk, tv, ts, tvs, tc, torch.from_numpy(ids),
                                                start=2, block_size=4)
        want = jo.migrate_cache_into_blocks_int8(jk, jk, js, js, jc, jnp.asarray(ids),
                                                 start=2, block_size=4)
        assert got[0] is tk and got[2] is ts  # written in place
    else:
        got = to.migrate_cache_into_blocks(tk, tv, tc, torch.from_numpy(ids),
                                           start=2, block_size=4)
        want = jo.migrate_cache_into_blocks(jk, jk, jc, jnp.asarray(ids),
                                            start=2, block_size=4)
        assert got[0] is tk  # written in place
    for g, w in zip(got, want):
        _same(g, w)


def test_int8_codec_and_gather_match_reference():
    rng = np.random.default_rng(2)
    pool = rng.normal(size=(2, 5, 4, 8)).astype(np.float32) * 3
    table = np.array([[2, -1], [4, 1]], np.int32)
    tq, ts = to.kv_quantize(torch.from_numpy(pool))
    jq, js = jo.kv_quantize(jnp.asarray(pool))
    for dtype, jdtype in [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]:
        _same(to.kv_dequantize(tq, ts, dtype), jo.kv_dequantize(jq, js, jdtype))
        got = to.paged_gather_cache_int8(tq, tq, ts, ts, torch.from_numpy(table), [3, 8],
                                         dtype=dtype)
        want = jo.paged_gather_cache_int8(jq, jq, js, js, jnp.asarray(table), [3, 8],
                                          dtype=jdtype)
        for key in ("k", "v", "pos"):
            _same(got[key], want[key])


def test_migrate_cache_into_slot_matches_reference():
    rng = np.random.default_rng(3)
    dst = {"k": _bf16(rng, 2, 3, 12, 8), "v": _bf16(rng, 2, 3, 12, 8)}
    src = {"k": _bf16(rng, 2, 1, 5, 8), "v": _bf16(rng, 2, 1, 5, 8)}
    tdst = {k: torch.from_numpy(v) for k, v in dst.items()}
    to.migrate_cache_into_slot(tdst, {k: torch.from_numpy(v) for k, v in src.items()}, 1)
    want = jo.migrate_cache_into_slot({k: jnp.asarray(v) for k, v in dst.items()},
                                      {k: jnp.asarray(v) for k, v in src.items()}, 1)
    for key in ("k", "v"):
        _same(tdst[key], want[key])


def test_migrate_cache_into_slot_copies_ssm_leaves():
    """An SSM cache's non-sequence leaves, the f32 recurrent state
    (L, B, H, P, N) and the bf16 conv window (L, B, K-1, C), migrate whole
    into the slot, and the shared cursor advances to the longer one."""
    rng = np.random.default_rng(4)
    dst = {"ssm_state": rng.normal(size=(2, 3, 4, 8, 6)).astype(np.float32),
           "ssm_conv": _bf16(rng, 2, 3, 3, 10), "pos": np.int32(9)}
    src = {"ssm_state": rng.normal(size=(2, 1, 4, 8, 6)).astype(np.float32),
           "ssm_conv": _bf16(rng, 2, 1, 3, 10), "pos": np.int32(12)}
    dtypes = {"ssm_state": (torch.float32, jnp.float32),
              "ssm_conv": (torch.bfloat16, jnp.bfloat16), "pos": (torch.int32, jnp.int32)}

    def tside(tree):
        return {k: torch.as_tensor(v).to(dtypes[k][0]) for k, v in tree.items()}

    def jside(tree):
        return {k: jnp.asarray(v, dtypes[k][1]) for k, v in tree.items()}

    tdst = tside(dst)
    to.migrate_cache_into_slot(tdst, tside(src), 1)
    want = jo.migrate_cache_into_slot(jside(dst), jside(src), 1)
    for key in dst:
        assert tdst[key].dtype == dtypes[key][0]
        _same(tdst[key], want[key])
    _same(tdst["ssm_state"][:, 1], src["ssm_state"][:, 0])
    assert int(tdst["pos"]) == 12


# -- stores ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(j_get_smoke(NAME), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke(NAME), dtype=torch.float32)
    return j_build(jc), build(tc, device="cpu")


def _check_host_state(t, j):
    np.testing.assert_array_equal(t.lens, j.lens)
    if t.kind == "dense":
        return
    np.testing.assert_array_equal(t.tables, j.tables)
    np.testing.assert_array_equal(t.ref, j.ref)
    np.testing.assert_array_equal(t._pref, j._pref)
    assert t._free == j._free  # the heap's list, element for element
    assert t.peak_blocks == j.peak_blocks
    assert t.stats == j.stats
    assert t.free_tokens() == j.free_tokens()
    if j.prefix is not None:
        assert list(t.prefix.entries) == list(j.prefix.entries)  # LRU order
        for key, je in j.prefix.entries.items():
            te = t.prefix.entries[key]
            if isinstance(je, tuple):
                assert te == je
            else:
                assert (te.length, te.blocks, te.first) == (je.length, je.blocks, je.first)
                _same(te.k_tail, je.k_tail)


def _check_pools(t, j):
    """Pools bit-identical, except int8 pools: the reference's store runs
    `kv_quantize` under `jax.jit`, where XLA's CPU compiler turns the
    division by 127 into a multiplication by its reciprocal. Its scales
    then sit up to one f32 ulp off the IEEE quotient that the port, eager
    JAX and numpy all compute (so scales get rtol 2.4e-7, two ulps), and a
    value on a rounding edge quantizes one step apart (int8 data get 1)."""
    active = list(range(t.slots))
    if t.kind == "dense":
        _same(t.cache["k"], j.cache["k"])
        _same(t.cache["v"], j.cache["v"])
        return
    tk, jk = t.kernel_view(active), j.kernel_view(active)
    for key in tk:
        assert tk[key].dtype == getattr(torch, str(jk[key].dtype))
        if key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(_np(tk[key]), _np(jk[key]), rtol=2.4e-7, atol=0)
        elif t.quantized and key in ("k_pool", "v_pool"):
            np.testing.assert_allclose(_np(tk[key]), _np(jk[key]), rtol=0, atol=1)
        else:
            _same(tk[key], jk[key])
    if not t.quantized:  # the int8 view is the gather + dequant checked above
        tv, jv = t.view(active), j.view(active)
        for key in ("k", "v", "pos"):
            _same(tv[key], jv[key])


class _Driver:
    """Runs one operation on both stores and checks them after it."""

    def __init__(self, models, spec: dict, slots: int, max_len: int):
        jm, tm = models
        self.j = j_make_kvstore(jm, slots, max_len, JKVSpec(**spec), ragged=True)
        self.t = make_kvstore(tm, slots, max_len, KVSpec(**spec), ragged=True)
        self.rng = np.random.default_rng(7)
        self.ln, self.d = tm.cfg.n_layers, tm.cfg.d_kv

    def check(self):
        _check_host_state(self.t, self.j)
        _check_pools(self.t, self.j)

    def admit(self, slot, prompt):
        n = len(prompt)
        bucket = max(8, 1 << (n - 1).bit_length())
        k = _bf16(self.rng, self.ln, 1, bucket, self.d)
        v = _bf16(self.rng, self.ln, 1, bucket, self.d)
        k[:, :, n:] = v[:, :, n:] = 0  # a length-masked prefill's padding
        logits = self.rng.normal(size=(16,)).astype(np.float32)
        first = int(self.rng.integers(0, 16))
        hit_t, hit_j = self.t.full_hit(prompt), self.j.full_hit(prompt)
        assert (hit_t is None) == (hit_j is None)
        if hit_j is not None:
            info = (self.t.admit_from_full(slot, hit_t), self.j.admit_from_full(slot, hit_j))
        else:
            tc = {"k": torch.from_numpy(k).to(torch.bfloat16),
                  "v": torch.from_numpy(v).to(torch.bfloat16)}
            jc = {"k": jnp.asarray(k, jnp.bfloat16), "v": jnp.asarray(v, jnp.bfloat16),
                  "pos": jnp.int32(n)}
            info = (self.t.admit(slot, tc, n, tokens=prompt, logits=torch.from_numpy(logits),
                                 first=first),
                    self.j.admit(slot, jc, n, tokens=prompt, logits=jnp.asarray(logits),
                                 first=first))
        assert info[0] == info[1]
        self.check()

    def decode(self, active):
        rows = [_bf16(self.rng, self.ln, self.t.slots, self.d) for _ in range(2)]
        self.t.absorb_rows(*(torch.from_numpy(r).to(torch.bfloat16) for r in rows), active)
        self.j.absorb_rows(*(jnp.asarray(r, jnp.bfloat16) for r in rows), active)
        self.check()

    def free(self, slot):
        self.t.free(slot)
        self.j.free(slot)
        self.check()

    def truncate(self, slot, n):
        self.t.truncate(slot, n)
        self.j.truncate(slot, n)
        self.check()


def _prompts(seed=5):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 100, 9).astype(np.int32)

    def tail(n):
        return rng.integers(0, 100, n).astype(np.int32)

    return {"a": np.concatenate([shared, tail(6)]), "b": np.concatenate([shared, tail(2)]),
            "c": tail(13), "d": tail(4), "e": np.concatenate([shared, tail(11)]),
            "f": tail(21)}


@pytest.mark.parametrize("kv_dtype", ["cache", "int8"])
def test_paged_store_matches_reference_step_for_step(models, kv_dtype):
    """Cold and shared-prefix admissions, a whole-prompt hit, decode
    appends across block boundaries and past max_len, a truncation, and
    retirements, in a 12-block pool with an 8-entry prefix LRU: entries
    fall off the LRU's end, and allocation evicts them while live slots
    hold their blocks."""
    p = _prompts()
    drv = _Driver(models, dict(kind="paged", block_size=4, n_blocks=12, prefix_cache=True,
                               prefix_capacity=8, kv_dtype=kv_dtype), slots=3, max_len=24)
    drv.check()
    drv.admit(0, p["a"])
    drv.admit(1, p["b"])  # chain hit on the shared 8 tokens
    drv.decode([0, 1])
    drv.decode([0, 1])  # slot 1 crosses into a fresh tail block
    drv.admit(2, p["c"])
    for _ in range(3):
        drv.decode([0, 1, 2])
    drv.truncate(0, 17)
    drv.free(1)
    drv.admit(1, p["a"])  # whole-prompt hit: no prefill
    drv.decode([0, 1, 2])
    drv.free(2)
    drv.admit(2, p["d"])
    drv.free(0)
    drv.admit(0, p["e"])
    drv.free(1)
    drv.free(2)
    drv.admit(1, p["f"])  # needs eviction to find its blocks
    for _ in range(4):
        drv.decode([1])  # slot 1 runs into max_len: the cursor stops
    drv.free(0)
    drv.free(1)
    assert drv.t.stats["blocks_in_use"] == drv.t.stats["evictable_blocks"]


def test_dense_store_matches_reference(models):
    p = _prompts(6)
    drv = _Driver(models, dict(kind="dense"), slots=2, max_len=16)
    drv.admit(0, p["c"])
    drv.admit(1, p["d"])
    drv.decode([0, 1])
    drv.decode([0, 1])  # slot 0 reaches max_len
    drv.decode([0, 1])
    drv.free(0)
    drv.admit(0, p["d"][:3])  # zero-extends over the old occupant
    drv.decode([0, 1])
    tk, jk = drv.t.kernel_view([0, 1]), drv.j.kernel_view([0, 1])
    for key in tk:
        _same(tk[key], jk[key])
    assert drv.t.free_tokens() == drv.j.free_tokens() and drv.t.stats == drv.j.stats


@pytest.mark.parametrize("name", [NAME, "mamba2-130m"])
def test_aligned_dense_store_matches_reference(name):
    """Aligned mode (``ragged=False``): `view` is the whole cache, `admit`
    migrates every leaf of a batch-1 prefill cache with its ``pos`` (the
    shared cursor advances to the longest), `absorb` takes a decode
    step's cache back whole and advances the active lengths, and
    `slot_cache` reads a slot back as a batch-1 cache. Dense k/v, or an
    SSM's state and conv window; bit for bit against the JAX store."""
    jm = j_build(dataclasses.replace(j_get_smoke(name), dtype=jnp.float32))
    tm = build(dataclasses.replace(get_smoke(name), dtype=torch.float32), device="cpu")
    j = j_make_kvstore(jm, 3, 16, JKVSpec(), ragged=False)
    t = make_kvstore(tm, 3, 16, KVSpec(), ragged=False)
    assert t.view() is t.cache and not t.ragged
    rng = np.random.default_rng(8)
    for slot, n in ((0, 7), (2, 11), (1, 4)):
        jc = {k: v[:, :1, :n] if k in ("k", "v") else v[:, :1]
              for k, v in j_make_kvstore(jm, 1, n, JKVSpec(), ragged=False).cache.items()
              if k != "pos"}
        jc = {k: jnp.asarray(_bf16(rng, *v.shape), v.dtype) for k, v in jc.items()}
        tc = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jc.items()}
        jc["pos"], tc["pos"] = jnp.int32(n), torch.tensor(n, dtype=torch.int32)
        assert t.admit(slot, tc, n) == j.admit(slot, jc, n)
        for key in j.cache:
            _same(t.cache[key], j.cache[key])
        np.testing.assert_array_equal(t.lens, j.lens)
    stepped = {k: (v + 1 if k == "pos" else v) for k, v in j.cache.items()}
    j.absorb(stepped, [0, 2])
    t.absorb({k: (v + 1 if k == "pos" else v) for k, v in t.cache.items()}, [0, 2])
    np.testing.assert_array_equal(t.lens, j.lens)
    assert int(t.cache["pos"]) == int(j.cache["pos"]) == 12
    ts, js = t.slot_cache(2), j.slot_cache(2)
    assert set(ts) == set(js)
    for key in js:
        _same(ts[key], js[key])
    with pytest.raises(RuntimeError, match="ragged"):
        t.kernel_view([0])


def test_store_validation():
    tm = build(get_smoke(NAME), device="cpu")
    with pytest.raises(ValueError, match="multiple of block_size"):
        make_kvstore(tm, 2, 30, KVSpec(kind="paged", block_size=16), ragged=True)
    with pytest.raises(ValueError, match="cannot hold one full request"):
        make_kvstore(tm, 2, 32, KVSpec(kind="paged", block_size=16, n_blocks=2), ragged=True)
    with pytest.raises(ValueError, match="requires kind='paged'"):
        KVSpec(kind="dense", kv_dtype="int8")
    st = make_kvstore(tm, 2, 32, KVSpec(kind="paged", block_size=16, kv_dtype="int8"),
                      ragged=True)
    assert st.n_blocks == 2 * 2 * 2 + 1  # int8 holds twice the bf16 pages
    assert st.k_pool.dtype == torch.int8 and st.k_scale.dtype == torch.float32
