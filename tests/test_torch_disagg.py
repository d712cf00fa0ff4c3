"""PyTorch port, disaggregated prefill/decode serving (`serve/disagg.py`)
and the cache operators of its handoff, against the JAX package on the
same inputs.

  * the cache operators: pack -> stream element by element -> unpack ->
    migrate, and the ``ok=False`` migration, on the same numbers in both
    packages: bit for bit;
  * `PrefillScheduler`: the same rows and the same work per tick;
  * `DisaggEngine` in lockstep with the reference's on the f32
    tinyllama smoke weights (aligned over the dense store; continuous
    over the paged store with the prefix cache): every tick's
    ``last_tick`` record (every key) and the slots, the stats, the token
    streams, ``first_token_tick`` and ``done_tick`` identical; decode
    logits within 1e-4 in continuous mode and 1e-3 in aligned mode (the
    dense slot cache is bf16 in both packages, and a K/V row the two
    compute 1e-7 apart in f32 can round one bf16 ulp apart, as
    tests/test_torch_engine.py's aligned test states);
  * `stage_out` -> admit again, `resize` with slots in flight, the drain
    stall, and, inside the port, the aligned engine against the colocated
    `Engine` bit for bit (the reference's own contract);
  * `build_disagg_spmd_step` in a 4-rank gloo world against the
    reference's `shard_map` step on 4 fake CPU devices (one world and one
    JAX subprocess, side by side): decode tokens and stats identical, the
    caches within one bf16 ulp of their values (rtol 2^-7: prefill K/V
    computed ~1e-7 apart in f32 may round apart), ``pos`` exact; then the
    serving reshard inside the world against the reference's;
  * the serving reshards between planning meshes of other sizes
    (tests/test_faults.py:475, tests/test_dataflow.py:431, the paged
    reshard), on the same arrays as the reference's in that JAX
    subprocess (on 8 fake devices), and `repack_block_pool`: bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO
from repro.configs import get_smoke as j_get_smoke
from repro.core import operators as jops
from repro.core.imbalance import skewed_partition
from repro.launch.elastic import repack_block_pool as j_repack
from repro.models import build as j_build
from repro.serve import KVSpec as JKVSpec
from repro.serve import Request as JRequest
from repro.serve.disagg import DisaggConfig as JDisaggConfig
from repro.serve.disagg import DisaggEngine as JDisaggEngine
from repro.serve.disagg import PrefillScheduler as JPrefillScheduler
from repro_torch.configs import get_smoke
from repro_torch.core import operators as tops
from repro_torch.core.groups import GroupedMesh
from repro_torch.launch.elastic import repack_block_pool
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.model_zoo import build
from repro_torch.serve import Engine, EngineConfig, KVSpec, Request
from repro_torch.serve.disagg import (
    PREFILL,
    DisaggConfig,
    DisaggEngine,
    PrefillScheduler,
    init_disagg_state,
)
from repro_torch.serve.fleet import reshard_paged_serving_state, reshard_serving_state
from repro_torch.utils.convert import params_from_numpy
from torch_worlds import DISAGG, DISAGG_ALPHAS, DISAGG_ROWS, DISAGG_TICKS, disagg_cases

NAME = "tinyllama-1.1b"
CONT_TOL = dict(atol=1e-4, rtol=1e-4)
ALIGNED_TOL = dict(atol=1e-3, rtol=1e-3)
BF16_ULP = 2.0 ** -7


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


def _workload(vocab: int, seed: int = 0):
    """(uid, prompt, max_new): prompts of 3..40 tokens, half behind a
    shared 16-token prefix, one exact repeat (a whole-prompt hit)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 16)
    out = []
    for i in range(9):
        prompt = rng.integers(0, vocab, int(rng.integers(3, 25)))
        if i % 2:
            prompt = np.concatenate([prefix, prompt])
        out.append((i, prompt.astype(np.int32), int(rng.integers(2, 9))))
    out.append((9, out[1][1].copy(), 4))
    return out


def _streams(engine):
    return {r.uid: (tuple(r.out_tokens), r.first_token_tick, r.done_tick)
            for r in engine.finished}


def _lockstep(models, work, tol, **cfg):
    """Both packages' engines over the same requests, tick by tick."""
    (jm, jp), (tm, tp) = models
    jkv, tkv = (JKVSpec(**cfg["kv"]), KVSpec(**cfg["kv"])) if "kv" in cfg else ({}, {})
    rest = {k: v for k, v in cfg.items() if k != "kv"}
    je = JDisaggEngine(jm, jp, JDisaggConfig(**rest, **({"kv": jkv} if jkv else {})))
    te = DisaggEngine(tm, tp, DisaggConfig(**rest, **({"kv": tkv} if tkv else {})))
    for uid, prompt, m in work:
        je.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))
        te.submit(Request(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    while not (je.idle() and te.idle()):
        je.step()
        te.step()
        assert te.last_tick == je.last_tick, te.tick
        assert [s.uid if s else None for s in te.slots] == \
               [s.uid if s else None for s in je.slots], te.tick
        if te.last_tick["decode_batch"]:
            np.testing.assert_allclose(te.last_logits.numpy(), np.asarray(je.last_logits),
                                       **tol)
        assert te.tick < 300
    assert te.tick == je.tick and te.stats == je.stats
    assert _streams(te) == _streams(je)
    assert [dataclasses.astuple(c) for c in te.ledger.completions] == \
           [dataclasses.astuple(c) for c in je.ledger.completions]
    return je, te


# -- the cache operators -------------------------------------------------------------


def _cache_numbers(seed: int, s: int = 12):
    """A batch-1 cache (L=2, s, 32) of bf16-representable numbers."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(2, 1, s, 32)).astype(np.float32)
    v = rng.normal(size=(2, 1, s, 32)).astype(np.float32)
    t = {"k": torch.from_numpy(k).bfloat16(), "v": torch.from_numpy(v).bfloat16(),
         "pos": torch.tensor(s - 3, dtype=torch.int32)}
    host = {"k": t["k"].float().numpy(), "v": t["v"].float().numpy()}
    j = {"k": jnp.asarray(host["k"]).astype(jnp.bfloat16),
         "v": jnp.asarray(host["v"]).astype(jnp.bfloat16), "pos": jnp.int32(s - 3)}
    return t, j


@pytest.mark.parametrize("chunk", [100, 512, 4096])
def test_cache_stream_round_trip_matches_reference(chunk):
    """The same cache through both packages' pack -> fold -> unpack ->
    migrate: the plan, every stream element, the assembled cache and the
    migrated slot pool bit for bit; ``pos`` rides apart (advances the
    shared cursor to the larger)."""
    t, j = _cache_numbers(0)
    tp, jp = tops.cache_stream_plan(t, chunk), jops.cache_stream_plan(j, chunk)
    assert (tp.n_chunks, tp.chunk_elems, tp.padded) == (jp.n_chunks, jp.chunk_elems, jp.padded)
    te, je = tops.pack_cache(t, tp), jops.pack_cache(j, jp)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    top, jop = tops.cache_migration_op(tp, device="cpu"), jops.cache_migration_op(jp)
    ts, js = top.init(), jop.init()
    for k in range(tp.n_chunks):  # fold as the consumer does, element by element
        ts = top.apply(ts, te[k], k)
        js = jop.apply(js, je[k], jnp.asarray(k))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tr, jr = tp.unpack(ts), jp.unpack(js)
    for key in ("k", "v"):
        assert tr[key].dtype == torch.bfloat16
        assert torch.equal(tr[key], t[key])  # the producer's cache, bit for bit
        np.testing.assert_array_equal(tr[key].float().numpy(),
                                      np.asarray(jr[key]).astype(np.float32))
    tr["pos"], jr["pos"] = t["pos"], j["pos"]
    tdst = {"k": torch.full((2, 3, 24, 32), 7.0, dtype=torch.bfloat16),
            "v": torch.full((2, 3, 24, 32), 7.0, dtype=torch.bfloat16),
            "pos": torch.tensor(4, dtype=torch.int32)}
    jdst = {"k": jnp.full((2, 3, 24, 32), 7.0, jnp.bfloat16),
            "v": jnp.full((2, 3, 24, 32), 7.0, jnp.bfloat16), "pos": jnp.int32(4)}
    tops.migrate_cache_into_slot(tdst, tr, 1)
    jout = jops.migrate_cache_into_slot(jdst, jr, 1)
    for key in ("k", "v"):
        np.testing.assert_array_equal(tdst[key].float().numpy(),
                                      np.asarray(jout[key]).astype(np.float32))
    assert int(tdst["pos"]) == int(jout["pos"]) == 9
    assert tdst["k"][:, 1, 12:].abs().sum() == 0  # zero-extended, no stale KV


@pytest.mark.parametrize("ok", [False, True, "tensor-false"])
def test_migrate_ok_mask_matches_reference(ok):
    """``ok`` false leaves the destination untouched, ``pos`` included
    (in place: the very tensors keep their values); true migrates."""
    t, j = _cache_numbers(1)
    flag = torch.tensor(False) if ok == "tensor-false" else ok
    tdst = {"k": torch.zeros((2, 2, 16, 32), dtype=torch.bfloat16),
            "v": torch.zeros((2, 2, 16, 32), dtype=torch.bfloat16),
            "pos": torch.tensor(2, dtype=torch.int32)}
    before = {k: v.clone() for k, v in tdst.items()}
    jdst = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16 if k != "pos" else jnp.int32)
            for k, v in tdst.items()}
    out = tops.migrate_cache_into_slot(tdst, t, 0, ok=flag)
    jout = jops.migrate_cache_into_slot(jdst, j, 0, ok=jnp.asarray(bool(flag)))
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(out[key].float().numpy(),
                                      np.asarray(jout[key]).astype(np.float32))
        assert torch.equal(out[key], before[key]) == (not bool(flag)), key


def test_port_prefill_cache_round_trips(models):
    """A real prefill cache of the port through the stream, exactly."""
    _, (tm, tp) = models
    _, cache1 = tm.prefill(tp, torch.arange(6)[None] % tm.cfg.vocab_size)
    plan = tops.cache_stream_plan(cache1, chunk_elems=128)
    elems = tops.pack_cache(cache1, plan)
    op = tops.cache_migration_op(plan, device="cpu")
    staged = op.init()
    for k in range(plan.n_chunks):
        staged = op.apply(staged, elems[k], k)
    rebuilt = plan.unpack(staged)
    for key in ("k", "v"):
        assert torch.equal(rebuilt[key], cache1[key])


# -- the prefill scheduler ------------------------------------------------------------


def test_scheduler_balances_skewed_prompts():
    """The reference's contract: least-loaded admission keeps skewed prompt
    work spread over the rows."""
    lens = 1 + skewed_partition(2000, 64, skew=1.0, rng=np.random.default_rng(0))
    sched = PrefillScheduler(n_rows=4, chunk=0)
    for i, n in enumerate(lens):
        sched.admit(Request(uid=i, prompt=np.zeros(int(n), np.int32)))
    loads = sched.load()
    assert max(loads) <= 2 * (sum(loads) / len(loads)) + int(lens.max())


@pytest.mark.parametrize("chunk", [0, 8])
def test_scheduler_matches_reference(chunk):
    """Skewed prompts admitted and ticked in both packages, with arrivals
    between ticks: the same row per request and the same work and
    finished requests every tick."""
    lens = 1 + skewed_partition(600, 48, skew=0.9, rng=np.random.default_rng(1))
    ts, js = PrefillScheduler(3, chunk), JPrefillScheduler(3, chunk)
    pending = list(enumerate(lens))
    for _ in range(400):
        for _ in range(2):
            if pending:
                i, n = pending.pop(0)
                assert ts.admit(Request(uid=i, prompt=np.zeros(int(n), np.int32))) == \
                    js.admit(JRequest(uid=i, prompt=np.zeros(int(n), np.int32)))
        assert ts.load() == js.load()
        (tf, tw), (jf, jw) = ts.tick(), js.tick()
        assert tw == jw and [r.uid for r in tf] == [r.uid for r in jf]
        if not pending and not ts.pending():
            break
    assert js.pending() == ts.pending() == 0


# -- the host engine against the reference's ------------------------------------------


def test_aligned_engine_matches_reference(models):
    work = [(i, np.random.default_rng(i).integers(0, 512, n).astype(np.int32), m)
            for i, (n, m) in enumerate([(30, 6), (17, 4), (8, 7), (25, 3), (40, 5),
                                        (5, 6), (12, 4)])]
    _, te = _lockstep(models, work, ALIGNED_TOL, n_prefill_rows=2, decode_slots=3,
                      max_len=64, prefill_chunk=8)
    assert len(te.finished) == 7 and te.stats["handoffs"] == 7


KINDS = {"paged": dict(kind="paged", block_size=8, prefix_cache=True), "dense": dict(kind="dense")}
CONT = dict(mode="continuous", n_prefill_rows=2, decode_slots=3, max_len=64, prefill_chunk=8)


@pytest.fixture(scope="module")
def continuous(models):
    """The continuous engines of both packages in lockstep, per store."""
    return {kind: _lockstep(models, _workload(512), CONT_TOL, **CONT, kv=kv)
            for kind, kv in KINDS.items()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_continuous_engine_matches_reference(continuous, kind):
    """Continuous batching: the page gate charged for in-flight work, the
    packed prefill, same-tick refill, the whole-prompt prefix hit that
    skips prefill (paged) and the ``kv`` record of every tick (checked
    tick by tick in `_lockstep`)."""
    _, te = continuous[kind]
    assert len(te.finished) == 10
    if kind == "paged":
        assert te.stats["prefill_skips"] == 1 and te.stats["prefix_hit_tokens"] > 0


def _run_with(models, fault, kind, packages):
    """``packages``' continuous engines over `_workload`; ``fault(eng)``
    runs after tick 4 (stage out, resize) on each."""
    out = {}
    for pkg, (m, p) in zip(("jax", "torch"), models):
        if pkg not in packages:
            continue
        jx = pkg == "jax"
        spec = (JKVSpec if jx else KVSpec)(**KINDS[kind])
        eng = (JDisaggEngine if jx else DisaggEngine)(
            m, p, (JDisaggConfig if jx else DisaggConfig)(**CONT, kv=spec))
        for uid, prompt, mx in _workload(512):
            eng.submit((JRequest if jx else Request)(uid=uid, prompt=prompt.copy(),
                                                     max_new_tokens=mx))
        for _ in range(4):
            eng.step()
        fault(eng)
        eng.drain()
        out[pkg] = eng
    return out


def _tokens(engine):
    return {u: s[0] for u, s in _streams(engine).items()}


# the reference's engine beside the port's on the paged store; the dense
# store's runs are held to the port's own unfaulted run
PKGS = {"paged": ("jax", "torch"), "dense": ("torch",)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_stage_out_and_admit_again_is_exact(models, continuous, kind):
    """Every occupied slot staged out (a preemption notice) and queued as a
    restore: the slot's KV comes back bit for bit, and the streams are the
    unfaulted run's (and the reference's under the same staging)."""
    seen = {}

    def stage_all(e):
        live = [i for i, s in enumerate(e.slots) if s is not None]
        assert live, "setup: slots should be live at tick 4"
        if isinstance(e, DisaggEngine):
            for i in live:
                seen[e.slots[i].uid] = (e.kv.slot_cache(i), int(e.kv.lens[i]))
        for i in live:
            e.restores.append(e.stage_out(i))
        if isinstance(e, DisaggEngine):
            e.step()  # the restores land first
            assert e.stats["restores"] == len(live)
            for i, s in enumerate(e.slots):
                if s is not None and s.uid in seen:
                    want, n = seen[s.uid]
                    got = e.kv.slot_cache(i)
                    for key in ("k", "v"):  # the cursor advanced one row since
                        assert torch.equal(got[key][:, :, :n], want[key][:, :, :n])

    runs = _run_with(models, stage_all, kind, PKGS[kind])
    te = runs["torch"]
    assert seen and _tokens(te) == _tokens(continuous[kind][1])
    if "jax" in runs:
        assert _tokens(runs["jax"]) == _tokens(te)
        assert te.stats == runs["jax"].stats


@pytest.mark.parametrize("kind", list(KINDS))
def test_resize_migrates_inflight_slots_exactly(models, continuous, kind):
    """A resize with slots in flight (3 -> 5 slots, 2 -> 1 prefill rows):
    each slot's KV and token survive bit for bit, a shrink below the
    occupied slots raises, and the streams are the unfaulted run's (and the
    reference's after the same resize)."""
    moved = {}

    def grow(e):
        if isinstance(e, DisaggEngine):
            before = {s.uid: (e.kv.slot_cache(i), int(e.tokens[i, 0]))
                      for i, s in enumerate(e.slots) if s is not None}
        e.resize(n_prefill_rows=1, decode_slots=5)
        if isinstance(e, DisaggEngine):
            for i, s in enumerate(e.slots):
                if s is not None:
                    kv, tok = before[s.uid]
                    got = e.kv.slot_cache(i)
                    assert torch.equal(got["k"], kv["k"]) and torch.equal(got["v"], kv["v"])
                    assert int(e.tokens[i, 0]) == tok
                    moved[s.uid] = i
        with pytest.raises(ValueError, match="cannot shrink"):
            e.resize(n_prefill_rows=1, decode_slots=0)

    runs = _run_with(models, grow, kind, PKGS[kind])
    te = runs["torch"]
    assert moved and _tokens(te) == _tokens(continuous[kind][1])
    if "jax" in runs:
        assert _tokens(runs["jax"]) == _tokens(te)
    assert len(te.slots) == 5 and te.prefill_sched.n_rows == 1


def test_drain_stall_raises(models):
    _, (tm, tp) = models
    eng = DisaggEngine(tm, tp, DisaggConfig(n_prefill_rows=1, decode_slots=1, max_len=64))
    eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="stalled"):
        eng.drain(max_steps=1)


def test_aligned_disagg_equals_colocated_bit_for_bit(models):
    """The reference's own contract, inside the port: under an aligned
    schedule the disaggregated engine's decode logits equal the colocated
    engine's every tick, and so do the streams and the slot caches."""
    _, (tm, tp) = models
    eng = Engine(tm, tp, EngineConfig(max_batch=4, max_len=64))
    dis = DisaggEngine(tm, tp, DisaggConfig(n_prefill_rows=4, decode_slots=4, max_len=64))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (3, 5, 2, 4)]
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
        dis.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=5))
    for _ in range(5):
        eng.step()
        dis.step()
        assert torch.equal(eng.last_logits, dis.last_logits)
    assert [r.out_tokens for r in eng.finished] == [r.out_tokens for r in dis.finished]
    assert torch.equal(eng.cache["k"], dis.cache["k"])
    assert dis.workload_sample()["active_slots"] == 0 and dis.idle()


def test_skewed_prompts_keep_decode_rows_busy(models):
    """The reference's disaggregation claim on the port: the decode pool
    stays busy under skewed prompt lengths."""
    _, (tm, tp) = models
    lens = np.minimum(2 + skewed_partition(220, 16, skew=0.9, rng=np.random.default_rng(0)),
                      40)
    dis = DisaggEngine(tm, tp, DisaggConfig(n_prefill_rows=4, decode_slots=4, max_len=64,
                                            prefill_chunk=8))
    rng = np.random.default_rng(0)
    for i, n in enumerate(lens):
        dis.submit(Request(uid=i, prompt=rng.integers(0, 512, int(n)).astype(np.int32),
                           max_new_tokens=6))
    occupancy = []
    while not dis.idle():
        dis.step()
        occupancy.append(dis.last_tick["decode_batch"])
        assert len(occupancy) < 500
    assert dis.stats["tokens_out"] == 16 * 6
    assert np.mean([o for o in occupancy if o > 0]) >= 2.0 and max(occupancy) == 4


# -- the SPMD step in a 4-rank world against shard_map on 4 fake devices ---------------

JAX_SPMD = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke
from repro.core.groups import GroupedMesh
from repro.models import build
from repro.serve.disagg import (PREFILL, build_disagg_spmd_step, init_disagg_state,
                                serving_mesh)
from repro.serve.fleet import reshard_serving_state
from repro.utils.compat import make_mesh
inp = dict(np.load({inputs!r}))
kw = json.loads({disagg!r})
cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=jnp.float32)
model = build(cfg)
params = model.init(jax.random.PRNGKey(0))
mesh = make_mesh(({rows},), ("data",))
out = {{}}
kept = None
for alpha in {alphas!r}:
    tag = f"a{{alpha}}"
    gmesh = serving_mesh(mesh, alpha)
    step, plan = build_disagg_spmd_step(model, gmesh, **kw)
    cache, tokens = init_disagg_state(model, gmesh, slots_per_row=kw["slots_per_row"],
                                      max_len=kw["max_len"])
    for t in range({ticks}):
        cache, tokens, outs, stats = step(params, jnp.asarray(inp[tag + "/prompts"][t]),
                                          jnp.asarray(inp[tag + "/plen"][t]),
                                          jnp.asarray(inp[tag + "/dst"][t]), cache, tokens)
        out[f"{{tag}}/outs{{t}}"] = np.asarray(outs)
        out[f"{{tag}}/stats{{t}}"] = np.asarray(stats)
    out[tag + "/n_chunks"] = np.int64(plan.n_chunks)
    for k in ("k", "v"):
        out[tag + "/" + k] = np.asarray(cache[k]).astype(np.float32)
    out[tag + "/pos"] = np.asarray(cache["pos"])
    out[tag + "/tokens"] = np.asarray(tokens)
    if kept is None:
        kept = (gmesh, cache, tokens)
old, cache, tokens = kept
new = GroupedMesh.build_rows(mesh, rows={{PREFILL: 1}})
for name, extra in (("all", {{}}), ("dead1", {{"dead_rows": [1]}})):
    nc, nt = reshard_serving_state(cache, tokens, old, new,
                                   slots_per_row=kw["slots_per_row"], **extra)
    for k in ("k", "v"):
        out[f"reshard_{{name}}/{{k}}"] = np.asarray(nc[k]).astype(np.float32)
    out[f"reshard_{{name}}/pos"] = np.asarray(nc["pos"])
    out[f"reshard_{{name}}/tokens"] = np.asarray(nt)
{reshards}
np.savez({out_npz!r}, **out)
print("OK")
"""

# The reference's serving reshards between meshes of any sizes, on the
# arrays `_reshard_inputs` made (inserted into JAX_SPMD verbatim).
JAX_RESHARDS = """
from repro.serve.fleet import reshard_paged_serving_state


def refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def on_rows(n, prefill):
    return GroupedMesh.build_rows(make_mesh((n,), ("data",)), rows={PREFILL: prefill})


def keep_reshard(tag, cache, tokens, old, new, **kw):
    nc, nt = reshard_serving_state(cache, tokens, old, new, **kw)
    for k in ("k", "v", "pos"):
        out[f"{tag}/{k}"] = np.asarray(nc[k])
    out[tag + "/tokens"] = np.asarray(nt)


# tests/test_faults.py:475: 4 -> 3 rows, decode row 2 dead
old, new = on_rows(4, 1), on_rows(3, 1)
cache = {k: inp["rs_dead/" + k] for k in ("k", "v", "pos")}
tokens = inp["rs_dead/tokens"]
keep_reshard("rs_dead", cache, tokens, old, new, slots_per_row=2, dead_rows=[2])
for i, kw in enumerate(RESHARD_REFUSALS):
    out[f"rs_dead/refusal{i}"] = np.array(refusal(
        lambda: reshard_serving_state(cache, tokens, old, new, slots_per_row=2, **kw)))
# tests/test_dataflow.py:431: 8 rows, 2 -> 4 prefill rows, slots 0, 2, 5 kept
old, new = on_rows(8, 2), on_rows(8, 4)
layout, _ = init_disagg_state(model, old, slots_per_row=1, max_len=16)
assert layout["k"].shape == inp["rs_split/k"].shape
keep_reshard("rs_split", {k: jnp.asarray(inp["rs_split/" + k]) for k in ("k", "v", "pos")},
             jnp.asarray(inp["rs_split/tokens"]), old, new, slots_per_row=1, keep=[0, 2, 5])
# the paged reshard: 4 -> 3 rows, decode row 1 dead
old, new = on_rows(4, 1), on_rows(3, 1)
res = reshard_paged_serving_state(
    jnp.asarray(inp["rs_paged/k"]), jnp.asarray(inp["rs_paged/v"]), inp["rs_paged/tables"],
    inp["rs_paged/lens"], jnp.asarray(inp["rs_paged/tokens"]), old, new, slots_per_row=2,
    dead_rows=[1])
for name, x in zip(("k", "v", "tables", "lens", "tokens"), res):
    out["rs_paged/" + name] = np.asarray(x)
"""
# a dead slot named in ``keep``, more slots than fit, a row outside the decode group
RESHARD_REFUSALS = [dict(keep=[0, 4], dead_rows=[2]), dict(keep=[0, 1, 2, 3, 4]),
                    dict(dead_rows=[3])]


def _spmd_inputs(rng) -> dict:
    """Per alpha and tick: right-padded prompts, true lengths (a prefill
    row idles now and then: length 0) and each decode row's slot per wave
    (-1: none)."""
    spr, mp = DISAGG["slots_per_row"], DISAGG["max_prompt"]
    out = {}
    for alpha in DISAGG_ALPHAS:
        n_pre = max(1, round(alpha * DISAGG_ROWS))
        n_waves = -(-n_pre // (DISAGG_ROWS - n_pre))
        tag = f"a{alpha}"
        out[tag + "/prompts"] = rng.integers(0, 512, (DISAGG_TICKS, DISAGG_ROWS, mp)).astype(
            np.int32)
        plen = rng.integers(4, mp + 1, (DISAGG_TICKS, DISAGG_ROWS)).astype(np.int32)
        plen[:, : DISAGG_ROWS - n_pre] = 0  # decode rows take no prompt
        plen[1, DISAGG_ROWS - 1] = 0  # an idle prefill row
        out[tag + "/plen"] = plen
        out[tag + "/dst"] = rng.integers(-1, spr, (DISAGG_TICKS, DISAGG_ROWS, n_waves)).astype(
            np.int32)
    return out


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """(JAX's arrays, the port's per-rank results, the inputs)."""
    tmp = tmp_path_factory.mktemp("disagg_spmd")
    inputs = _spmd_inputs(np.random.default_rng(5))
    inputs.update(_reshard_inputs())
    jc = dataclasses.replace(j_get_smoke(NAME), dtype=jnp.float32)
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        inputs["p0/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    out_npz = str(tmp / "jax.npz")
    code = JAX_SPMD.format(inputs=path, disagg=json.dumps(DISAGG), rows=DISAGG_ROWS,
                           alphas=DISAGG_ALPHAS, ticks=DISAGG_TICKS, out_npz=out_npz,
                           reshards=JAX_RESHARDS.replace("RESHARD_REFUSALS",
                                                         repr(RESHARD_REFUSALS)))
    # 8 fake devices: the world's 4 rows and the 8-row reshard case
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = spawn(disagg_cases, DISAGG_ROWS, device="cpu", args=(path,), timeout_s=240)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"JAX subprocess failed:\n{stdout}\n{stderr[-4000:]}")
    return dict(np.load(out_npz)), port, inputs


def _stitch(port, key, axis):
    return np.concatenate([r[key] for r in port], axis=axis)


def _close_bf16(got, want):
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("alpha", DISAGG_ALPHAS)
def test_spmd_step_matches_shard_map(spmd, alpha):
    jx, port, inputs = spmd
    tag = f"a{alpha}"
    for t in range(DISAGG_TICKS):
        np.testing.assert_array_equal(_stitch(port, f"{tag}/outs{t}", 0), jx[f"{tag}/outs{t}"])
        np.testing.assert_array_equal(_stitch(port, f"{tag}/stats{t}", 0),
                                      jx[f"{tag}/stats{t}"])
    np.testing.assert_array_equal(_stitch(port, f"{tag}/tokens", 0), jx[f"{tag}/tokens"])
    np.testing.assert_array_equal(_stitch(port, f"{tag}/pos", 0), jx[f"{tag}/pos"])
    for k in ("k", "v"):
        _close_bf16(_stitch(port, f"{tag}/{k}", 1), jx[f"{tag}/{k}"])
    assert all(int(r[f"{tag}/n_chunks"]) == int(jx[f"{tag}/n_chunks"]) > 1 for r in port)
    # handoffs happened, and slot-steps = decode rows x slots x decode steps
    n_dec = DISAGG_ROWS - max(1, round(alpha * DISAGG_ROWS))
    stats = np.stack([port[0][f"{tag}/stats{t}"][0] for t in range(DISAGG_TICKS)])
    assert stats[:, 0].sum() > 0
    assert (stats[:, 1] == n_dec * DISAGG["slots_per_row"] * DISAGG["decode_steps"]).all()


def test_spmd_wire_carries_every_chunk(spmd):
    """Each producer sends every stream chunk of its packed cache every
    tick (no count: the reference's bytes), plus its (first, length)."""
    _, port, _ = spmd
    for alpha in DISAGG_ALPHAS:
        tag = f"a{alpha}"
        n_dec = DISAGG_ROWS - max(1, round(alpha * DISAGG_ROWS))
        n_chunks = int(port[0][f"{tag}/n_chunks"])
        for row, r in enumerate(port):
            if row < n_dec:
                continue  # consumers receive only
            chunk_bytes = 512 * 4
            assert int(r[f"{tag}/sent_bytes"]) >= DISAGG_TICKS * (n_chunks * chunk_bytes + 8)


@pytest.mark.parametrize("case", ["all", "dead1"])
def test_serving_reshard_in_the_world_matches_reference(spmd, case):
    """`reshard_serving_state` 2 + 2 -> 1 + 3 rows inside the world (each
    rank's row through `reshard_state`) equals the reference's global
    reshard: kept slots' KV and tokens, zeros past them, ``pos``."""
    jx, port, _ = spmd
    key = f"reshard_{case}"
    np.testing.assert_array_equal(_stitch(port, key + "/tokens", 0), jx[key + "/tokens"])
    np.testing.assert_array_equal(_stitch(port, key + "/pos", 0), jx[key + "/pos"])
    for k in ("k", "v"):
        _close_bf16(_stitch(port, f"{key}/{k}", 1), jx[f"{key}/{k}"])
        # and bit for bit the port's own rows before the move
        old = _stitch(port, f"a0.5/{k}", 1)
        new = _stitch(port, f"{key}/{k}", 1)
        kept = [0, 1, 2, 3] if case == "all" else [0, 1]
        np.testing.assert_array_equal(new[:, : len(kept)], old[:, kept])
        assert not new[:, len(kept):].any()


def test_serving_reshard_refuses_another_world_size(spmd):
    _, port, _ = spmd
    for r in port:
        assert "one gloo world has one size" in str(r["reshard_other_size"])


# -- the serving reshards across sizes and the block-pool repack ---------------------------


def _planning(n, prefill):
    return GroupedMesh.build_rows(Mesh(n_rows=n, device="cpu"), rows={PREFILL: prefill})


def _paged_state(seed=0):
    """A pool of 12 blocks (block 0 the zero block), 6 slots whose tables
    share blocks 1 and 2 (a prefix), lengths and tokens."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(2, 12, 4, 8)).astype(np.float32)
    v = rng.normal(size=(2, 12, 4, 8)).astype(np.float32)
    k[:, 0] = v[:, 0] = 0
    tables = np.full((6, 3), -1, np.int32)
    tables[0] = [1, 2, 3]
    tables[1] = [1, 2, 4]
    tables[2] = [5, -1, -1]
    tables[3] = [6, 7, -1]
    tables[4] = [1, 8, -1]
    tables[5] = [9, 10, 11]
    lens = np.array([10, 9, 2, 6, 5, 12], np.int64)
    return k, v, tables, lens


def _reshard_inputs() -> dict:
    """The arrays both packages' serving reshards take (JAX_RESHARDS)."""
    spr, L, T_, D = 2, 2, 8, 4
    k = np.zeros((L, 4 * spr, T_, D), np.float32)
    for s in range(3 * spr):
        k[:, s] = s + 1  # a distinct payload on each decode slot
    out = {"rs_dead/k": k, "rs_dead/v": k * 10,
           "rs_dead/pos": np.array([3, 3, 3, 0], np.int32),
           "rs_dead/tokens": np.arange(4 * spr, dtype=np.int32).reshape(-1, 1)}
    tc = dataclasses.replace(get_smoke(NAME), dtype=torch.float32)
    layout, _ = init_disagg_state(build(tc, device="cpu"), _planning(8, 2), slots_per_row=1,
                                  max_len=16)
    rng = np.random.default_rng(0)
    for name in ("k", "v"):
        # values a bf16 cache holds exactly
        x = torch.from_numpy(rng.normal(size=tuple(layout[name].shape)).astype(np.float32))
        out["rs_split/" + name] = x.to(layout[name].dtype).float().numpy()
    out["rs_split/pos"] = np.array([5, 5, 5, 5, 5, 5, 0, 0], np.int32)
    out["rs_split/tokens"] = np.arange(8, dtype=np.int32)[:, None]
    pk, pv, tables, lens = _paged_state()
    out["rs_paged/k"], out["rs_paged/v"] = pk, pv
    out["rs_paged/tables"] = np.full((8, 3), -1, np.int32)
    out["rs_paged/tables"][:6] = tables
    out["rs_paged/lens"] = np.zeros(8, np.int64)
    out["rs_paged/lens"][:6] = lens
    out["rs_paged/tokens"] = np.arange(8, dtype=np.int32)[:, None] + 100
    return out


def _equal_to_reference(jx, tag, **got):
    for name, x in got.items():
        x = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        np.testing.assert_array_equal(x, jx[f"{tag}/{name}"], err_msg=f"{tag}/{name}")


def test_reshard_serving_state_across_sizes_drops_dead_rows(spmd):
    """tests/test_faults.py's cross-size case (4 -> 3 rows, decode row 2
    dead) beside the reference's on 4 and 3 fake devices: the same K/V,
    tokens and ``pos`` bit for bit; surviving slots' KV moves verbatim
    onto the smaller layout, the dead row's slots leave the default keep,
    and naming a dead slot, more slots than fit or a row outside the
    decode group raises the reference's ValueError."""
    jx, _, inputs = spmd
    spr = 2
    old, new = _planning(4, 1), _planning(3, 1)
    assert (old.compute.size, new.compute.size) == (3, 2)
    cache = {k: torch.from_numpy(inputs["rs_dead/" + k]) for k in ("k", "v", "pos")}
    tokens = torch.from_numpy(inputs["rs_dead/tokens"])
    nc, nt = reshard_serving_state(cache, tokens, old, new, slots_per_row=spr, dead_rows=[2])
    _equal_to_reference(jx, "rs_dead", tokens=nt, **nc)
    L, T_, D = cache["k"].shape[0], cache["k"].shape[2], cache["k"].shape[3]
    assert nc["k"].shape[1] == 3 * spr and nc["k"].dtype == cache["k"].dtype
    for s in range(4):
        assert torch.equal(nc["k"][:, s], torch.full((L, T_, D), s + 1.0))
        assert torch.equal(nc["v"][:, s], torch.full((L, T_, D), 10.0 * (s + 1)))
    assert not nc["k"][:, 4:].any()
    assert nt[:4, 0].tolist() == [0, 1, 2, 3] and not nt[4:].any()
    assert nc["pos"].tolist() == [3, 3, 0]
    for i, (kw, match) in enumerate(zip(RESHARD_REFUSALS, ("dead row", "exceed", "outside"))):
        with pytest.raises(ValueError, match=match) as e:
            reshard_serving_state(cache, tokens, old, new, slots_per_row=spr, **kw)
        assert str(e.value) == str(jx[f"rs_dead/refusal{i}"])


def test_reshard_serving_state_between_splits_of_one_mesh(spmd):
    """tests/test_dataflow.py's case on `init_disagg_state`'s layout (8
    rows, 2 -> 4 prefill rows, slots 0, 2, 5 kept) beside the reference's
    on 8 fake devices: the same K/V, tokens and ``pos`` bit for bit; kept
    slots' K/V and tokens exactly, zeros past them, the shared cursor on
    every new decode row."""
    jx, _, inputs = spmd
    tc = dataclasses.replace(get_smoke(NAME), dtype=torch.float32)
    model = build(tc, device="cpu")
    old, new = _planning(8, 2), _planning(8, 4)
    cache, tokens = init_disagg_state(model, old, slots_per_row=1, max_len=16)
    for name in ("k", "v"):
        cache[name] = torch.from_numpy(inputs["rs_split/" + name]).to(cache[name].dtype)
    assert cache["k"].dtype == torch.bfloat16
    cache["pos"] = torch.from_numpy(inputs["rs_split/pos"])
    tokens = torch.from_numpy(inputs["rs_split/tokens"])
    keep = [0, 2, 5]
    nc, nt = reshard_serving_state(cache, tokens, old, new, slots_per_row=1, keep=keep)
    _equal_to_reference(jx, "rs_split", tokens=nt, **nc)
    assert nc["k"].shape == cache["k"].shape and nc["k"].dtype == torch.bfloat16
    for j, src in enumerate(keep):
        assert torch.equal(nc["k"][:, j], cache["k"][:, src])
        assert torch.equal(nc["v"][:, j], cache["v"][:, src])
        assert int(nt[j, 0]) == src
    assert not nc["k"][:, len(keep):].any() and not nt[len(keep):].any()
    assert nc["pos"][:4].tolist() == [5, 5, 5, 5] and not nc["pos"][4:].any()


@pytest.mark.parametrize("keep,n_blocks", [([0, 1, 3], None), ([5, 4, 2, 0], 14), ([], None)])
def test_repack_block_pool_matches_reference(keep, n_blocks):
    k, v, tables, lens = _paged_state()
    tk, tv, tt, tl = repack_block_pool(torch.from_numpy(k), torch.from_numpy(v), tables, lens,
                                       keep=keep, n_blocks=n_blocks)
    jk, jv, jt, jl = j_repack(jnp.asarray(k), jnp.asarray(v), tables, lens, keep=keep,
                              n_blocks=n_blocks)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    with pytest.raises(ValueError, match="live blocks"):
        repack_block_pool(torch.from_numpy(k), torch.from_numpy(v), tables, lens,
                          keep=[0, 5], n_blocks=3)


def test_paged_reshard_keeps_each_slot_and_its_sharing(spmd):
    """`reshard_paged_serving_state` 4 -> 3 rows with decode row 1 dead,
    beside the reference's on 4 and 3 fake devices: the same pool,
    tables, lengths and tokens bit for bit; every kept slot reads the same
    K/V through its new table, shared blocks stay shared (one copy), and
    the tokens follow their slots."""
    jx, _, inputs = spmd
    kt, vt = torch.from_numpy(inputs["rs_paged/k"]), torch.from_numpy(inputs["rs_paged/v"])
    tables8, lens8 = inputs["rs_paged/tables"], inputs["rs_paged/lens"]
    tokens = torch.from_numpy(inputs["rs_paged/tokens"])
    old, new = _planning(4, 1), _planning(3, 1)
    nk, nv, ntab, nlen, ntok = reshard_paged_serving_state(
        kt, vt, tables8, lens8, tokens, old, new, slots_per_row=2, dead_rows=[1])
    _equal_to_reference(jx, "rs_paged", k=nk, v=nv, tables=ntab, lens=nlen, tokens=ntok)
    kept = [0, 1, 4, 5]
    assert ntab.shape == (6, 3) and nlen.tolist() == [10, 9, 5, 12, 0, 0]
    assert ntok[:, 0].tolist() == [100, 101, 104, 105, 0, 0]
    for j, src in enumerate(kept):
        want = tops.paged_gather(kt, torch.as_tensor(tables8[src:src + 1]))
        got = tops.paged_gather(nk, torch.as_tensor(ntab[j:j + 1]))
        assert torch.equal(got, want)
    assert ntab[0, 0] == ntab[1, 0] == ntab[2, 0]  # the shared prefix block, once
    assert nk.shape[1] == 1 + len({int(b) for s in kept for b in tables8[s] if b > 0})
