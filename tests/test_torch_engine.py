"""PyTorch port, the continuous-batching engine: one `Request` list through
`repro.serve.make_engine` and `repro_torch.serve.make_engine` on the same
f32 tinyllama smoke weights, ticked in lockstep.

What must be identical: every tick's admissions (slots, prefill lengths,
prefix hits), decode batch and KV-store stats (blocks in use, peak
blocks, refcount totals); every request's token stream,
``first_token_tick`` and ``done_tick``; the ledger. Greedy decoding
makes the token streams exact as long as no logit margin falls inside
the f32 noise; the logits themselves are held to 1e-4 (the same budget
and reason as tests/test_torch_transformer.py). Inside the port, the
dense store and the paged store give bit-identical runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build as j_build
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import KVSpec as JKVSpec
from repro.serve import Request as JRequest
from repro.serve import make_engine as j_make_engine
from repro.serve.engine import page_admission_budget as j_budget
from repro_torch.configs import get_smoke
from repro_torch.kernels.paged_attention import paged_decode_attention_kernel
from repro_torch.kernels.sample import argmax_last_kernel
from repro_torch.models.model_zoo import build
from repro_torch.serve import EngineConfig, KVSpec, Request, ServeConfig, make_engine
from repro_torch.serve.engine import page_admission_budget, prefill_bucket
from repro_torch.utils.convert import params_from_numpy

NAME = "tinyllama-1.1b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


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
    """(uid, prompt, max_new) triples: prompts of 3..40 tokens, half behind
    a shared 16-token prefix, one exact repeat (a whole-prompt hit)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 16)
    out = []
    for i in range(9):
        n = int(rng.integers(3, 25))
        prompt = rng.integers(0, vocab, n)
        if i % 2:
            prompt = np.concatenate([prefix, prompt])
        out.append((i, prompt.astype(np.int32), int(rng.integers(2, 9))))
    out.append((9, out[1][1].copy(), 4))
    return out


def _lockstep(models, kv: dict, *, max_batch=3, max_len=64):
    (jm, jp), (tm, tp) = models
    je = j_make_engine(jm, jp, JEngineConfig(mode="continuous", max_batch=max_batch,
                                             max_len=max_len, kv=JKVSpec(**kv)))
    te = make_engine(tm, tp, EngineConfig(mode="continuous", max_batch=max_batch,
                                          max_len=max_len, kv=KVSpec(**kv)))
    for uid, prompt, m in _workload(tm.cfg.vocab_size):
        je.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))
        te.submit(Request(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    while not (je.idle() and te.idle()):
        je.step()
        te.step()
        assert [s.uid if s else None for s in te.slots] == \
               [s.uid if s else None for s in je.slots], te.tick
        jt, tt = je.last_tick, te.last_tick
        for key in ("prefill_lens", "prefill_calls", "decode_batch", "prefix_hit_tokens"):
            assert tt[key] == jt[key], (te.tick, key)
        assert tt["kv"] == jt["kv"], te.tick
        if tt["decode_batch"]:
            np.testing.assert_allclose(te.last_logits.numpy(), np.asarray(je.last_logits),
                                       **LOGIT_TOL)
        assert te.tick < 200
    return je, te


def _by_uid(engine):
    return {r.uid: (tuple(r.out_tokens), r.first_token_tick, r.done_tick)
            for r in engine.finished}


@pytest.mark.parametrize("kv", [
    dict(kind="paged", block_size=8, prefix_cache=True),
    dict(kind="paged", block_size=8, prefix_cache=True, n_blocks=12),
    dict(kind="dense"),
], ids=["paged-prefix", "paged-tight-pool", "dense"])
def test_engine_matches_reference(models, kv):
    """The tight pool (11 usable blocks for 3 slots of up to 8) makes the
    page gate hold requests back while slots are free, and allocation
    evict prefix entries."""
    je, te = _lockstep(models, kv)
    assert _by_uid(te) == _by_uid(je)
    assert len(te.finished) == 10
    assert te.stats == je.stats
    assert [dataclasses.astuple(c) for c in te.ledger.completions] == \
           [dataclasses.astuple(c) for c in je.ledger.completions]
    if kv["kind"] == "paged":
        assert te.stats["prefix_hit_tokens"] > 0
        assert te.stats["prefill_skips"] == (0 if "n_blocks" in kv else 1)  # tight: evicted
        assert te.kv.stats["peak_blocks"] == je.kv.stats["peak_blocks"]


def test_engine_past_blockwise_threshold_matches_reference(models, monkeypatch):
    """Long prompts: with both packages' `BLOCKWISE_THRESHOLD` lowered to
    16 (blocks of 8), the 32- and 64-token prefill buckets take
    `attention_blockwise` on both sides, and the engines stay in
    lockstep: the same admissions, logits within 1e-4, the same token
    streams."""
    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt

    monkeypatch.setattr(jt, "BLOCKWISE_THRESHOLD", 16)
    monkeypatch.setattr(tt, "BLOCKWISE_THRESHOLD", 16)
    monkeypatch.setattr(tt, "KV_BLOCK", 8)
    monkeypatch.setenv("REPRO_KV_BLOCK", "8")
    calls = []
    blockwise = tt.layers.attention_blockwise

    def counted(q, *a, **kw):
        calls.append(q.shape[1])
        return blockwise(q, *a, **kw)

    monkeypatch.setattr(tt.layers, "attention_blockwise", counted)
    je, te = _lockstep(models, dict(kind="paged", block_size=8, prefix_cache=True))
    assert _by_uid(te) == _by_uid(je)
    assert len(te.finished) == 10
    assert calls and all(n > 16 for n in calls)


def test_int8_engine_matches_reference(models):
    """int8 pools: the reference quantizes under `jax.jit`, whose scales
    can sit one f32 ulp off the port's (tests/test_torch_kvstore.py), so
    the logits get 1e-3; the token streams and the admissions stay exact."""
    (jm, jp), (tm, tp) = models
    kv = dict(kind="paged", block_size=8, kv_dtype="int8")
    je = j_make_engine(jm, jp, JEngineConfig(mode="continuous", max_batch=3, max_len=64,
                                             kv=JKVSpec(**kv)))
    te = make_engine(tm, tp, EngineConfig(mode="continuous", max_batch=3, max_len=64,
                                          kv=KVSpec(**kv)))
    for uid, prompt, m in _workload(tm.cfg.vocab_size, seed=1)[:6]:
        je.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))
        te.submit(Request(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    while not (je.idle() and te.idle()):
        je.step()
        te.step()
        assert te.last_tick["kv"] == je.last_tick["kv"]
        if te.last_tick["decode_batch"]:
            np.testing.assert_allclose(te.last_logits.numpy(), np.asarray(je.last_logits),
                                       atol=1e-3, rtol=1e-3)
    assert _by_uid(te) == _by_uid(je)


def test_port_dense_equals_paged_bitwise(models):
    """Inside the port the dense store (an identity-table pool of one
    max_len block per slot) and the paged store give the same logits,
    bit for bit, for every live slot on every tick, and the same streams.
    (An empty slot decodes a stale token against whatever its store holds
    there, stale rows or the zero block, and its logits are never read.)"""
    _, (tm, tp) = models
    engines, steps = [], []
    for kv in (dict(kind="dense"), dict(kind="paged", block_size=16)):
        seen = []

        def decode(params, pview, token, *, impl=None, seen=seen):
            out = tm.decode_step_paged(params, pview, token, impl=impl)
            seen.append((pview["pos"] < 64, out[0]))
            return out

        e = make_engine(dataclasses.replace(tm, decode_step_paged=decode), tp,
                        EngineConfig(mode="continuous", max_batch=3, max_len=64,
                                     kv=KVSpec(**kv)))
        for uid, prompt, m in _workload(tm.cfg.vocab_size, seed=2):
            e.submit(Request(uid=uid, prompt=prompt, max_new_tokens=m))
        engines.append(e)
        steps.append(seen)
    dense, paged = engines
    while not (dense.idle() and paged.idle()):
        dense.step()
        paged.step()
        (live, ld), (live_p, lp) = steps[0][-1], steps[1][-1]
        assert torch.equal(live, live_p) and torch.equal(ld[live], lp[live]), dense.tick
        act = [i for i, s in enumerate(dense.slots) if s is not None]
        vd, vp = dense.kv.view(act), paged.kv.view(act)
        for i in act:
            n = int(dense.kv.lens[i])
            assert torch.equal(vd["k"][:, i, :n], vp["k"][:, i, :n])
    assert _by_uid(dense) == _by_uid(paged)


def test_engine_on_cpu_never_launches_a_kernel(models):
    _, (tm, tp) = models
    before = (paged_decode_attention_kernel.launches, argmax_last_kernel.launches)
    e = make_engine(tm, tp, EngineConfig(mode="continuous", max_batch=2, max_len=32,
                                         kv=KVSpec(kind="paged", block_size=8)))
    e.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=3))
    assert e.drain() == 3
    assert (paged_decode_attention_kernel.launches, argmax_last_kernel.launches) == before


def test_page_admission_budget_matches_reference(models):
    (jm, jp), (tm, tp) = models
    kv = dict(kind="paged", block_size=8, prefix_cache=True, n_blocks=20)
    je = j_make_engine(jm, jp, JEngineConfig(mode="continuous", max_batch=3, max_len=64,
                                             kv=JKVSpec(**kv)))
    te = make_engine(tm, tp, EngineConfig(mode="continuous", max_batch=3, max_len=64,
                                          kv=KVSpec(**kv)))
    work = _workload(tm.cfg.vocab_size, seed=3)
    for uid, prompt, m in work[:4]:
        je.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))
        te.submit(Request(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    for _ in range(2):
        je.step()
        te.step()
    jf, jcost = j_budget(je.kv, je.slots, 64)
    tf, tcost = page_admission_budget(te.kv, te.slots, 64)
    assert tf == jf
    for uid, prompt, m in work:
        assert tcost(Request(uid=uid, prompt=prompt, max_new_tokens=m)) == \
               jcost(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))


def test_make_engine_dispatch(models):
    """A bare `ServeConfig` builds the colocated engine in the reference's
    default mode, aligned, over the dense store; a `DisaggConfig` builds
    `DisaggEngine`, a `FleetConfig` builds `FleetEngine` (with ``mesh`` and
    ``clock``), and a config of no engine raises `TypeError`, as the
    reference's `make_engine` does."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve import DisaggConfig, DisaggEngine, FleetConfig, FleetEngine

    _, (tm, tp) = models
    e = make_engine(tm, tp, ServeConfig(max_len=32))
    assert e.cfg.max_batch == 8 and e.kv.kind == "dense" and e.cfg.mode == "aligned"
    assert ServeConfig().mode == JEngineConfig().mode == "aligned" and not e.kv.ragged

    d = make_engine(tm, tp, DisaggConfig(mode="continuous", decode_slots=3))
    assert isinstance(d, DisaggEngine) and len(d.slots) == 3 and d.kv.ragged
    clock = lambda tick: 1e-3  # noqa: E731
    f = make_engine(tm, tp, FleetConfig(n_rows=4, prefill_rows=1), mesh=Mesh(4, device="cpu"),
                    clock=clock)
    assert isinstance(f, FleetEngine) and f.clock is clock and f.decode_slots == 6
    assert f.graph.gmesh.group("prefill").size == 1
    with pytest.raises(ValueError, match="SpecConfig-only"):
        make_engine(tm, tp, FleetConfig(), draft=(tm, tp))
    with pytest.raises(ValueError, match="FleetConfig/SpecConfig-only"):
        make_engine(tm, tp, DisaggConfig(), clock=clock)

    @dataclasses.dataclass
    class OtherConfig(ServeConfig):
        n_prefill_rows: int = 2

    with pytest.raises(TypeError, match="OtherConfig"):
        make_engine(tm, tp, OtherConfig(mode="continuous"))
    with pytest.raises(ValueError, match="continuous"):
        EngineConfig(mode="aligned", kv=KVSpec(kind="paged"))


@pytest.mark.parametrize("lens,max_new,slots", [
    ([3, 5, 4, 2, 6], 3, 2),  # tests/test_kvstore.py's aligned workload
    ([30, 17, 8, 25, 40, 5, 12], 6, 3),
], ids=["short", "mixed"])
def test_aligned_engine_matches_reference(models, lens, max_new, slots):
    """Aligned mode on the dense store: batch-1 bucketed prefills migrated
    into their slots, one shared cursor, `decode_step_lm` each tick. The
    two packages tick in lockstep: the same slots, prefill lengths and
    decode batches, the shared cursor, identical token streams and ticks.
    Logits get 1e-3: the slot cache is bf16 (`init_cache`'s dtype), and a
    K/V row the two packages compute 1e-7 apart in f32 can round to bf16
    values one ulp (2^-8 of the value) apart, which moves later logits by
    up to 5e-4 here (seen from the seventh tick of the short workload)."""
    (jm, jp), (tm, tp) = models
    je = j_make_engine(jm, jp, JEngineConfig(max_batch=slots, max_len=64))
    te = make_engine(tm, tp, EngineConfig(max_batch=slots, max_len=64))
    rng = np.random.default_rng(4)
    for uid, n in enumerate(lens):
        prompt = rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32)
        je.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=max_new))
        te.submit(Request(uid=uid, prompt=prompt.copy(), max_new_tokens=max_new))
    while not (je.idle() and te.idle()):
        je.step()
        te.step()
        assert [s.uid if s else None for s in te.slots] == \
               [s.uid if s else None for s in je.slots], te.tick
        for key in ("prefill_lens", "decode_batch"):
            assert te.last_tick[key] == je.last_tick[key], (te.tick, key)
        assert int(te.kv.cache["pos"]) == int(je.kv.cache["pos"]), te.tick
        if te.last_tick["decode_batch"]:
            np.testing.assert_allclose(te.last_logits.numpy(), np.asarray(je.last_logits),
                                       atol=1e-3, rtol=1e-3)
        assert te.tick < 200
    assert te.tick == je.tick
    assert _by_uid(te) == _by_uid(je) and len(te.finished) == len(lens)
    assert te.stats == je.stats


@pytest.mark.parametrize("n,max_len,want", [(1, None, 8), (8, None, 8), (9, None, 16),
                                            (300, 512, 512), (500, 512, 512)])
def test_prefill_bucket(n, max_len, want):
    assert prefill_bucket(n, max_len=max_len) == want


def test_prefill_bucket_rejects_overlong_prompt():
    with pytest.raises(ValueError, match="exceeds max_len"):
        prefill_bucket(600, max_len=512)


def test_scenario_replay_matches_reference(models):
    """`bursty-prefix` replayed through both packages' engines under the
    multi-tenant scheduler (WFQ with a token budget, aging 0.05; the
    paged store with the prefix cache, the example's engine settings).
    The horizon is cut from 56 to 24 ticks for CPU time, and the budget
    to 200 prompt tokens a tick, so that it binds (prompts reach 120).
    Identical streams, first-token and done ticks, and ledger snapshots.
    Logits get 1e-3, for the reason the aligned test gives: the pools are
    bf16 in both packages, K/V rows computed ~1e-7 apart in f32 round one
    bf16 ulp apart (2^-7 at values in [1, 2), seen here), and by the 17th
    tick of a 120-token prompt that moves its logits by up to 1.4e-4."""
    from repro.serve.sched import FleetScheduler as JFleetScheduler
    from repro.serve.traffic import replay as j_replay
    from repro.serve.traffic import scenario as j_scenario
    from repro_torch.serve.sched import FleetScheduler
    from repro_torch.serve.traffic import replay, scenario

    (jm, jp), (tm, tp) = models
    kv = dict(kind="paged", block_size=16, prefix_cache=True)
    runs = []
    for mk, cfg_cls, kv_cls, sched_cls, sc_fn, rp in (
            (j_make_engine, JEngineConfig, JKVSpec, JFleetScheduler, j_scenario, j_replay),
            (make_engine, EngineConfig, KVSpec, FleetScheduler, scenario, replay)):
        sc = dataclasses.replace(sc_fn("bursty-prefix"), horizon=24)
        model, params = (jm, jp) if mk is j_make_engine else (tm, tp)
        eng = mk(model, params, cfg_cls(max_batch=4, max_len=160, mode="continuous",
                                         kv=kv_cls(**kv)),
                 sched=sched_cls(sc.tenants, token_budget=200, aging=0.05))
        logits = []
        pairs = rp(eng, sc, model.cfg.vocab_size,
                   on_tick=lambda e: logits.append(
                       None if not e.last_tick["decode_batch"] else np.asarray(e.last_logits)))
        runs.append((eng, pairs, logits))
    (je, jpairs, jlog), (te, tpairs, tlog) = runs
    assert len(tpairs) == len(jpairs) and len(te.finished) == len(tpairs) > 20
    assert _by_uid(te) == _by_uid(je)
    assert te.ledger.snapshot() == je.ledger.snapshot()
    assert te.sched.rejected == je.sched.rejected == 0
    assert te.stats == je.stats and te.stats["prefix_hit_tokens"] > 0
    assert len(tlog) == len(jlog)
    for a, b in zip(tlog, jlog):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3)


def test_serve_lm_example_runs_and_writes_a_valid_trace(tmp_path):
    """The port's serving example as a user launches it, on the CPU with
    the reduced config: it exits 0, and its trace validates with every
    request's lifecycle closed."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.obs.export import validate_chrome_trace

    path = tmp_path / "serve.json"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_lm", "--smoke", "--device", "cpu",
         "--scenario", "single-fifo", "--paged", "--trace", str(path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 17 requests" in proc.stdout and "tok/s on CPU" in proc.stdout
    obj = json.loads(path.read_text())
    assert validate_chrome_trace(obj) == []
    life = obj["otherData"]["lifecycle"]
    assert life["begins"] == life["ends"] == 17 and life["open"] == []
    assert obj["otherData"]["metrics"]["serve.completions"] == 17
