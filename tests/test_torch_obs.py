"""PyTorch port, TraceGraph (`repro_torch.obs`): the reference's unit cases
of `tests/test_obs.py` against the port's copy (registry, histogram
merge, snapshot keys, the null span, the ring and its drops, nesting,
lifecycle after wrap, export, the validator); then both packages side by
side: the same observations give the same percentiles and snapshots, the
same emit sequence the same exported events (times stripped), and the
port's engine emits the reference engine's sequence of ``(ph, name,
track, args)`` on one workload, with the same lifecycle invariants; with
tracing off and on, the port's outputs are bit for bit the same.

Both packages keep a module-global tracer and registry: the fixture
below disables both tracers around every test, and the tests that count
reset both registries.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build as j_build
from repro.obs import export as j_export
from repro.obs import registry as j_registry
from repro.obs import trace as j_trace
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import KVSpec as JKVSpec
from repro.serve import Request as JRequest
from repro.serve import make_engine as j_make_engine
from repro_torch.configs import get_smoke
from repro_torch.models.model_zoo import build
from repro_torch.obs import export, registry, trace
from repro_torch.serve import EngineConfig, KVSpec, Request, make_engine
from repro_torch.utils.convert import params_from_numpy

NAME = "tinyllama-1.1b"


@pytest.fixture(autouse=True)
def _clean_tracer():
    """Tracing is opt-in per test; never leak a tracer into the suite."""
    trace.disable()
    j_trace.disable()
    yield
    trace.disable()
    j_trace.disable()


# -- metrics registry -----------------------------------------------------------


def test_counter_gauge_create_on_use_and_type_conflict():
    reg = registry.MetricsRegistry()
    c = reg.counter("x")
    c.inc()
    c.inc(2)
    assert reg.counter("x") is c and c.value == 3
    g = reg.gauge("g")
    g.set(1.5)
    g.set(2.5)
    assert reg.gauge("g").value == 2.5
    with pytest.raises(TypeError):
        reg.gauge("x")  # re-registering under a different type


def test_histogram_buckets_and_percentiles():
    h = registry.Histogram("h", bounds=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0, 100.0):
        h.observe(v)
    assert h.count == 4 and h.counts == [1, 1, 1, 1]
    assert h.total == 105.0
    assert h.percentile(0.5) == 2.0  # bucket-upper-bound estimate
    assert h.percentile(0.99) == 4.0  # overflow clamps to top boundary
    assert registry.Histogram("empty").percentile(0.5) == 0.0
    with pytest.raises(ValueError):
        registry.Histogram("bad", bounds=(2.0, 1.0))


def test_histogram_merge_matches_single_stream():
    vals = [float(v) for v in np.random.default_rng(0).integers(1, 5000, size=200)]
    one = registry.Histogram("lat")
    a, b = registry.Histogram("lat"), registry.Histogram("lat")
    for i, v in enumerate(vals):
        one.observe(v)
        (a if i % 2 else b).observe(v)
    a.merge(b)
    assert a.counts == one.counts and a.count == one.count
    assert a.total == one.total
    for q in (0.5, 0.9, 0.99):
        assert a.percentile(q) == one.percentile(q)  # shard-invariant
    with pytest.raises(ValueError):
        a.merge(registry.Histogram("other", bounds=(1.0, 2.0)))


def test_registry_merge_and_in_place_reset():
    reg = registry.MetricsRegistry()
    c = reg.counter("n")
    c.inc(5)
    other = registry.MetricsRegistry()
    other.counter("n").inc(2)
    other.gauge("g").set(7.0)
    other.histogram("h").observe(3.0)
    reg.merge(other)
    assert reg.counter("n").value == 7
    assert reg.gauge("g").value == 7.0
    assert reg.histogram("h").count == 1
    reg.reset()
    assert reg.counter("n").value == 0
    c.inc()  # the cached reference is still the live metric
    assert reg.snapshot()["n"] == 1


def test_snapshot_is_json_and_never_uses_bench_wall_keys():
    reg = registry.MetricsRegistry()
    reg.counter("serve.ticks").inc(3)
    reg.gauge("fleet.rows").set(8.0)
    reg.histogram("serve.latency_ticks").observe(12.0)
    snap = reg.snapshot()
    json.dumps(snap)
    wall = {"seconds", "wall_s", "total_s"}

    def no_wall_keys(node):
        if isinstance(node, dict):
            assert not wall & set(node), f"wall-key collision in {sorted(node)}"
            for v in node.values():
                no_wall_keys(v)

    no_wall_keys(snap)


def test_publish_kv_stats_sets_known_gauges_only():
    registry.reset()
    registry.publish_kv_stats({"blocks_in_use": 3, "prefix_hits": 7, "unknown_key": 9})
    reg = registry.get_registry()
    assert reg.gauge("kv.blocks_in_use").value == 3.0
    assert reg.gauge("kv.prefix_hits").value == 7.0
    assert "kv.unknown_key" not in reg.snapshot()


def test_each_package_has_its_own_registry():
    registry.reset()
    j_registry.reset()
    registry.REGISTRY.counter("only.port").inc()
    assert "only.port" not in j_registry.REGISTRY.snapshot()
    assert registry.REGISTRY is not j_registry.REGISTRY


# -- tracer ---------------------------------------------------------------------


def test_disabled_tracer_is_one_null_singleton():
    assert not trace.enabled() and trace.get() is None
    s = trace.span("x", ("p", "t"))
    assert s is trace.span("y")  # one cached null context manager
    with s:
        pass
    trace.begin("a")
    trace.end()
    trace.complete("c", 0.1)
    trace.instant("i")
    trace.counter("n", {"v": 1.0})
    trace.request_begin(0)
    trace.request_mark(0, "hop")
    trace.request_end(0)
    assert trace.get() is None


def test_ring_buffer_bounds_events_and_counts_drops():
    t = trace.enable(capacity=8)
    for _ in range(20):
        t.instant("e")
    assert len(t.events) == 8 and t.dropped == 12


def test_span_nesting_and_lifecycle_guards():
    t = trace.enable()
    tr = ("p", "t1")
    with t.span("outer", tr, depth=1):
        with t.span("inner", tr):
            assert t.open_depth(tr) == 2
    assert t.open_depth(tr) == 0
    t.request_begin(7, tenant="a")
    t.request_begin(7)  # re-queue after a fault: guarded, not a new span
    t.request_mark(7, "hop", ("p", "t1"))
    t.request_end(7)
    t.request_end(7)  # guarded
    life = t.lifecycle_report()
    assert life["begins"] == 1 and life["ends"] == 1
    assert life["double_begins"] == 1 and life["double_ends"] == 1
    assert life["open"] == []


def test_lifecycle_counters_survive_ring_wrap():
    t = trace.enable(capacity=4)
    for uid in range(10):
        t.request_begin(uid)
        t.request_end(uid)
    life = t.lifecycle_report()
    assert life["begins"] == life["ends"] == 10
    assert life["open"] == [] and t.dropped > 0


# -- export + schema validation -------------------------------------------------


def test_chrome_trace_export_validates_and_carries_metrics():
    t = trace.enable()
    with t.span("work", ("engine", "prefill"), uid=1):
        t.instant("marker", ("engine", "prefill"))
    t.counter("kv", {"blocks": 2.0}, ("engine", "decode"))
    t.complete("tick", 1e-3, ("fleet", "control"), tick=0)
    t.request_begin(1)
    t.request_mark(1, "hop", ("engine", "decode"))
    t.request_end(1)
    obj = export.chrome_trace(metrics={"serve.ticks": 3})
    assert export.validate_chrome_trace(obj) == []
    evs = obj["traceEvents"]
    names = {e.get("name") for e in evs}
    assert {"work", "marker", "kv", "tick", "request", "hop"} <= names
    procs = {e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert {"engine", "fleet", "requests"} <= procs
    flows = [e for e in evs if e.get("cat") == "flow"]
    assert [e["ph"] for e in flows] == ["s", "t", "f"]
    assert all(e["id"] == 1 for e in flows)
    assert obj["otherData"]["metrics"] == {"serve.ticks": 3}
    json.dumps(obj)


def test_validator_flags_broken_traces():
    t = trace.enable()
    t.request_begin(5)  # start without finish
    errs = export.validate_chrome_trace(export.chrome_trace())
    assert any("start without finish" in e for e in errs)
    assert any("unknown phase" in e for e in export.validate_chrome_trace(
        {"traceEvents": [{"ph": "Z", "pid": 1, "tid": 1, "ts": 0.0}]}))
    assert export.validate_chrome_trace({"traceEvents": None})
    assert any("missing" in e for e in export.validate_chrome_trace(
        {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "ts": 0.0}]}))
    with pytest.raises(ValueError):
        export.assert_valid_chrome_trace({"traceEvents": None})


def test_chrome_trace_requires_a_tracer():
    with pytest.raises(ValueError):
        export.chrome_trace()


def test_write_trace_round_trips_through_json(tmp_path):
    t = trace.enable()
    t.request_begin(3, tenant="a")
    t.request_end(3, tokens=2)
    path = str(tmp_path / "t.json")
    obj = export.write_trace(path, metrics=export.metrics_dump())
    with open(path) as f:
        assert json.load(f) == obj
    export.assert_valid_chrome_trace(obj)


# -- both packages side by side -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registries_agree_on_the_same_observations(seed):
    rng = np.random.default_rng(seed)
    regs = (registry.MetricsRegistry(), j_registry.MetricsRegistry())
    bounds = (1.0, 3.0, 10.0, 30.0)
    for v in rng.lognormal(2.0, 1.5, size=300):
        for reg in regs:
            reg.histogram("lat").observe(float(v))
            reg.histogram("lat_b", bounds).observe(float(v))
            reg.counter("n").inc(int(v) % 3)
            reg.gauge("last").set(float(v))
    a, b = (reg.snapshot() for reg in regs)
    assert a == b
    for q in (0.1, 0.5, 0.9, 0.99, 1.0):
        assert regs[0].histogram("lat").percentile(q) == regs[1].histogram("lat").percentile(q)


def _emit_script(mod):
    t = mod.enable(capacity=64)
    with mod.span("outer", ("engine", "prefill"), uid=1, tokens=5):
        mod.instant("mark", ("graph", "control"), a=1)
    mod.begin("decode", ("engine", "decode"), tick=1, batch=2)
    mod.end(("engine", "decode"))
    mod.complete("tick", 2e-3, ("fleet", "control"), tick=0)
    mod.counter("kv", {"blocks_in_use": 3, "live_tokens": 40}, ("engine", "decode"))
    mod.request_begin(4, tenant="chat", tick=0, prompt_tokens=9)
    mod.request_mark(4, "admit", ("engine", "prefill"), slot=0)
    mod.request_mark(9, "orphan", None)
    mod.request_end(4, tokens=3)
    mod.request_end(4)  # double end: guarded in both
    return t


def _strip(obj):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in obj["traceEvents"]]


def test_same_emits_export_the_same_events():
    port = export.chrome_trace(_emit_script(trace))
    ref = j_export.chrome_trace(_emit_script(j_trace))
    assert _strip(port) == _strip(ref)
    assert port["otherData"]["lifecycle"] == ref["otherData"]["lifecycle"]
    assert export.validate_chrome_trace(ref) == j_export.validate_chrome_trace(port) == []


# -- engines: lifecycles, event sequences, bit identity -------------------------


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(j_get_smoke(NAME), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke(NAME), dtype=torch.float32)
    jm = j_build(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build(tc, device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return (jm, jp), (tm, tp)


def _workload(vocab, n=6, max_new=4, seed=0):
    """The reference test's requests (prompts of 3..7 tokens) plus two
    behind a shared 8-token prefix, so the paged store's prefix cache is
    hit; (uid, prompt, max_new, tenant) with two tenants."""
    rng = np.random.default_rng(seed)
    out = [(i, rng.integers(0, vocab, int(rng.integers(3, 8))).astype(np.int32), max_new,
            "chat" if i % 2 else "default") for i in range(n)]
    prefix = rng.integers(0, vocab, 8).astype(np.int32)
    for i in range(2):
        tail = rng.integers(0, vocab, 3).astype(np.int32)
        out.append((n + i, np.concatenate([prefix, tail]), max_new + i, "chat"))
    return out


def _engine_configs(mod_cfg, mod_kv, kind):
    if kind == "aligned":
        return mod_cfg(max_batch=4, max_len=64)
    return mod_cfg(max_batch=4, max_len=64, mode="continuous",
                   kv=mod_kv(kind="paged", block_size=4, prefix_cache=True))


def _drain(eng, cap=500):
    while not eng.idle():
        eng.step()
        cap -= 1
        assert cap > 0, "engine did not drain"


@pytest.mark.parametrize("kind", ["aligned", "continuous_paged"])
def test_engine_lifecycle_invariants(models, kind):
    """Every accepted request closes exactly one lifecycle span: begins ==
    ends, nothing open after drain, no doubles; every request retires,
    and the exported trace passes the schema gate (all flows resolve)."""
    _, (tm, tp) = models
    t = trace.enable()
    eng = make_engine(tm, tp, _engine_configs(EngineConfig, KVSpec, kind))
    work = _workload(tm.cfg.vocab_size)
    accepted = sum(bool(eng.submit(Request(uid=u, prompt=p, max_new_tokens=m, tenant=te)))
                   for u, p, m, te in work)
    assert accepted == len(work)
    _drain(eng)
    life = t.lifecycle_report()
    assert life["begins"] == life["ends"] == accepted
    assert life["open"] == []
    assert life["double_begins"] == 0 and life["double_ends"] == 0
    assert sum(e.get("name") == "retire" for e in t.events) == accepted
    assert export.validate_chrome_trace(export.chrome_trace()) == []


def _live(snap):
    """A registry snapshot without the metrics that `reset` zeroed and
    nothing has touched since (earlier tests in the process made them)."""
    return {k: v for k, v in snap.items() if (v["count"] if isinstance(v, dict) else v)}


def _sequence(events):
    """A trace's events with the clock stripped."""
    return [(e["ph"], e.get("name"), e["track"], e.get("args"), e.get("id")) for e in events]


@pytest.mark.parametrize("kind", ["aligned", "continuous_paged"])
def test_engine_emits_the_reference_sequence(models, kind):
    """One workload through both packages' engines with their tracers on:
    the same events in the same order, on the same tracks, with the same
    arguments: the hooks sit where the reference's do. The registries
    count the same."""
    (jm, jp), (tm, tp) = models
    work = _workload(tm.cfg.vocab_size)
    registry.reset()
    j_registry.reset()

    jt = j_trace.enable()
    je = j_make_engine(jm, jp, _engine_configs(JEngineConfig, JKVSpec, kind))
    for u, p, m, te in work:
        je.submit(JRequest(uid=u, prompt=p, max_new_tokens=m, tenant=te))
    _drain(je)
    j_trace.disable()

    tt = trace.enable()
    te_ = make_engine(tm, tp, _engine_configs(EngineConfig, KVSpec, kind))
    for u, p, m, te in work:
        te_.submit(Request(uid=u, prompt=p.copy(), max_new_tokens=m, tenant=te))
    _drain(te_)
    trace.disable()

    assert {r.uid: r.out_tokens for r in te_.finished} == \
           {r.uid: r.out_tokens for r in je.finished}
    got, want = _sequence(tt.events), _sequence(jt.events)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (i, a, b)
    names = {e[1] for e in got}
    assert {"request", "decode", "admit", "retire"} <= names
    assert ("prefill" if kind == "aligned" else "prefill_packed") in names
    if kind == "continuous_paged":
        assert "kv" in names
    assert tt.lifecycle_report() == jt.lifecycle_report()
    snap, j_snap = (_live(r.get_registry().snapshot()) for r in (registry, j_registry))
    assert snap == j_snap
    assert snap["serve.completions"] == snap["sched.submitted"] == len(work)


def test_tracing_does_not_change_outputs(models):
    """The same workload with the tracer off, then on: bit-identical
    logits every tick and identical output streams (the instrumentation
    is host-side only)."""
    _, (tm, tp) = models

    def run():
        eng = make_engine(tm, tp, _engine_configs(EngineConfig, KVSpec, "continuous_paged"))
        for u, p, m, te in _workload(tm.cfg.vocab_size):
            eng.submit(Request(uid=u, prompt=p.copy(), max_new_tokens=m, tenant=te))
        logits = []
        while not eng.idle():
            eng.step()
            logits.append(eng.last_logits.clone())
            assert len(logits) < 500
        return {r.uid: list(r.out_tokens) for r in eng.finished}, logits

    assert not trace.enabled()
    streams_off, logits_off = run()
    trace.enable()
    streams_on, logits_on = run()
    trace.disable()
    assert streams_on == streams_off
    assert len(logits_on) == len(logits_off)
    for a, b in zip(logits_off, logits_on):
        assert torch.equal(a, b)


def test_engine_cache_view_and_workload_sample(models):
    """`Engine.cache` reads the slot KV as a dense cache in both stores,
    the same rows either way; `workload_sample` is the reference's
    payload; `run_until_drained` is `drain`; the engine is a
    `ServingEngine`."""
    from repro_torch.serve import ServingEngine

    _, (tm, tp) = models
    engines = [make_engine(tm, tp, EngineConfig(max_batch=2, max_len=32, mode="continuous",
                                                kv=KVSpec(kind=k, block_size=4)))
               for k in ("dense", "paged")]
    for e in engines:
        assert isinstance(e, ServingEngine)
        assert e.run_until_drained.__func__ is type(e).drain
        e.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=3))
        e.submit(Request(uid=1, prompt=np.arange(7, dtype=np.int32), max_new_tokens=3))
        e.submit(Request(uid=2, prompt=np.arange(2, dtype=np.int32), max_new_tokens=1))
        e.step()
        assert e.workload_sample() == {"active_slots": 2, "queue_depth": 1, "tokens_out": 2}
    dense, paged = (e.cache for e in engines)
    for slot in range(2):
        n = int(engines[0].kv.lens[slot])
        assert torch.equal(dense["k"][:, slot, :n], paged["k"][:, slot, :n])
        assert torch.equal(dense["v"][:, slot, :n], paged["v"][:, slot, :n])
