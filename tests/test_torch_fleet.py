"""PyTorch port, the serving fleet (`serve/fleet.py`): the closed control
loop, forced regroups and the fault paths, against the JAX package on the
f32 tinyllama smoke weights and the same virtual clock. The SPMD layer's
serving reshards and `launch.elastic.repack_block_pool` are held against
the reference's in tests/test_torch_disagg.py, beside its JAX subprocess.

What must be identical: the per-tick report records (decision reasons,
prefill rows, decode slots, ``regrouped``, ``deferred``, ``discarded``,
walls from the same virtual clock, fault records), ``fault_log``,
``recoveries``, the token streams and arrival ticks, the fleet track's
trace markers and the registry's ``fleet.*`` counters. Decisions depend on
the clock and the counters alone, so nothing here has a tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, strategies as st

from repro.configs import get_smoke as j_get_smoke
from repro.core.adapt import AdaptPolicy as JAdaptPolicy
from repro.core.adapt import ReplanDecision as JReplanDecision
from repro.models import build as j_build
from repro.obs import registry as j_registry
from repro.obs import trace as j_trace
from repro.serve import Request as JRequest
from repro.serve import faults as jfaults
from repro.serve.fleet import FleetConfig as JFleetConfig
from repro.serve.fleet import FleetEngine as JFleetEngine
from repro.serve.sched import FleetScheduler as JFleetScheduler
from repro.serve.traffic import replay as j_replay
from repro.serve.traffic import scenario as j_scenario
from repro_torch.configs import get_smoke
from repro_torch.core.adapt import AdaptPolicy, ReplanDecision
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model_zoo import build
from repro_torch.obs import registry as t_registry
from repro_torch.obs import trace as t_trace
from repro_torch.serve import Request
from repro_torch.serve.disagg import PREFILL
from repro_torch.serve.faults import FaultEvent, FaultSchedule
from repro_torch.serve.fleet import FleetConfig, FleetEngine
from repro_torch.serve.sched import FleetScheduler
from repro_torch.serve.traffic import replay, scenario
from repro_torch.utils.convert import params_from_numpy

NAME = "tinyllama-1.1b"


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


@pytest.fixture(autouse=True)
def _tracers_off():
    yield
    j_trace.disable()
    t_trace.disable()


# the two packages' names, side by side
J = dict(Config=JFleetConfig, Engine=JFleetEngine, Request=JRequest, Adapt=JAdaptPolicy,
         Decision=JReplanDecision, Sched=JFleetScheduler, replay=j_replay,
         scenario=j_scenario, FaultEvent=jfaults.FaultEvent,
         FaultSchedule=jfaults.FaultSchedule, trace=j_trace, registry=j_registry)
T = dict(Config=FleetConfig, Engine=FleetEngine, Request=Request, Adapt=AdaptPolicy,
         Decision=ReplanDecision, Sched=FleetScheduler, replay=replay, scenario=scenario,
         FaultEvent=FaultEvent, FaultSchedule=FaultSchedule, trace=t_trace,
         registry=t_registry)


def _both(models):
    (jm, jp), (tm, tp) = models
    return ((J, jm, jp), (T, tm, tp))


def _req(ns, uid, n_tokens, max_new=4, seed=None):
    if seed is None:
        prompt = np.zeros(int(n_tokens), np.int32)
    else:
        prompt = np.random.default_rng(seed).integers(0, 100, int(n_tokens)).astype(np.int32)
    return ns["Request"](uid=uid, prompt=prompt, max_new_tokens=max_new)


def _streams(fe):
    return {r.uid: (list(r.out_tokens), r.submitted_tick) for r in fe.finished}


def _surge(ns):
    sc = ns["scenario"]("bursty-multitenant")
    return dataclasses.replace(sc, horizon=30, max_prompt=56, tenants=tuple(
        dataclasses.replace(t, surge_at=10) if t.surge_at >= 0 else t for t in sc.tenants))


def _fleet_metrics(snap: dict) -> dict:
    """The run's ``fleet.*`` metrics: a reset registry keeps the names an
    earlier run in the process made, at zero, so zeros are left out."""
    return {k: v for k, v in snap.items() if k.startswith("fleet.") and v}


def _clock(tick):
    pre = max(tick["prefill_tokens_per_row"], default=0)
    return max(float(pre), 2.0 * tick["decode_batch"] / 3.0, 1.0) * 1e-3


SURGE_FLEET = dict(n_rows=8, prefill_rows=2, slots_per_row=2, max_len=96, prefill_chunk=8,
                   prefill_cost_ratio=0.5, prefill_bytes_per_token=64.0)
SURGE_ADAPT = dict(window=3, cooldown=3, speedup_threshold=1.05, row_budget=5)


# -- configuration ----------------------------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(recovery="restart"),
    dict(faults=FaultSchedule(())),
    dict(mode="continuous", recovery="checkpoint"),
    dict(mode="continuous", ckpt_cadence=2),
], ids=["recovery", "faults-aligned", "checkpoint-no-dir", "cadence-no-dir"])
def test_fleet_config_refuses_what_the_reference_refuses(bad):
    jbad = dict(bad)
    if "faults" in jbad:
        jbad["faults"] = jfaults.FaultSchedule(())
    with pytest.raises(ValueError) as te:
        FleetConfig(**bad)
    with pytest.raises(ValueError) as je:
        JFleetConfig(**jbad)
    assert str(te.value) == str(je.value)


def test_fleet_engine_refuses_a_split_without_decode_rows(models):
    for ns, m, p in _both(models):
        with pytest.raises(ValueError, match="decode row"):
            ns["Engine"](m, p, ns["Config"](n_rows=4, prefill_rows=4))
    assert FleetConfig(n_rows=5, prefill_rows=2).decode_rows == 3


# -- the closed loop over a scenario -----------------------------------------------------


def test_closed_loop_matches_reference_on_a_virtual_clock(models):
    """The reference's surge test (bursty-multitenant cut to 30 ticks, the
    surge at 10, aligned mode): the same report record every tick, a
    regroup that grows the prefill group, every request finished with the
    reference's stream."""
    out = []
    for ns, m, p in _both(models):
        sc = _surge(ns)
        fe = ns["Engine"](m, p, ns["Config"](**SURGE_FLEET, adapt=ns["Adapt"](**SURGE_ADAPT)),
                          sched=ns["Sched"](sc.tenants), clock=_clock)
        pairs = ns["replay"](fe, sc, 512, max_ticks=2000)
        out.append((fe, pairs))
    (jf, jpairs), (tf, tpairs) = out
    assert list(tf.report) == list(jf.report)
    assert (tf.regroups, tf.deferrals, tf.discarded) == (jf.regroups, jf.deferrals, jf.discarded)
    assert tf.regroups >= 1 and max(r["prefill_rows"] for r in tf.report) > 2
    assert len(tf.finished) == len(tpairs) == len(jpairs)
    assert _streams(tf) == _streams(jf)
    assert tf.ledger.snapshot()["completions"] == len(tpairs)


def test_fleet_trace_and_registry_match_reference(models):
    """The reference's fleet trace test (continuous, a device loss after
    the first regroup) with both packages' tracers on: the same report
    and fault records, the fleet track's markers in the same order with
    the same arguments, the same ``fleet.*`` counters and gauges, and one
    closed lifecycle per request."""
    res = []
    for ns, m, p in _both(models):
        tr = ns["trace"].enable()
        ns["registry"].reset()
        sc = _surge(ns)
        fe = ns["Engine"](m, p, ns["Config"](**SURGE_FLEET, mode="continuous",
                                             adapt=ns["Adapt"](**SURGE_ADAPT)),
                          sched=ns["Sched"](sc.tenants), clock=_clock)
        injected = []

        def on_tick(e, ns=ns, injected=injected):
            if not injected and e.regroups >= 1:
                e.inject_fault(ns["FaultEvent"](e.eng.tick + 1, "device_loss", rows=1))
                injected.append(e.eng.tick + 1)

        pairs = ns["replay"](fe, sc, 512, max_ticks=2000, on_tick=on_tick)
        ns["trace"].disable()
        marks = [(e["name"], e.get("args", {})) for e in tr.events
                 if e["ph"] == "i" and tuple(e["track"]) == ("fleet", "control")]
        snap = ns["registry"].get_registry().snapshot()
        res.append(dict(fe=fe, pairs=pairs, injected=injected, marks=marks,
                        fleet=_fleet_metrics(snap), done=snap["serve.completions"],
                        life=tr.lifecycle_report()))
    jr, tr_ = res
    assert tr_["injected"] == jr["injected"] and tr_["injected"]
    assert list(tr_["fe"].report) == list(jr["fe"].report)
    assert list(tr_["fe"].fault_log) == list(jr["fe"].fault_log)
    assert tr_["marks"] == jr["marks"]
    names = {n for n, _ in tr_["marks"]}
    assert {"replan", "regroup", "fault"} <= names
    assert tr_["fleet"] == jr["fleet"]
    assert tr_["fleet"]["fleet.replans"] >= 1 and tr_["fleet"]["fleet.faults.device_loss"] == 1
    assert tr_["done"] == len(tr_["pairs"]) == len(tr_["fe"].finished)
    assert tr_["life"]["begins"] == tr_["life"]["ends"] and tr_["life"]["open"] == []
    assert _streams(tr_["fe"]) == _streams(jr["fe"])


# -- forced regroups ---------------------------------------------------------------------


def test_forced_regroup_migrates_inflight_slots(models):
    """An applied regroup (1 -> 2 prefill rows) with two slots in flight:
    each slot's KV and token survive bit for bit, the shared cursor too,
    and both packages finish the same streams."""
    out = []
    for ns, m, p in _both(models):
        fe = ns["Engine"](m, p, ns["Config"](n_rows=4, prefill_rows=1, slots_per_row=1,
                                             max_len=64, prefill_chunk=0))
        for i in range(2):
            fe.submit(_req(ns, i, 5 + i, max_new=6, seed=i))
        for _ in range(3):
            fe.step()
        if ns is T:
            occupied = [i for i, s in enumerate(fe.eng.slots) if s is not None]
            assert len(occupied) == 2, "setup: expected 2 in-flight slots"
            before = {s.uid: (fe.eng.cache["k"][:, i].clone(), int(fe.eng.tokens[i, 0]))
                      for i, s in enumerate(fe.eng.slots) if s is not None}
        fe.eng.resize(n_prefill_rows=2, decode_slots=2)
        fe.prefill_rows = 2
        if ns is T:
            for j, s in enumerate(fe.eng.slots):
                if s is not None:
                    assert torch.equal(fe.eng.cache["k"][:, j], before[s.uid][0])
                    assert int(fe.eng.tokens[j, 0]) == before[s.uid][1]
            assert int(fe.eng.cache["pos"]) > 0
        fe.drain()
        out.append(fe)
    jf, tf = out
    assert _streams(tf) == _streams(jf)
    assert all(len(r.out_tokens) == 6 for r in tf.finished)


def test_shrink_past_occupancy_is_refused(models):
    for ns, m, p in _both(models):
        fe = ns["Engine"](m, p, ns["Config"](n_rows=4, prefill_rows=1, slots_per_row=1,
                                             max_len=64, prefill_chunk=0))
        for i in range(3):
            fe.submit(_req(ns, i, 4, max_new=8))
        for _ in range(3):
            fe.step()
        with pytest.raises(ValueError, match="cannot shrink"):
            fe.eng.resize(n_prefill_rows=3, decode_slots=1)


def test_stale_deferred_regroup_is_discarded_as_the_reference(models):
    """A planted shrink that cannot apply: deferred every tick, dropped
    after ``max_deferrals``, planning resumed; the same records as the
    reference's, tick by tick."""
    recs = []
    for ns, m, p in _both(models):
        cfg = ns["Config"](n_rows=4, prefill_rows=1, slots_per_row=1, max_len=64,
                           prefill_chunk=0, max_deferrals=3,
                           adapt=ns["Adapt"](window=2, cooldown=1))
        fe = ns["Engine"](m, p, cfg, clock=lambda tick: 1e-3)
        for i in range(3):
            fe.submit(_req(ns, i, 4, max_new=30))
        for _ in range(4):
            fe.step()
        fe.controller.pending = ns["Decision"](True, {"prefill": 3}, 2.0, "forced", None)
        for _ in range(cfg.max_deferrals + 2):
            fe.step()
        assert fe.discarded == 1 and fe.deferrals >= cfg.max_deferrals
        assert fe.controller.pending is None
        fe.drain()
        assert len(fe.finished) == 3
        recs.append(list(fe.report))
    assert recs[1] == recs[0]


# -- the fault paths ----------------------------------------------------------------------

FAULT_FLEET = dict(mode="continuous", n_rows=4, prefill_rows=1, slots_per_row=2, max_len=64,
                   prefill_chunk=16, min_rows=2)


def _submit_and_fill(ns, fe, n=8, max_new=8):
    """Submit n requests and step until the TAIL row's slots are occupied
    (a tail-row fault then orphans live KV)."""
    for i in range(n):
        fe.submit(_req(ns, i, 5 + (i % 3), max_new=max_new, seed=i))
    spr = fe.cfg.slots_per_row
    for _ in range(30):
        fe.step()
        if all(s is not None for s in fe.eng.slots[-spr:]):
            return
    raise AssertionError("tail decode slots never filled")


@pytest.fixture(scope="module")
def fault_runs(models, tmp_path_factory):
    """Per arm (retry, preempt, checkpoint) and package: the drained fleet
    with its trace markers, lifecycle report and recovery counters; and
    the port's unfaulted run (arm none), whose arrival ticks every arm
    keeps."""
    runs = {}
    for arm in ("none", "retry", "preempt", "checkpoint"):
        for ns, m, p in _both(models):
            if arm == "none" and ns is J:
                continue
            kw = dict(FAULT_FLEET)
            if arm == "checkpoint":
                d = tmp_path_factory.mktemp(f"serving_{'j' if ns is J else 't'}")
                kw.update(recovery="checkpoint", ckpt_dir=str(d), ckpt_cadence=1)
            tr = ns["trace"].enable()
            ns["registry"].reset()
            fe = ns["Engine"](m, p, ns["Config"](**kw))
            if arm == "none":
                for i in range(8):
                    fe.submit(_req(ns, i, 5 + (i % 3), max_new=8, seed=i))
            else:
                _submit_and_fill(ns, fe)
                kind = "preempt" if arm == "preempt" else "device_loss"
                extra = {"duration": 4} if arm == "preempt" else {}
                fe.inject_fault(ns["FaultEvent"](fe.eng.tick + 1, kind, rows=1, **extra))
            fe.drain()
            if fe.ckpt is not None:
                fe.ckpt.close()
            ns["trace"].disable()
            snap = ns["registry"].get_registry().snapshot()
            runs[arm, "jax" if ns is J else "torch"] = dict(
                fe=fe, life=tr.lifecycle_report(),
                names=[e["name"] for e in tr.events
                       if e["ph"] == "i" or e.get("name") in ("retry", "restore")],
                fleet=_fleet_metrics(snap))
    return runs


@pytest.mark.parametrize("arm", ["retry", "preempt", "checkpoint"])
def test_fault_recovery_matches_reference(fault_runs, arm):
    """Device loss with retry, preemption with staging and regrow, device
    loss with checkpoint recovery: the reference's fault log, recovery
    counts, fleet counters, trace markers and one lifecycle span per
    request (no double begin across a retry or restore), and the
    unfaulted streams, with each orphan's original arrival tick."""
    j, t = fault_runs[arm, "jax"], fault_runs[arm, "torch"]
    base = fault_runs["none", "torch"]["fe"]
    fe = t["fe"]
    assert list(fe.fault_log) == list(j["fe"].fault_log)
    assert fe.recoveries == j["fe"].recoveries
    assert (fe.n_rows, fe.regrows, fe.faults_total) == \
           (j["fe"].n_rows, j["fe"].regrows, j["fe"].faults_total)
    assert t["fleet"] == j["fleet"]
    assert t["names"] == j["names"]
    assert t["life"] == j["life"]
    assert t["life"]["begins"] == t["life"]["ends"] == 8 and t["life"]["open"] == []
    assert _streams(fe) == _streams(j["fe"])
    assert {u: s[0] for u, s in _streams(fe).items()} == \
           {u: s[0] for u, s in _streams(base).items()}
    if arm == "retry":
        assert fe.recoveries["retried"] >= 1 and fe.n_rows == 3 and len(fe.eng.slots) == 4
        assert "retry" in t["names"]
    elif arm == "preempt":
        assert fe.recoveries["staged"] >= 1 and fe.recoveries["retried"] == 0
        assert fe.regrows == 1 and fe.n_rows == 4 and "regrow" in t["names"]
    else:
        assert fe.recoveries["restored"] >= 1
        assert {"checkpoint_restore", "checkpoint_save"} <= set(t["names"])


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_random_fault_schedules_never_lose_requests(models, seed):
    """Under generated loss / preemption schedules the finished uid set is
    the submitted one (zero lost), as in the reference, with its fault log
    and streams."""
    logs = []
    for ns, m, p in _both(models):
        sched = ns["FaultSchedule"].generate(8, seed=seed, p_loss=0.35, p_preempt=0.35,
                                             max_rows=2, preempt_duration=3)
        fe = ns["Engine"](m, p, ns["Config"](**FAULT_FLEET, faults=sched))
        for i in range(4):
            fe.submit(_req(ns, i, 4 + (i % 3), max_new=3, seed=i))
        fe.drain(max_steps=400)
        assert sorted(_streams(fe)) == [0, 1, 2, 3]
        logs.append((list(fe.fault_log), _streams(fe), dict(fe.recoveries)))
    assert logs[1] == logs[0]


def test_drain_stall_raises(models):
    _, (tm, tp) = models
    fe = FleetEngine(tm, tp, FleetConfig(**FAULT_FLEET))
    fe.submit(_req(T, 0, 5, max_new=4))
    with pytest.raises(RuntimeError, match="stalled"):
        fe.drain(max_steps=1)


def test_mesh_bound_fleet_drains_after_a_device_loss(models):
    """The reference's mesh-bound fault test on a planning mesh of 4 rows:
    the loss rebuilds the serving topology on a `healthy_mesh` of 3 rows
    (through the monitor's prober) and every request finishes."""
    _, (tm, tp) = models
    fc = FleetConfig(**FAULT_FLEET, faults=FaultSchedule((FaultEvent(4, "device_loss",
                                                                     rows=1),)))
    fe = FleetEngine(tm, tp, fc, mesh=Mesh(n_rows=4, device="cpu"))
    rng = np.random.default_rng(0)
    for i in range(6):
        fe.submit(Request(uid=i, prompt=rng.integers(0, 100, 5 + i % 3).astype(np.int32),
                          max_new_tokens=5))
    fe.drain()
    assert fe.fault_log and fe.n_rows == 3
    assert fe.graph is not None and fe.graph.gmesh.mesh.shape["data"] == 3
    assert fe.graph.gmesh.group(PREFILL).size == 1
    assert sorted(r.uid for r in fe.finished) == list(range(6))


# -- the serving example's new flags --------------------------------------------------------


def test_serve_lm_fleet_flags_run(capsys):
    """`python -m repro_torch.examples.serve_lm --smoke --device cpu` with
    the fleet's flags: the adaptive fleet under a device loss and a
    preemption over bursty-multitenant (no request lost, the fault lines
    printed), and the disaggregated engine on the example's ten requests;
    a fleet flag without a scenario is refused."""
    from repro_torch.examples import serve_lm

    out = serve_lm.main(["--smoke", "--device", "cpu", "--scenario", "bursty-multitenant",
                         "--adapt", "--paged", "--fail-at", "36", "--preempt-at", "32"])
    text = capsys.readouterr().out
    fe = out["engine"]
    assert isinstance(fe, FleetEngine) and "[adaptive-disagg+faults+paged]" in text
    assert "regroups:" in text and "lost 0" in text and "prefix cache:" in text
    assert {r["kind"] for r in fe.fault_log} >= {"device_loss", "preempt"}
    assert len({r.uid for r in fe.finished}) == out["requests"] - fe.sched.rejected
    out = serve_lm.main(["--smoke", "--device", "cpu", "--disagg"])
    text = capsys.readouterr().out
    assert "[disaggregated] served 10 requests" in text
    assert "prefills handed off: 10" in text
    with pytest.raises(SystemExit):
        serve_lm.parse_args(["--adapt"])
