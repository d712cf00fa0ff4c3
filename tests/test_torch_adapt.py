"""PyTorch port, the adaptive control loop (`core/adapt.py`) and what it
drives: `LoadLedger`, `calibrate` and `ReplanController` against the
reference's on the same sample sequences (a hypothesis sweep and fig12's
P = 64 skew shift), `CompileGate` and `warmed_step` traces, the stage
traits, `launch.elastic.reshard_state`, and the adaptive word count and
PIC, each in an 8-rank gloo world on the CPU against the reference on 8
fake CPU devices (one world and one JAX subprocess, side by side), with
the superstep wall replaced by a constant in both packages, so that the
decisions depend on the counters alone.

Tolerances, with their reasons:
  * decisions (regroup flag, rows, reason strings) and ledger statistics:
    identical; predicted speedups within 1e-12 relative (the same f64
    arithmetic in the same order: measured equal);
  * histograms: exact (integer counts in f32 sum exactly in any order),
    against JAX, against `np.bincount` and against the static run;
  * PIC: particle counts exact; exits and ownership may differ only by
    particles whose x / width lies within 1e-6 (relative) of a row edge:
    JAX's compiler may multiply by the reciprocal of the width where the
    port divides (ROADMAP C). None occurs at this size; the test names
    any that does. Over all rows the valid (x, v) multisets are equal bit
    for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, strategies as st

from conftest import REPO
from repro.core import adapt as jadapt
from repro_torch.core import adapt as tadapt
from repro_torch.launch.mesh import spawn
from torch_worlds import (
    ADAPT_PIC_CFG,
    ADAPT_PIC_STEPS,
    ADAPT_POLICY,
    ADAPT_WC_CFG,
    ADAPT_WC_STEPS,
    CONST_WALL,
    N_ROWS,
    RESHARD_SHAPE,
    WALL_THRESHOLD,
    adapt_cases,
)

SPEEDUP_REL = 1e-12
EDGE_REL = 1e-6

JAX_CASES = """
import dataclasses, json
import jax, numpy as np
import repro.apps.mapreduce as mr
import repro.apps.pic as pic
from repro.core.adapt import AdaptPolicy
from repro.core.groups import GroupedMesh
from repro.launch.elastic import reshard_state
from repro.utils.compat import make_mesh
mesh = make_mesh(({n},), ("data",))
inp = dict(np.load({inputs!r}))

def const(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    return out, {wall}

mr.timed_call = pic.timed_call = const
res, arrays = {{}}, {{}}
cfg = mr.CorpusCfg(**json.loads({wc_cfg!r}))
for name, alpha0 in (("wc_0125", 0.125), ("wc_025", 0.25)):
    report, ag = mr.run_wordcount_adaptive(mesh, cfg, supersteps={wc_steps}, alpha0=alpha0)
    arrays[name + "/hist"] = np.stack([r["histogram"] for r in report])
    res[name] = {{"report": [{{k: float(v) if k in ("tokens", "work_cv") else v
                              for k, v in r.items() if k != "histogram"}} for r in report],
                 "rows": ag.rows, "speedups": [d.predicted_speedup for d in ag.history]}}
pcfg = pic.PICCfg(**json.loads({pic_cfg!r}))
report, ag, state = pic.run_pic_adaptive(mesh, pcfg, alpha0=0.25, supersteps={pic_steps},
                                         policy=AdaptPolicy(**json.loads({policy!r})))
res["pic"] = {{"report": report, "rows": ag.rows,
              "speedups": [d.predicted_speedup for d in ag.history]}}
for k, v in state.items():
    arrays["pic/" + k] = np.asarray(v)
old = GroupedMesh.build_rows(mesh, rows={{"reduce": 2}})
new = GroupedMesh.build_rows(mesh, rows={{"reduce": 3}})
buf = jax.numpy.asarray(inp["buf"])
got = reshard_state({{"buf": buf, "scalar": jax.numpy.float32(3.0)}}, old, new)
arrays["reshard/buf"] = np.asarray(got["buf"])
res["reshard_scalar"] = float(got["scalar"])
errors = {{}}
for case, call in (
        ("bad_rows", lambda: reshard_state({{"buf": buf}}, old, new, repartition=lambda t, o, n: {{
            "buf": np.zeros((3,) + buf.shape[2:])}})),
        ("rank1", lambda: reshard_state({{"s": jax.numpy.ones(({n},))}}, old, new))):
    try:
        call()
        errors[case] = None
    except Exception as e:
        errors[case] = [type(e).__name__, str(e)]
res["reshard_errors"] = errors
with open({out_json!r}, "w") as f:
    json.dump(res, f)
np.savez({out_npz!r}, **arrays)
print("OK")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's results, JAX's arrays, the port's per-rank results, inputs)."""
    tmp = tmp_path_factory.mktemp("adapt")
    rng = np.random.default_rng(0)
    inputs = {"buf": rng.integers(-9, 10, size=(N_ROWS,) + RESHARD_SHAPE).astype(np.float32)}
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    out_json, out_npz = str(tmp / "jax.json"), str(tmp / "jax.npz")
    code = JAX_CASES.format(n=N_ROWS, inputs=path, wall=CONST_WALL,
                            wc_cfg=json.dumps(ADAPT_WC_CFG), wc_steps=ADAPT_WC_STEPS,
                            pic_cfg=json.dumps(ADAPT_PIC_CFG), pic_steps=ADAPT_PIC_STEPS,
                            policy=json.dumps(ADAPT_POLICY), out_json=out_json,
                            out_npz=out_npz)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={N_ROWS}",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = spawn(adapt_cases, N_ROWS, device="cpu", args=(path,), timeout_s=240)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"JAX subprocess failed:\n{stdout}\n{stderr[-4000:]}")
    with open(out_json) as f:
        jax_res = json.load(f)
    return jax_res, dict(np.load(out_npz)), port, inputs


def _decisions(report):
    return [(r["rows"], r["regrouped"], r["decision"]) for r in report]


def _same_speedups(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= SPEEDUP_REL * abs(w), (g, w)


def _host_counts(t: int) -> np.ndarray:
    from repro_torch.apps.mapreduce import CorpusCfg, make_corpus

    cfg = dataclasses.replace(CorpusCfg(**ADAPT_WC_CFG), seed=t)
    tokens, mask = make_corpus(cfg, cfg.n_docs_per_row * N_ROWS)
    return np.bincount(tokens[mask > 0], minlength=cfg.vocab).astype(np.float32)


# -- the adaptive word count ---------------------------------------------------------

@pytest.mark.parametrize("name", ["wc_0125", "wc_025"])
def test_adaptive_wordcount_matches_jax(results, name):
    """Every rank takes the reference's decisions (rows, reasons, report
    figures) and its histograms, bit for bit and equal to the host's."""
    jax_res, jax_arr, port, _ = results
    want = jax_res[name]
    for rank in port:
        got = rank[name]
        assert _decisions(got["report"]) == [
            ({k: v for k, v in r["rows"].items()}, r["regrouped"], r["decision"])
            for r in want["report"]]
        assert got["rows"] == want["rows"]
        _same_speedups(got["speedups"], want["speedups"])
        for g, w in zip(got["report"], want["report"]):
            assert g["tokens"] == w["tokens"] and g["skew"] == w["skew"]
            assert abs(g["work_cv"] - w["work_cv"]) <= 1e-6, (g, w)
            assert g["wall_s"] == w["wall_s"] == CONST_WALL
        np.testing.assert_array_equal(got["hist"], jax_arr[name + "/hist"])
        for t in range(ADAPT_WC_STEPS):
            np.testing.assert_array_equal(got["hist"][t], _host_counts(t))


def test_adaptive_wordcount_regroups_reduce_one_to_three(results):
    """alpha0 = 1/8 (one reduce row) regroups to three at superstep 1,
    warms up again on the new partition, then finds it optimal."""
    _, _, port, _ = results
    assert _decisions(port[0]["wc_0125"]["report"]) == [
        ({"reduce": 1}, False, "warming up (1/2 samples)"),
        ({"reduce": 1}, True, "{'reduce': 3}"),
        ({"reduce": 3}, False, "warming up (1/2 samples)")] + [
        ({"reduce": 3}, False, "already optimal")] * 3


def test_adaptive_wordcount_noop_equals_static_run(results):
    """alpha0 = 1/4 never regroups (the planner's speedup stays under
    1.25), and every superstep equals the static decoupled run bit for
    bit."""
    _, _, port, _ = results
    for rank in port:
        assert not any(r["regrouped"] for r in rank["wc_025"]["report"])
        assert all(r["decision"].startswith("predicted speedup 1.1")
                   for r in rank["wc_025"]["report"][1:])
        np.testing.assert_array_equal(rank["wc_025"]["hist"], rank["wc_static"])


@pytest.mark.parametrize("name", ["wc_0125", "wc_025"])
def test_adaptive_wordcount_histogram_calls_match_the_schedule(results, name):
    """The keyed-histogram calls, summed over the ranks, equal the
    schedule's: every superstep's pass and one warmup per partition."""
    _, _, port, _ = results
    assert sum(r[name]["calls"] for r in port) == port[0][name]["expected_calls"] > 0


def test_row_dependent_walls_reach_one_decision(results):
    """Each rank's local clock runs at its own rate, so every rank's local
    wall differs; `timed_call` records the slowest row's on every rank
    (one f64 MAX), every rank takes the same decisions, and the world
    finishes. On their own walls the ranks would split: replayed through a
    fresh planner, the first plan regroups on row 7's wall and not on row
    0's (the threshold sits between the two predicted speedups)."""
    _, _, port, _ = results
    slowest = max(r["walls"]["local"] for r in port)
    want = _decisions(port[0]["walls"]["report"])
    walls = [r["wall_s"] for r in port[0]["walls"]["report"]]
    assert walls == pytest.approx([slowest] * ADAPT_WC_STEPS, rel=1e-12)
    for rank in port:
        assert [r["wall_s"] for r in rank["walls"]["report"]] == walls
        assert [s[0] for s in rank["walls"]["samples"]] == walls
        assert _decisions(rank["walls"]["report"]) == want
        assert rank["walls"]["rows"] == port[0]["walls"]["rows"] == {"reduce": 3}
    assert len({r["walls"]["local"] for r in port}) == N_ROWS
    first_plan = [_replay(port[0]["walls"]["samples"][:2], r["walls"]["local"]) for r in port]
    assert first_plan[0] is False and first_plan[-1] is True


def _replay(samples, wall) -> bool:
    """Whether a fresh planner regroups on ``samples``' counters at
    ``wall``."""
    from repro_torch.apps.mapreduce import wordcount_traits

    ctl = tadapt.ReplanController(N_ROWS, {"reduce": 1}, wordcount_traits(),
                                  tadapt.AdaptPolicy(window=2, cooldown=1,
                                                     speedup_threshold=WALL_THRESHOLD))
    return [ctl.step(wall, work, items) for _, work, items in samples][-1].regroup


def test_regroup_back_to_an_earlier_partition(results):
    """Regroups 1 -> 3 -> 1 -> 3 -> 2 reduce rows: each partition's new
    process groups work, and each word count is exact."""
    _, _, port, _ = results
    host = _host_counts(0)
    for rank in port:
        assert [c for c, _ in rank["back"]] == [5, 7, 5, 6]
        for _, hist in rank["back"]:
            np.testing.assert_array_equal(hist, host)


# -- adaptive PIC ----------------------------------------------------------------------

def _edge_particles(x, m, rows: int) -> int:
    width = np.float32(1.0 / rows)
    q = np.asarray(x, np.float32)[np.asarray(m) > 0] / width
    return int((np.abs(q - np.round(q)) <= EDGE_REL * np.maximum(np.abs(q), 1.0)).sum())


def test_adaptive_pic_matches_jax(results):
    """{'comm': 2} -> {'comm': 4} at superstep 1, 1,024 particles every
    superstep, exits 812 / 696 / 514 / 577: the reference's decisions and
    counts, on every rank."""
    jax_res, jax_arr, port, _ = results
    want = jax_res["pic"]
    rows = N_ROWS - port[0]["pic"]["rows"]["comm"]
    edge = _edge_particles(jax_arr["pic/x"], jax_arr["pic/m"], rows)
    for rank in port:
        got = rank["pic"]
        assert [(r["rows"], r["regrouped"], r["decision"]) for r in got["report"]] == [
            (r["rows"], r["regrouped"], r["decision"]) for r in want["report"]]
        assert got["rows"] == want["rows"] == {"comm": 4}
        _same_speedups(got["speedups"], want["speedups"])
        assert [r["n_particles"] for r in got["report"]] == [1024.0] * ADAPT_PIC_STEPS
        exits = [r["exits"] for r in got["report"]]
        if edge == 0:
            assert exits == [r["exits"] for r in want["report"]] == [812, 696, 514, 577]
        else:  # named, and held to the particles at an edge
            assert all(abs(a - r["exits"]) <= edge for a, r in zip(exits, want["report"]))
        assert [r["center"] for r in got["report"]] == [r["center"] for r in want["report"]]
    assert [r["regrouped"] for r in port[0]["pic"]["report"]] == [False, True, False, False]


def test_adaptive_pic_state_matches_jax_and_owns(results):
    """The final state: every valid particle on the row owning it under
    the final partition; the valid (x, v) over all rows equal to JAX's bit
    for bit; per row, only particles at a row edge may differ."""
    _, jax_arr, port, _ = results
    rows = N_ROWS - port[0]["pic"]["rows"]["comm"]
    width = np.float32(1.0 / rows)
    x = np.stack([r["pic"]["state"]["x"] for r in port])
    v = np.stack([r["pic"]["state"]["v"] for r in port])
    m = np.stack([r["pic"]["state"]["m"] for r in port])
    assert m.sum() == 1024 and not m[rows:].any()
    for r in range(rows):
        owner = np.floor(x[r][m[r] > 0] / width).astype(int)
        assert (owner == r).all(), r

    def pairs(x, v, m):
        sel = m > 0
        return np.sort(np.stack([x[sel], v[sel]], 1).view(np.complex64).ravel())

    np.testing.assert_array_equal(pairs(x, v, m),
                                  pairs(jax_arr["pic/x"], jax_arr["pic/v"], jax_arr["pic/m"]))
    off_edge = []
    for r in range(N_ROWS):
        got = set(pairs(x[r], v[r], m[r]).tolist())
        want = set(pairs(jax_arr["pic/x"][r], jax_arr["pic/v"][r], jax_arr["pic/m"][r]).tolist())
        for p in got ^ want:
            q = np.float32(p.real) / width
            if abs(q - np.round(q)) > EDGE_REL * max(abs(q), 1.0):
                off_edge.append((r, p))
    assert not off_edge, f"particles on another row than JAX's, not at an edge: {off_edge[:5]}"


def test_adaptive_pic_migration_is_measured(results):
    """One migration, at superstep 1, gathering every row's three leaves."""
    _, _, port, _ = results
    for rank in port:
        (mig,) = rank["pic"]["stats"]["migrations"]
        assert mig["superstep"] == 1 and mig["seconds"] > 0
        assert mig["gathered_bytes"] == N_ROWS * 3 * ADAPT_PIC_CFG["capacity"] * 4


# -- reshard_state ---------------------------------------------------------------------

def test_reshard_state_redeals_like_jax(results):
    """The default re-deal from 6 compute rows to 5: each rank's new row is
    the reference's, service rows zero; a Python value passes through
    untouched."""
    jax_res, jax_arr, port, inputs = results
    got = np.stack([r["reshard"]["buf"] for r in port])
    np.testing.assert_array_equal(got, jax_arr["reshard/buf"])
    items = inputs["buf"][:6].reshape(-1, RESHARD_SHAPE[1])
    np.testing.assert_array_equal(got[:5].reshape(-1, RESHARD_SHAPE[1])[:len(items)], items)
    assert not got[5:].any()
    assert all(r["reshard"]["scalar"] == jax_res["reshard_scalar"] == 3.0 for r in port)


@pytest.mark.parametrize("case", ["bad_rows", "rank1"])
def test_reshard_state_errors_match_jax(results, case):
    jax_res, _, port, _ = results
    want = jax_res["reshard_errors"][case]
    for rank in port:
        assert list(rank["reshard_errors"][case]) == want and want[0] == "ValueError"


def test_reshard_state_refuses_another_axis_size(results):
    """Inside the world, a mesh of another size is refused: one gloo world
    has one size (a shrink onto fewer rows moves the global serving layout
    between planning meshes instead, `serve.fleet.reshard_serving_state`)."""
    _, _, port, _ = results
    for rank in port:
        kind, msg = rank["reshard_errors"]["axis_size"]
        assert kind == "ValueError" and "one gloo world has one size" in msg


# -- the planner, in one process -------------------------------------------------------

def _both(cls_name, *args, **kw):
    return getattr(jadapt, cls_name)(*args, **kw), getattr(tadapt, cls_name)(*args, **kw)


def _traits(mod, spec):
    return tuple(mod.StageTrait(n, cost_ratio=c, bytes_per_item=b) for n, c, b in spec)


def test_ledger_and_calibration_match_jax():
    """The same samples give the same window statistics and calibration,
    value for value (window eviction, stage-item defaults, clear)."""
    rng = np.random.default_rng(3)
    jl, tl = _both("LoadLedger", window=3)
    spec = (("reduce", 0.5, 4.0), ("io", 0.02, 2.0))
    for i in range(5):
        wall = float(rng.uniform(0.01, 1.0))
        work = rng.integers(50, 500, size=12).astype(float)
        items = {"reduce": float(rng.integers(1, 1e6))} if i % 2 else None
        jl.record(wall, work, items)
        tl.record(wall, work, items)
        for fn in ("n", "total_recorded"):
            assert getattr(jl, fn) == getattr(tl, fn)
        for fn in ("wall_mean", "work_mean", "work_max_mean", "work_cv", "t_sigma_work"):
            assert getattr(jl, fn)() == getattr(tl, fn)(), fn
        assert jl.stage_items_mean("reduce", 7.0) == tl.stage_items_mean("reduce", 7.0)
        jc = jadapt.calibrate(jl, _traits(jadapt, spec), 16, 12)
        tc = tadapt.calibrate(tl, _traits(tadapt, spec), 16, 12)
        assert (jc.t_unit, jc.t_w0, jc.sigma) == (tc.t_unit, tc.t_w0, tc.sigma)
        assert [(s.t_op, s.d_bytes) for s in jc.stages] == [(s.t_op, s.d_bytes) for s in tc.stages]
    jl.clear()
    tl.clear()
    assert tl.n == 0 and tl.wall_mean() == jl.wall_mean() == 0.0
    assert tadapt.calibrate(tl, (), 8, 6) is None
    with pytest.raises(ValueError):
        tl.record(1.0, [])
    with pytest.raises(ValueError):
        tadapt.LoadLedger(window=0)


def _same_decision(dj, dt):
    assert (dt.regroup, dt.rows, dt.reason) == (dj.regroup, dj.rows, dj.reason)
    assert abs(dt.predicted_speedup - dj.predicted_speedup) \
        <= SPEEDUP_REL * abs(dj.predicted_speedup)


def _policies(window, cooldown, threshold, ttl):
    kw = dict(window=window, cooldown=cooldown, speedup_threshold=threshold, pending_ttl=ttl)
    return jadapt.AdaptPolicy(**kw), tadapt.AdaptPolicy(**kw)


@given(n=st.integers(4, 64), reduce0=st.integers(1, 3), window=st.integers(1, 3),
       cooldown=st.integers(0, 3), threshold=st.floats(1.0, 1.4), hot=st.floats(0.0, 50.0),
       seed=st.integers(0, 10_000), ttl=st.integers(0, 3))
@settings(max_examples=25, deadline=None)
def test_controller_matches_jax_on_random_loads(n, reduce0, window, cooldown, threshold, hot,
                                                seed, ttl):
    """Random walls, per-row work and stage items through both planners,
    12 supersteps: identical decisions (flags, rows, reasons), speedups
    within 1e-12 relative. Every third regroup is left pending, so the
    pending TTL and `discard_pending` run too."""
    rng = np.random.default_rng(seed)
    spec = (("reduce", 0.05, 8.0), ("io", 0.02, 2.0))
    rows = {"reduce": reduce0, "io": 1}
    if n - sum(rows.values()) < 1:
        return
    jp, tp = _policies(window, cooldown, threshold, ttl)
    jc = jadapt.ReplanController(n, rows, _traits(jadapt, spec), jp)
    tc = tadapt.ReplanController(n, rows, _traits(tadapt, spec), tp)
    seen = 0
    for t in range(12):
        n_compute = n - sum(jc.rows.values())
        work = rng.integers(0, 1000, size=n_compute).astype(float) * rng.uniform(0.5, 2.0)
        items = {"reduce": float(work.sum() * hot * rng.uniform(0.5, 1.5)),
                 "io": float(work.sum())}
        wall = float(rng.uniform(1e-4, 2.0))
        dj, dt = jc.step(wall, work, items), tc.step(wall, work, items)
        _same_decision(dj, dt)
        if dj.regroup:
            seen += 1
            if seen % 3:
                jc.apply(dj)
                tc.apply(dt)
            elif t % 2:
                jc.discard_pending()
                tc.discard_pending()
        assert jc.rows == tc.rows and (jc.pending is None) == (tc.pending is None)
    assert [(d.regroup, d.rows, d.reason) for d in jc.history] == \
        [(d.regroup, d.rows, d.reason) for d in tc.history]


def test_controller_matches_jax_on_fig12_trajectory():
    """fig12's P = 64 chain (compute -> reduce -> io) with its mid-run skew
    shift (benchmarks/fig12_adaptive.py): both planners see the same
    simulated samples, step for step, and regroup alike."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from benchmarks import fig12_adaptive as fig12

    spec = [(t.name, t.cost_ratio, t.bytes_per_item) for t in fig12.TRAITS]
    pol = fig12.POLICY
    tpol = tadapt.AdaptPolicy(window=pol.window, cooldown=pol.cooldown,
                              speedup_threshold=pol.speedup_threshold)
    shift = 6
    rows0 = fig12._oracle_rows(*fig12._phase(0, shift))
    jc = jadapt.ReplanController(fig12.N_ROWS, dict(rows0), fig12.TRAITS, pol)
    tc = tadapt.ReplanController(fig12.N_ROWS, dict(rows0), _traits(tadapt, spec), tpol)
    rng = np.random.default_rng(0)
    regroups = 0
    for t in range(14):
        wall, work, items = fig12._true_superstep(jc.rows, *fig12._phase(t, shift), rng)
        dj, dt = jc.step(wall, work, items), tc.step(wall, work, items)
        _same_decision(dj, dt)
        if dj.regroup:
            regroups += 1
            jc.apply(dj)
            tc.apply(dt)
        assert tc.rows == jc.rows
    assert 1 <= regroups <= fig12.MAX_REGROUPS


def test_controller_validation_matches_jax():
    for mod in (jadapt, tadapt):
        with pytest.raises(ValueError):
            mod.ReplanController(8, {"reduce": 1}, (mod.StageTrait("io"),), mod.AdaptPolicy())
        ctl = mod.ReplanController(8, {"reduce": 1}, (mod.StageTrait("reduce"),),
                                   mod.AdaptPolicy(window=2))
        with pytest.raises(ValueError):  # a "warming up" verdict
            ctl.apply(ctl.step(1.0, np.ones(7)))
    assert tadapt.AdaptPolicy().pending_ttl_steps == jadapt.AdaptPolicy().pending_ttl_steps


def test_adapt_counters_on_the_port_registry():
    from repro_torch.obs import registry

    registry.reset()
    ctl = tadapt.ReplanController(64, {"reduce": 2}, (tadapt.StageTrait("reduce", 0.05, 8.0),),
                                  tadapt.AdaptPolicy(window=2, cooldown=1,
                                                     speedup_threshold=1.15))
    work = np.full(62, 100.0)
    for _ in range(2):
        d = ctl.step(1.0, work, {"reduce": 40 * work.sum()})
    assert d.regroup
    ctl.apply(d)
    snap = registry.REGISTRY.snapshot()
    assert snap["adapt.load_samples"] == 2 and snap["adapt.regroups"] == 1


def test_stage_traits_match_jax():
    from repro.apps import mapreduce as jmr, pic as jpic
    from repro.train.train_step import TrainStepConfig as JCfg, train_stage_traits as jtraits
    from repro_torch.apps import mapreduce as tmr, pic as tpic
    from repro_torch.train.train_step import TrainStepConfig as TCfg, train_stage_traits

    def values(traits):
        return [(t.name, t.cost_ratio, t.bytes_per_item, t.t_prime) for t in traits]

    assert values(tmr.wordcount_traits(256)) == values(jmr.wordcount_traits(256))
    assert values(tpic.pic_traits()) == values(jpic.pic_traits())
    for a in (0.0, 0.125):
        assert values(train_stage_traits(TCfg(mode="decoupled", analytics_alpha=a))) == \
            values(jtraits(JCfg(mode="decoupled", analytics_alpha=a)))


# -- first-use guards and their traces --------------------------------------------------

def _gate_events(mod, trace):
    tr = trace.enable()
    try:
        g = mod.CompileGate()
        flags = [g.sample(0.5), g.sample(0.1), g.sample(0.1)]
        g.rebuilt()
        flags.append(g.sample(0.2))
    finally:
        trace.disable()
    return flags, [(e["ph"], e["name"], e["track"], round(e["dur"], 9)) for e in tr.events]


def test_compile_gate_matches_jax():
    from repro.obs import trace as jtrace
    from repro_torch.obs import trace as ttrace

    got, want = _gate_events(tadapt, ttrace), _gate_events(jadapt, jtrace)
    assert got == want
    assert got[0] == [False, True, True, False]
    assert [e[1] for e in got[1]] == ["compile", "compile"]


def test_warmed_step_builds_once_and_traces_compile():
    """One build and one warmup per key, under one ``compile`` span on
    ("adapt", "compile"), as the reference's."""
    import jax
    import jax.numpy as jnp

    from repro.obs import trace as jtrace
    from repro_torch.obs import trace as ttrace

    def run(mod, trace, build, arg):
        tr = trace.enable()
        built = []
        try:
            cache: dict = {}

            def counted():
                built.append(1)
                return build()

            fn = mod.warmed_step(cache, ("k", 2), counted, arg)
            fn2 = mod.warmed_step(cache, ("k", 2), counted, arg)
            assert fn is fn2
            out = fn(arg)
        finally:
            trace.disable()
        return built, [(e["ph"], e.get("name"), e["track"], e.get("args")) for e in tr.events], out

    jb, jev, jout = run(jadapt, jtrace, lambda: jax.jit(lambda x: x + 1), jnp.zeros(2))
    tb, tev, tout = run(tadapt, ttrace, lambda: (lambda x: x + 1), torch.zeros(2))
    assert tb == jb == [1]
    assert tev == jev
    assert [e[0] for e in tev] == ["B", "E"] and tev[0][1] == "compile"
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_timed_call_outside_a_world_is_the_local_wall():
    from repro_torch.launch.mesh import Mesh

    out, wall = tadapt.timed_call(lambda x: x * 2, torch.ones(3), mesh=Mesh(n_rows=8, device="cpu"))
    assert torch.equal(out, torch.full((3,), 2.0)) and 0.0 <= wall < 1.0
    assert tadapt.agreed_wall(None, 0.25) == 0.25


def test_particle_repartition_matches_jax():
    """The migration's re-binning (host numpy) against the reference's,
    from 6 compute rows to 4, bit for bit."""
    from repro.apps import pic as jpic
    from repro_torch.apps import pic as tpic
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.launch.mesh import Mesh

    rng = np.random.default_rng(5)
    cap = 256
    m = (rng.uniform(size=(6, cap)) < 0.5).astype(np.float32)
    host = {"x": (rng.uniform(size=(6, cap)) * m).astype(np.float32),
            "v": rng.normal(size=(6, cap)).astype(np.float32), "m": m}
    planning = Mesh(n_rows=8, device="cpu")
    old = GroupedMesh.build_rows(planning, rows={"comm": 2})
    new = GroupedMesh.build_rows(planning, rows={"comm": 4})
    got = tpic._particle_repartition(cap, 1.0)(host, old, new)
    want = jpic._particle_repartition(cap, 1.0)(host, old, new)
    for k in "xvm":
        np.testing.assert_array_equal(got[k], want[k])
    assert got["m"].sum() == m.sum()


@pytest.mark.parametrize("attract", [0.0, 2.0])
def test_push_toward_the_sheet_matches_jax(attract):
    """`_push` with the pull toward an f32 center, bit for bit; without it
    the field-free push is unchanged."""
    import jax.numpy as jnp

    from repro.apps import pic as jpic
    from repro_torch.apps import pic as tpic

    rng = np.random.default_rng(7)
    x = rng.uniform(-0.05, 1.05, 4096).astype(np.float32)
    v = rng.normal(size=4096).astype(np.float32) * 3
    m = (rng.uniform(size=4096) < 0.8).astype(np.float32)
    center = 0.37
    got = tpic._push(*(torch.from_numpy(a) for a in (x, v, m)), 0.1, 1.0, attract,
                     float(np.float32(center)))
    want = jpic._push(*(jnp.asarray(a) for a in (x, v, m)), 0.1, 1.0, attract,
                      jnp.float32(center))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if not attract:
        plain = tpic._push(*(torch.from_numpy(a) for a in (x, v, m)), 0.1, 1.0)
        for g, p in zip(got, plain):
            assert torch.equal(g, p)
