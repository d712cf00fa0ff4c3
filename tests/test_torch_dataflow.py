"""PyTorch port, the dataflow runtime and the MapReduce app: `ServiceGraph`
(`run`/`run_chain`, `regroup`, bidirectional edges), `delta_emitter`,
`sink_sum_stage`, `with_work_probe`, `StreamChannel.scatter_back`, the
group collectives, `select_by_role`, error feedback on an int8 wire, the
word count in every mode and its measured counters, and the quickstart's
statistics, in an 8-rank gloo world on the CPU (`launch.mesh.spawn`)
against the same code of the JAX package under `shard_map` on 8 fake CPU
devices, on the same numpy inputs. One JAX subprocess and one world run
every case (side by side); each test checks one of them.

Tolerances: exact wherever the values are integers in f32 (every chain,
fold, scatter, collective and histogram here: integer-valued inputs sum
exactly in any order). The quickstart's workload figures (a sum of 8,192
squared sines, in another summation order) 1e-5 relative. Error feedback:
each package's parameters within 2e-3 of the exact-gradient trajectory
after 60 steps (the reference test's bound), so within 4e-3 of each
other; the int8 codec may round an element on a rounding edge one step
apart (ROADMAP C, `kv_quantize`).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO
from repro.core import ServiceGraph as JServiceGraph
from repro.core import Stage as JStage
from repro.core import wire as jwire
from repro_torch.core import wire as twire
from repro_torch.core.dataflow import ServiceGraph, Stage
from repro_torch.launch.mesh import Mesh, spawn
from torch_worlds import ALPHA, FEEDBACK_STEPS, N_ROWS, WC_CFG, WC_VARIANTS, dataflow_cases

JAX_CASES = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.apps.mapreduce import (CorpusCfg, decoupled_wordcount_measured, layout_corpus,
                                  make_corpus, run_wordcount, wordcount_graph)
from repro.core import (GroupedMesh, ServiceGraph, Stage, WireSpec, delta_emitter,
                        finalize_workload_stats, probe_work, sink_sum_stage, with_work_probe,
                        workload_stats_op)
from repro.core.decouple import (group_all_gather, group_psum, group_psum_scatter, role_index,
                                 select_by_role)
from repro.core.wire import compress_with_feedback
from repro.utils.compat import make_mesh, shard_map
inp = dict(np.load({inputs!r}))
mesh = make_mesh(({n},), ("data",))
out = {{}}

def run(body, *args):
    def inner(*a):
        res = body(*[jax.tree.map(lambda v: v[0], x) for x in a])
        return jax.tree.map(lambda y: y[None], res)
    return jax.jit(shard_map(inner, mesh, tuple(P("data") for _ in args), P("data")))(*args)

x = jnp.asarray(inp["x"])
head_op = lambda acc, e, k: acc + e * (k + 1)
g3 = ServiceGraph.build(mesh, stages={{"reduce": 0.25, "relay": 0.125, "io": 0.125}},
                        edges=[("compute", "reduce"), ("reduce", "relay"), ("relay", "io")])

def chain3(v, c=None):
    zero = jnp.zeros((16,), jnp.float32)
    head = Stage("compute", "reduce", head_op, zero, elements=v, count=c, emit=delta_emitter(zero))
    relay = sink_sum_stage("reduce", "relay", 16)
    relay = dataclasses.replace(relay, emit=delta_emitter(relay.init))
    return tuple(g3.run_chain([head, relay, sink_sum_stage("relay", "io", 16)]))

for i, a in enumerate(run(chain3, x)):
    out[f"chain3/{{i}}"] = a
for i, a in enumerate(run(chain3, x, jnp.asarray(inp["count"]))):
    out[f"chain3_count/{{i}}"] = a

g2 = ServiceGraph.build(mesh, stages={{"reduce": 0.25, "io": 0.125}},
                        edges=[("compute", "reduce"), ("compute", "io")])

def two(v):
    zero = jnp.zeros((16,), jnp.float32)
    (a,), (b,) = g2.run([[Stage("compute", "reduce", head_op, zero, elements=v)],
                         [Stage("compute", "io", lambda acc, e, k: acc + e * e, zero, elements=v)]])
    return a, b

out["two_chains/a"], out["two_chains/b"] = run(two, x)
g = ServiceGraph.build(mesh, stages={{"reduce": 0.25}}, edges=[("compute", "reduce")])

def probe(v):
    plain = Stage("compute", "reduce", lambda acc, e, k: acc + e, jnp.zeros((16,), jnp.float32),
                  elements=v)
    probed = with_work_probe(plain, work_of=lambda e: jnp.sum(jnp.abs(e) >= 0))
    acc, count = probe_work(g.run_chain([probed])[0])
    return acc, g.run_chain([plain])[0], group_psum(count, g.gmesh, "reduce")

out["probe/acc"], out["probe/bare"], out["probe/total"] = run(probe, x)
g_re = g.regroup({{"reduce": 3}})
out["regroup/rows"] = np.tile(np.array([[s.start, s.stop] for s in g_re.gmesh.groups]), ({n}, 1, 1))
out["regroup/acc"] = run(lambda v: g_re.run_chain(
    [Stage("compute", "reduce", head_op, jnp.zeros((16,), jnp.float32), elements=v)])[0], x)
gb = ServiceGraph.build(mesh, stages={{"reduce": 0.25}}, bidirectional=[("compute", "reduce")])
chunk_op = lambda acc, elem, k: acc.at[k].add(elem * (k + 1))

def bidir(v):
    fwd = gb.channel("compute", "reduce").stream_fold(v, chunk_op, jnp.zeros_like(v))
    return fwd, gb.reverse_channel("compute", "reduce").stream_fold(fwd, chunk_op, jnp.zeros_like(v))

out["bidir/fwd"], out["bidir/back"] = run(bidir, x)
ch = g.channel("compute", "reduce")
rowid = jnp.arange({n}, dtype=jnp.float32)
for w in range(ch.n_waves):
    out[f"scatter/{{w}}"] = run(lambda v, rr: ch.scatter_back(v + 100 * rr, wave_of_target=w), x, rowid)
y = x.reshape({n}, -1)
gt = GroupedMesh.trivial(mesh)
g1 = GroupedMesh.build(mesh, services={{"reduce": 1 / 8}})
out["psum_scatter/all"] = run(lambda v: group_psum_scatter(v, gt, "compute"), y)
out["all_gather/all"] = run(lambda v: group_all_gather(v, gt, "compute"), y)
out["psum_scatter/one"] = run(lambda v: group_psum_scatter(v, g1, "reduce"), y)
out["all_gather/one"] = run(lambda v: group_all_gather(v, g1, "reduce"), y)
out["role"] = run(lambda v: role_index(g.gmesh), x)
out["select"] = run(lambda v: select_by_role(g.gmesh, {{"compute": lambda: v * 2,
                                                       "reduce": lambda: v + 100}}), x)
out["select3"] = run(lambda v: select_by_role(g3.gmesh, {{"reduce": lambda: v - 1,
                                                         "io": lambda: v * 3}}), x)

gf = ServiceGraph.build(mesh, stages={{"reduce": 0.25}}, edges=[("compute", "reduce")],
                        wire={{("compute", "reduce"): WireSpec(codec="int8", chunk_bytes=256)}})
fch = gf.channel("compute", "reduce")

def step(params, tgt, residual, w):
    tgt, residual, w = tgt[0], residual[0], w[0]
    grads = (params - tgt) * w
    corrected, new_res = compress_with_feedback(grads, residual, "int8", chunk_bytes=256)
    acc = group_psum(fch.stream_fold_tree(corrected), gf.gmesh, "reduce")
    return params - 0.1 * fch.broadcast_from_consumer(acc) / 6.0, new_res[None]

sm = jax.jit(shard_map(step, mesh, (P(), P("data"), P("data"), P("data")), (P(), P("data"))))
params = jnp.zeros((96,), jnp.float32)
res = jnp.zeros(({n}, 96), jnp.float32)
row_w = jnp.asarray((np.arange({n}) < 6).astype(np.float32))
for _ in range({steps}):
    params, res = sm(params, jnp.asarray(inp["target"]), res, row_w)
out["feedback/params"] = np.tile(np.asarray(params), ({n}, 1))

cfg = CorpusCfg(**json.loads({wc_cfg!r}))
for name, mode, kw in json.loads({variants!r}):
    h, _ = run_wordcount(mesh, mode, cfg, alpha={alpha}, **kw)
    out[f"wc/{{name}}"] = np.tile(h, ({n}, 1))
graph, gmesh, _ = wordcount_graph(mesh, "decoupled", {alpha})
tokens, mask = make_corpus(cfg, cfg.n_docs_per_row * {n})
lt, lm = layout_corpus(tokens, mask, gmesh.compute.size, {n})
out["measured/hist"], out["measured/work"], out["measured/stage"] = run(
    lambda t, m: decoupled_wordcount_measured(t, m, cfg.vocab, graph), lt, lm)

qgraph = ServiceGraph.build(mesh, stages={{"analytics": 1 / 8}}, edges=[("compute", "analytics")])
qch = qgraph.channel("compute", "analytics")
qop = workload_stats_op(max_samples=64)

def qrow(work):
    local = jnp.sum(jnp.sin(work[0]) ** 2)
    elements = jnp.zeros((1, 8), jnp.float32).at[0, 0].set(local)
    stats = qch.stream_fold(elements, qop.apply, qop.init())
    return local, stats[0], stats[1]

rng = np.random.default_rng(0)
rng.integers(1000, 8000)
work = jnp.asarray(rng.normal(size=({n}, 1, 8192)).astype(np.float32))
local, samples, counts = run(qrow, work)
st = finalize_workload_stats((samples[{n} - 1], counts[{n} - 1]))
out["quickstart/local"] = local
out["quickstart/stats"] = np.array([float(st[k]) for k in ("min", "max", "median", "count")])
np.savez({outputs!r}, **{{k: np.asarray(v, np.float32) for k, v in out.items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both packages' outputs of every case (the port's stacked by row,
    ``quickstart/stats`` from the analytics row), and the inputs."""
    tmp = tmp_path_factory.mktemp("dataflow")
    rng = np.random.default_rng(0)
    inputs = {"x": rng.integers(-8, 9, size=(N_ROWS, 4, 16)).astype(np.float32),
              "count": np.array([1, 4, 2, 3, 4, 1, 2, 3], np.int32),
              "target": rng.normal(size=(N_ROWS, 96)).astype(np.float32)}
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    jax_out = str(tmp / "jax.npz")
    code = JAX_CASES.format(inputs=path, outputs=jax_out, n=N_ROWS, alpha=ALPHA,
                            steps=FEEDBACK_STEPS, wc_cfg=json.dumps(WC_CFG),
                            variants=json.dumps(WC_VARIANTS))
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={N_ROWS}",
               PYTHONPATH=os.path.join(REPO, "src"))
    # the JAX subprocess and the world run side by side
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = spawn(dataflow_cases, N_ROWS, device="cpu", args=(path,), timeout_s=240)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"JAX subprocess failed:\n{stdout}\n{stderr[-4000:]}")
    stacked = {k: np.stack([r[k] for r in port]) for k in port[0] if k != "quickstart/stats"}
    stacked["quickstart/stats"] = port[-1]["quickstart/stats"]
    return inputs, dict(np.load(jax_out)), stacked


EXACT = ["chain3/0", "chain3/1", "chain3/2", "chain3_count/0", "chain3_count/1",
         "chain3_count/2", "two_chains/a", "two_chains/b", "probe/acc", "probe/bare",
         "probe/total", "regroup/rows", "regroup/acc", "bidir/fwd", "bidir/back", "scatter/0",
         "scatter/1", "scatter/2", "psum_scatter/all", "all_gather/all", "psum_scatter/one",
         "all_gather/one", "role", "select", "select3", "measured/hist", "measured/work",
         "measured/stage"]


@pytest.mark.parametrize("case", EXACT)
def test_dataflow_case_matches_jax_exactly(results, case):
    _, jax_out, port = results
    want, got = jax_out[case], port[case]
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.astype(np.float32), want)


def test_chain_stages_fold_on_their_rows_only(results):
    """Rows 0-3 compute, 4-5 reduce, 6 relay, 7 io: each stage's state is
    nonzero only on its consumer rows, and the io sink holds the grand
    total of every producer's weighted chunks."""
    inputs, _, port = results
    x = inputs["x"]
    total = (x[:4] * np.arange(1, 5)[None, :, None]).sum((0, 1))
    for i, rows in enumerate(((4, 5), (6,), (7,))):
        acc = port[f"chain3/{i}"]
        others = [r for r in range(N_ROWS) if r not in rows]
        assert not acc[others].any()
        np.testing.assert_array_equal(acc[list(rows)].sum(0), total)


def test_work_probe_counts_every_arrival(results):
    _, _, port = results
    np.testing.assert_array_equal(port["probe/acc"], port["probe/bare"])
    assert (port["probe/total"][6:] == 6 * 4 * 16).all()


def test_select_by_role_refuses_branches_of_other_shapes(results):
    _, _, port = results
    assert port["select_mismatch_raised"].all()


@pytest.mark.parametrize("name", [v[0] for v in WC_VARIANTS])
def test_wordcount_matches_jax_and_host_count(results, name):
    """Every mode, on every row, bit for bit against JAX's `run_wordcount`
    and `np.bincount` of the valid words."""
    from repro_torch.apps.mapreduce import CorpusCfg, make_corpus

    _, jax_out, port = results
    cfg = CorpusCfg(**WC_CFG)
    tokens, mask = make_corpus(cfg, cfg.n_docs_per_row * N_ROWS)
    host = np.bincount(tokens[mask > 0], minlength=cfg.vocab).astype(np.float32)
    got = port[f"wc/{name}"]
    np.testing.assert_array_equal(got, jax_out[f"wc/{name}"])
    for row in got:
        np.testing.assert_array_equal(row, host)


@pytest.mark.parametrize("name", [v[0] for v in WC_VARIANTS])
def test_wordcount_times_its_phases(results, name):
    """``run_wordcount(..., phases=)`` collects every phase of its mode
    (map/pack, stream+fold, group sum, broadcast) on every row."""
    _, _, port = results
    assert port[f"wc_phases/{name}"].all()


def test_measured_counters_match_host_counts(results):
    from repro_torch.apps.mapreduce import CorpusCfg, layout_corpus, make_corpus

    _, _, port = results
    cfg = CorpusCfg(**WC_CFG)
    tokens, mask = make_corpus(cfg, cfg.n_docs_per_row * N_ROWS)
    _, lm = layout_corpus(tokens, mask, 6, N_ROWS)
    for row in port["measured/work"]:
        np.testing.assert_array_equal(row, lm.sum((1, 2)))
    assert (port["measured/stage"] == mask.sum()).all()


def test_error_feedback_tracks_exact_trajectory(results):
    inputs, jax_out, port = results
    tgt_mean = inputs["target"][:6].mean(0)
    exact = np.zeros(96)
    for _ in range(FEEDBACK_STEPS):
        exact = exact - 0.1 * (exact - tgt_mean)
    got = port["feedback/params"]
    for row in got:
        np.testing.assert_allclose(row, exact, atol=2e-3)
        np.testing.assert_allclose(row, tgt_mean, atol=2e-2)
    np.testing.assert_allclose(got, jax_out["feedback/params"], atol=4e-3)


def test_quickstart_statistics_match_jax(results):
    _, jax_out, port = results
    np.testing.assert_allclose(port["quickstart/local"], jax_out["quickstart/local"],
                               rtol=1e-5)
    np.testing.assert_allclose(port["quickstart/stats"][:3], jax_out["quickstart/stats"][:3],
                               rtol=1e-5)
    assert port["quickstart/stats"][3] == jax_out["quickstart/stats"][3] == N_ROWS - 1


# -- in one process: topology checks and the error-feedback round trip -------------

class _FakeJaxMesh:
    """The reference's `GroupedMesh` reads only ``mesh.shape[axis]``."""

    def __init__(self, n):
        self.shape = {"data": n}


TOPOLOGY_ERRORS = {
    "self_edge": dict(edges=[("compute", "compute")]),
    "unknown_group": dict(edges=[("compute", "nowhere")]),
    "duplicate_edge": dict(edges=[("compute", "reduce"), ("compute", "reduce")]),
    "directed_and_bidirectional": dict(edges=[("compute", "reduce")],
                                       bidirectional=[("compute", "reduce")]),
    "wire_on_undeclared_edge": dict(edges=[("compute", "reduce")],
                                    wire={("reduce", "compute"): "int8"}),
}


def _build(graph_cls, mesh, kw):
    try:
        return graph_cls.build(mesh, stages={"reduce": 0.25}, **kw), None
    except (KeyError, ValueError) as e:
        return None, type(e)


@pytest.mark.parametrize("case", sorted(TOPOLOGY_ERRORS))
def test_topology_errors_match_jax(case):
    kw = TOPOLOGY_ERRORS[case]
    _, want = _build(JServiceGraph, _FakeJaxMesh(8), kw)
    _, got = _build(ServiceGraph, Mesh(n_rows=8, device="cpu"), kw)
    assert want is not None and got is want


CHAIN_ERRORS = ["empty", "no_elements", "elements_downstream", "broken_chain", "no_emit",
                "undeclared_edge"]


def _chain(stage_cls, case, elements, init):
    op = lambda acc, e, k: acc  # noqa: E731
    head = stage_cls("compute", "reduce", op, init, elements=elements, emit=lambda a, k: a)
    tail = stage_cls("reduce", "io", op, init)
    return {"empty": [], "no_elements": [dataclasses.replace(head, elements=None)],
            "elements_downstream": [head, dataclasses.replace(tail, elements=elements)],
            "broken_chain": [head, stage_cls("compute", "io", op, init)],
            "no_emit": [dataclasses.replace(head, emit=None), tail],
            "undeclared_edge": [stage_cls("io", "reduce", op, init, elements=elements)]}[case]


@pytest.mark.parametrize("case", CHAIN_ERRORS)
def test_chain_validation_matches_jax(case):
    import jax.numpy as jnp

    kw = dict(stages={"reduce": 0.25, "io": 0.125},
              edges=[("compute", "reduce"), ("reduce", "io")],
              bidirectional=[("compute", "io")])
    jg = JServiceGraph.build(_FakeJaxMesh(8), **kw)
    tg = ServiceGraph.build(Mesh(n_rows=8, device="cpu"), **kw)
    errors = []
    for graph, stage_cls, arr in ((jg, JStage, jnp.zeros((2, 4))), (tg, Stage, torch.zeros(2, 4))):
        with pytest.raises((KeyError, ValueError)) as info:
            graph.run_chain(_chain(stage_cls, case, arr, arr[0]))
        errors.append(info.type)
    assert errors[0] is errors[1]


def test_bidirectional_queries_match_jax():
    kw = dict(stages={"reduce": 0.25, "io": 0.125}, edges=[("compute", "io")],
              bidirectional=[("compute", "reduce")])
    jg = JServiceGraph.build(_FakeJaxMesh(8), **kw)
    tg = ServiceGraph.build(Mesh(n_rows=8, device="cpu"), **kw)
    assert tg.edges == jg.edges and tg.bidir == jg.bidir
    for a, b in (("compute", "reduce"), ("reduce", "compute"), ("compute", "io")):
        assert tg.is_bidirectional(a, b) == jg.is_bidirectional(a, b)
    rev = tg.reverse_channel("compute", "reduce")
    assert (rev.producer, rev.consumer) == ("reduce", "compute")
    with pytest.raises(KeyError):
        tg.reverse_channel("compute", "io")
    with pytest.raises(KeyError):
        tg.regroup({"reduce": 2})
    re = tg.regroup({"reduce": 3, "io": 2})
    jre = jg.regroup({"reduce": 3, "io": 2})
    assert re.describe() == jre.describe() and re.alphas == jre.alphas


class _FoldCounter:
    """A stand-in channel for the schedule alone: each fold adds one."""

    n_waves = 3

    def stream_fold(self, elements, op, acc, count=None, waves=None):
        return acc + 1


def _traced_schedule(mod, tick_chain, regroup):
    """The events of a two-stage chain ticked over its whole schedule and
    of a regroup, with ``mod`` (a package's `obs.trace`) on."""
    from types import SimpleNamespace

    tracer = mod.enable()
    try:
        stages = [SimpleNamespace(src="compute", dst="reduce", elements=np.zeros((3, 2)),
                                  operator=None, count=None, emit=lambda acc, k: acc),
                  SimpleNamespace(src="reduce", dst="io", elements=None, operator=None,
                                  count=None, emit=None)]
        plan = {"stages": stages, "channels": [_FoldCounter(), _FoldCounter()],
                "accs": [np.zeros(2), np.zeros(2)], "n_waves": 3, "emissions": {1: {}}}
        for t in range(4):
            tick_chain(plan, t)
        regroup({"reduce": 3, "io": 2})
    finally:
        mod.disable()
    return [(e["ph"], e.get("name"), e["track"], e.get("args")) for e in tracer.events], plan


def test_schedule_spans_and_regroup_instant_match_jax():
    """The runtime's trace: one span per stage and wave on ("graph",
    "stage<i>") around the fold and the emit, and a "regroup" instant on
    ("graph", "control") with the new rows, as the reference emits them."""
    from repro.obs import trace as j_trace
    from repro_torch.obs import trace as t_trace

    kw = dict(stages={"reduce": 0.25, "io": 0.125},
              edges=[("compute", "reduce"), ("reduce", "io")])
    jg = JServiceGraph.build(_FakeJaxMesh(8), **kw)
    tg = ServiceGraph.build(Mesh(n_rows=8, device="cpu"), **kw)
    got, plan = _traced_schedule(t_trace, ServiceGraph._tick_chain, tg.regroup)
    want, _ = _traced_schedule(j_trace, lambda p, t: JServiceGraph._tick_chain(jg, p, t),
                               jg.regroup)
    assert got == want
    spans = [e for e in got if e[0] == "B"]
    assert [(e[1], e[2], e[3]["wave"], e[3]["tick"]) for e in spans] == [
        ("compute->reduce", ("graph", "stage0"), 0, 0),
        ("compute->reduce", ("graph", "stage0"), 1, 1),
        ("reduce->io", ("graph", "stage1"), 0, 1),
        ("compute->reduce", ("graph", "stage0"), 2, 2),
        ("reduce->io", ("graph", "stage1"), 1, 2),
        ("reduce->io", ("graph", "stage1"), 2, 3)]
    assert got[-1] == ("i", "regroup", ("graph", "control"), {"reduce": 3, "io": 2})
    assert [a.tolist() for a in plan["accs"]] == [[3.0, 3.0], [3.0, 3.0]]


@pytest.mark.parametrize("chunk_bytes", [None, 64, 256])
@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_compress_with_feedback_matches_jax(codec, chunk_bytes):
    """One round trip on a residual: the corrected payload bit for bit;
    the new residual exact with bf16 (round to nearest even on both
    sides), within one quantisation step with int8."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    payload = {"w": rng.normal(size=(9, 7)).astype(np.float32),
               "b": (rng.normal(size=(13,)) * 30).astype(np.float32)}
    residual = {k: (rng.normal(size=v.shape) * 0.01).astype(np.float32)
                for k, v in payload.items()}
    jc, jr = jwire.compress_with_feedback({k: jnp.asarray(v) for k, v in payload.items()},
                                          {k: jnp.asarray(v) for k, v in residual.items()},
                                          codec, chunk_bytes)
    tc, tr = twire.compress_with_feedback({k: torch.from_numpy(v) for k, v in payload.items()},
                                          {k: torch.from_numpy(v) for k, v in residual.items()},
                                          codec, chunk_bytes)
    zero = twire.init_residual({k: torch.from_numpy(v) for k, v in payload.items()})
    for k in payload:
        assert zero[k].dtype == torch.float32 and not zero[k].any()
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        step = np.abs(np.asarray(jc[k])).max() / 127 if codec == "int8" else 0.0
        assert np.abs(tr[k].numpy() - np.asarray(jr[k])).max() <= step * (1 + 1e-6), k
