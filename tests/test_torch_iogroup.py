"""PyTorch port, the decoupled I/O group (`io/iogroup.py`): `io_sink_stage`
as the tail of a compute -> reduce -> io chain, and `stream_to_io_group`
draining to a `HostSink` (one io row, a ring that wraps, a bare
`GroupedMesh`, two io rows), in an 8-rank gloo world on the CPU
(`launch.mesh.spawn`) against the reference's `io/iogroup.py` under
`shard_map` on 8 fake CPU devices, on the same numpy inputs (the
reference's tests `test_io_sink_stage_in_chain` and
`test_io_sink_stage_drains_to_host`, `tests/test_dataflow.py`). One JAX
subprocess and one world run side by side; each test checks one case.

Tolerances: none. Counts, chunk counts and every drained byte are exact:
the histograms sum integer counts, and the drains copy f32 values.
"""
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO
from repro_torch.core.groups import GroupedMesh
from repro_torch.io.iogroup import IO, HostSink, drain_to_sink, io_sink_stage
from repro_torch.launch.mesh import Mesh, spawn
from torch_worlds import IO_VOCAB, N_ROWS, iogroup_cases

JAX_CASES = """
import os
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import ServiceGraph, Stage, delta_emitter
from repro.core.decouple import group_psum
from repro.io.iogroup import HostSink, io_sink_stage, stream_to_io_group
from repro.utils.compat import make_mesh, shard_map
VOCAB = {vocab}
inp = dict(np.load({inputs!r}))
mesh = make_mesh(({n},), ("data",))
out = {{}}
graph = ServiceGraph.build(mesh, stages={{"reduce": 1 / 4, "io": 1 / 8}},
                           edges=[("compute", "reduce"), ("reduce", "io")])
def chain(tokens):
    elems = tokens[0].astype(jnp.float32).reshape(4, -1)
    def hist_op(acc, elem, k):
        return acc.at[jnp.clip(elem.astype(jnp.int32), 0, VOCAB - 1)].add(1.0)
    zero = jnp.zeros((VOCAB,), jnp.float32)
    head = Stage(src="compute", dst="reduce", operator=hist_op, init=zero,
                 elements=elems, emit=delta_emitter(zero))
    tail = io_sink_stage("reduce", granularity_elems=VOCAB, capacity_chunks=16)
    _, (buf, count) = graph.run_chain([head, tail])
    total = group_psum(jnp.sum(buf, axis=0), graph.gmesh, "io")
    return total[None], count[None]
sm = shard_map(chain, mesh, P("data"), (P("data"), P("data")))
out["chain/total"], out["chain/count"] = jax.jit(sm)(jnp.asarray(inp["tokens"]))
io1 = ServiceGraph.build(mesh, stages={{"io": 1 / 8}}, edges=[("compute", "io")])
for name, cap in (("drain", 64), ("wrap", 4)):
    sink = HostSink(os.path.join({sink_dir!r}, name))
    def per_row(x, sink=sink, cap=cap):
        return stream_to_io_group({{"x": x[0]}}, io1, sink, granularity_elems=16,
                                  capacity_chunks=cap)[None]
    out[name + "/count"] = jax.jit(shard_map(per_row, mesh, P("data"), P("data")))(
        jnp.asarray(inp["x"]))
    jax.effects_barrier()
np.savez({outputs!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The inputs, both packages' outputs and their sink directories."""
    tmp = tmp_path_factory.mktemp("iogroup")
    rng = np.random.default_rng(0)
    inputs = {"tokens": rng.integers(0, IO_VOCAB, size=(N_ROWS, 32)).astype(np.int32),
              "x": np.arange(N_ROWS * 32, dtype=np.float32).reshape(N_ROWS, 32)}
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    jax_out, jax_sinks, port_sinks = str(tmp / "jax.npz"), str(tmp / "jax"), str(tmp / "port")
    code = JAX_CASES.format(inputs=path, outputs=jax_out, n=N_ROWS, vocab=IO_VOCAB,
                            sink_dir=jax_sinks)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={N_ROWS}",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = spawn(iogroup_cases, N_ROWS, device="cpu", args=(path, port_sinks),
                     timeout_s=120)
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"JAX subprocess failed:\n{stdout}\n{stderr[-4000:]}")
    stacked = {k: np.stack([r[k] for r in port]) for k in port[0]}
    return inputs, dict(np.load(jax_out)), stacked, jax_sinks, port_sinks


def _files(directory):
    return sorted(os.path.basename(f) for f in glob.glob(os.path.join(directory, "*.npy")))


@pytest.mark.parametrize("case", ["chain/total", "chain/count", "drain/count", "wrap/count"])
def test_iogroup_case_matches_jax_exactly(results, case):
    _, jax_out, port, _, _ = results
    np.testing.assert_array_equal(port[case], jax_out[case])


def test_io_sink_stage_in_chain_sums_to_the_total(results):
    """5 producers over 2 reduce rows: 3 waves, one delta per reduce row
    per wave, so the io row buffers 6; the buffered deltas sum to the
    count of every producer's tokens."""
    inputs, _, port, _, _ = results
    assert port["chain/count"].tolist() == [0] * 7 + [6]
    np.testing.assert_array_equal(port["chain/total"][7],
                                  np.bincount(inputs["tokens"][:5].reshape(-1),
                                              minlength=IO_VOCAB))


@pytest.mark.parametrize("name", ["drain", "wrap"])
def test_drained_files_match_jax(results, name):
    """One file per drain on the single io row, the reference's name, the
    same bytes: every producer's chunks in arrival order, or the ring's
    last 4 slots after it wrapped (14 chunks into 4)."""
    inputs, _, port, jax_sinks, port_sinks = results
    assert _files(os.path.join(port_sinks, name)) == ["drain_000000.npy"]
    assert _files(os.path.join(jax_sinks, name)) == ["drain_000000.npy"]
    got = np.load(os.path.join(port_sinks, name, "drain_000000.npy"))
    want = np.load(os.path.join(jax_sinks, name, "drain_000000.npy"))
    np.testing.assert_array_equal(got, want)
    assert port[f"{name}/count"].tolist() == [0] * 7 + [14]
    if name == "drain":
        np.testing.assert_array_equal(got, inputs["x"][:7].reshape(14, 16))


def test_bare_grouped_mesh_streams_like_a_graph(results):
    inputs, _, port, _, port_sinks = results
    np.testing.assert_array_equal(port["bare/count"], port["drain/count"])
    np.testing.assert_array_equal(np.load(os.path.join(port_sinks, "bare", "drain_000000.npy")),
                                  inputs["x"][:7].reshape(14, 16))


def test_two_io_rows_write_files_of_their_own(results):
    """6 producers over io rows 6 and 7 (3 waves): each io row buffers its
    producers' 6 chunks and drains them to a file named by its row."""
    inputs, _, port, _, port_sinks = results
    d = os.path.join(port_sinks, "two")
    assert _files(d) == ["drain_row006_000000.npy", "drain_row007_000000.npy"]
    assert port["two/count"].tolist() == [0] * 6 + [6, 6]
    for io_row, producers in ((6, [0, 2, 4]), (7, [1, 3, 5])):
        np.testing.assert_array_equal(
            np.load(os.path.join(d, f"drain_row{io_row:03d}_000000.npy")),
            inputs["x"][producers].reshape(6, 16))


# -- single process ---------------------------------------------------------------

def test_host_sink_writes_only_chunks(tmp_path):
    sink = HostSink(str(tmp_path))
    buf = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert sink.drain(buf, 0) == 0
    assert _files(tmp_path) == []
    sink.drain(buf, 2)
    sink.drain(buf, 9)  # a wrapped ring: every slot
    sink.drain(buf, 1, row=3)
    assert _files(tmp_path) == ["drain_000000.npy", "drain_000001.npy",
                                "drain_row003_000002.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "drain_000000.npy"), buf[:2])
    np.testing.assert_array_equal(np.load(tmp_path / "drain_000001.npy"), buf)


@pytest.mark.parametrize("row", [0, 7])
def test_drain_to_sink_touches_the_disk_on_io_rows_only(tmp_path, row):
    gm = GroupedMesh.build(Mesh(n_rows=8, row=row, device="cpu"), services={IO: 1 / 8})
    buf = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    assert drain_to_sink(gm, HostSink(str(tmp_path)), buf, torch.tensor(3)) == 0
    assert _files(tmp_path) == ([] if row == 0 else ["drain_000000.npy"])


def test_io_sink_stage_state_lives_on_its_device():
    stage = io_sink_stage("reduce", granularity_elems=8, capacity_chunks=3, device="cpu")
    buf, count = stage.init
    assert (stage.src, stage.dst) == ("reduce", IO)
    assert buf.shape == (3, 8) and buf.device.type == "cpu" and int(count) == 0
    state = stage.operator(stage.init, torch.ones(8), 0)
    assert int(state[1]) == 1 and state[0][0].sum() == 8
