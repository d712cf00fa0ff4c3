"""PyTorch port, the particle-in-cell mini-app (`apps/pic.py`) at the
reference tests' size (`PICCfg(capacity=1024, n_particles_total=1024,
n_steps=3, dt=0.15)`, 8 rows, `tests/test_multidevice.py` and
`tests/test_dataflow.py`): the port's `pic_world` (reference comm,
decoupled comm, decoupled comm beside the io service) in an 8-rank gloo
world on the CPU against the reference's `run_pic` under `shard_map` on 8
fake CPU devices, run side by side; and the buffer operations in one
process against the reference's.

Tolerances, with their reasons:
  * per-step counts, io chunks and validity masks: exact;
  * positions and velocities: the per-row sorted multisets of valid
    (x, v) equal JAX's bit for bit (the push is the same elementwise f32
    arithmetic), except that a particle whose x / width lies within 1e-6
    (relative) of a row edge may sit on the neighbouring row in JAX: its
    compiler may multiply by the reciprocal of the width where the port
    divides (ROADMAP C). Over all rows the multisets are equal bit for
    bit. No such particle occurs at this size; the test names any that
    does;
  * each run against a numpy replay of the push in f32 on the host from
    its own initial particles: the sorted multiset of valid (x, v) over
    all rows bit for bit (a comm scheme moves particles, it changes none);
  * `_merge_in`, `_compact`, `_push`, `_owner`, `init_particles`, the comm
    row's buckets and `histogram_positions`: bit for bit against the
    reference (the same values, and the same slot order from stable
    sorts).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO
from repro.apps import pic as jpic
from repro_torch.apps import pic as tpic

N_ROWS = 8
CFG = dict(capacity=1024, n_particles_total=1024, n_steps=3, dt=0.15)
WORK_ROWS = {"reference": 8, "decoupled": 7, "decoupled_io": 6}

JAX_CASES = """
import numpy as np
from repro.apps.pic import PICCfg, run_pic
from repro.utils.compat import make_mesh
mesh = make_mesh(({n},), ("data",))
cfg = PICCfg(**{cfg})
out = {{}}
for name, mode, io_alpha in {runs!r}:
    res = run_pic(mesh, mode, cfg, alpha=0.125, io_alpha=io_alpha)
    for key, val in zip(("x", "v", "m", "counts", "io_chunks"), res):
        out[name + "/" + key] = val
np.savez({outputs!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's {run/key}, the port's {run/key}), every array stacked by row."""
    tmp = tmp_path_factory.mktemp("pic")
    jax_out = str(tmp / "jax.npz")
    code = JAX_CASES.format(n=N_ROWS, cfg=json.dumps(CFG), runs=tpic.RUNS, outputs=jax_out)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={N_ROWS}",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        world = tpic.pic_world(tpic.PICCfg(**CFG), n_rows=N_ROWS, device="cpu")
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"JAX subprocess failed:\n{stdout}\n{stderr[-4000:]}")
    port = {f"{name}/{key}": val for name, res in world.items()
            for key, val in zip(("x", "v", "m", "counts", "io_chunks"), res)}
    return dict(np.load(jax_out)), port


RUN_NAMES = [name for name, _, _ in tpic.RUNS]


def _sorted_pairs(x, v, m):
    """The valid (x, v) as an (n, 2) array sorted by x, then v."""
    sel = m > 0
    pairs = np.stack([x[sel], v[sel]], axis=1)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


@pytest.mark.parametrize("name", RUN_NAMES)
def test_pic_counts_and_masks_match_jax(results, name):
    jax_out, port = results
    for key in ("counts", "m") + (("io_chunks",) if name == "decoupled_io" else ()):
        np.testing.assert_array_equal(port[f"{name}/{key}"], jax_out[f"{name}/{key}"])


@pytest.mark.parametrize("name", RUN_NAMES)
def test_pic_particles_match_jax_row_by_row(results, name):
    jax_out, port = results
    width = 1.0 / WORK_ROWS[name]
    p = [port[f"{name}/{k}"] for k in "xvm"]
    j = [jax_out[f"{name}/{k}"] for k in "xvm"]
    np.testing.assert_array_equal(_sorted_pairs(*p), _sorted_pairs(*j))
    off_edge = []
    for r in range(N_ROWS):
        got = {tuple(q) for q in _sorted_pairs(*(a[r] for a in p))}
        want = {tuple(q) for q in _sorted_pairs(*(a[r] for a in j))}
        for x, v in got ^ want:
            q = np.float32(x) / np.float32(width)
            if abs(q - np.round(q)) > 1e-6 * max(abs(q), 1.0):
                off_edge.append((r, x, v))
    assert not off_edge, f"particles on another row than JAX's, not at an edge: {off_edge[:5]}"


@pytest.mark.parametrize("name", RUN_NAMES)
def test_pic_conserves_and_owns(results, name):
    """Every step keeps all particles, and every valid particle lies on
    the row that owns its position (the compute rows only)."""
    _, port = results
    rows = WORK_ROWS[name]
    assert (port[f"{name}/counts"].sum(0) == CFG["n_particles_total"]).all()
    width = np.float32(1.0 / rows)
    for r in range(N_ROWS):
        m = port[f"{name}/m"][r] > 0
        owner = np.floor(port[f"{name}/x"][r][m] / width).astype(int)
        assert (owner == r).all() and (r < rows or not m.any()), (name, r)


def test_pic_io_service_buffers_every_step(results):
    """6 compute rows x 3 chunks x 3 steps on the io row, 0 elsewhere."""
    _, port = results
    assert port["decoupled_io/io_chunks"].tolist() == [0] * 7 + [54]


def _replay(cfg, work_rows):
    """The valid (x, v) after ``cfg.n_steps`` pushes of the run's initial
    particles, in f32 on the host (numpy)."""
    xs, vs, valid = tpic.init_particles(cfg, work_rows)
    x, v = xs[valid > 0], vs[valid > 0]
    dt, top = np.float32(cfg.dt), np.float32(cfg.domain - 1e-6)
    for _ in range(cfg.n_steps):
        x = x + v * dt * np.float32(1.0)
        v = np.where((x < 0) | (x > np.float32(cfg.domain)), -v, v)
        x = np.clip(x, np.float32(0.0), top)
    return _sorted_pairs(x, v, np.ones_like(x))


@pytest.mark.parametrize("name", RUN_NAMES)
def test_pic_comm_changes_no_particle(results, name):
    """The valid (x, v) over all rows are the host's f32 replay of the push
    from the run's own initial particles, bit for bit. (Runs on other
    compute-row counts start from other draws: `init_particles` splits the
    particles over the compute rows, as the reference's does.)"""
    _, port = results
    np.testing.assert_array_equal(_sorted_pairs(*(port[f"{name}/{k}"] for k in "xvm")),
                                  _replay(tpic.PICCfg(**CFG), WORK_ROWS[name]))


@pytest.mark.parametrize("name", RUN_NAMES)
def test_histogram_positions_match_jax(results, name):
    jax_out, port = results
    np.testing.assert_array_equal(
        tpic.histogram_positions(port[f"{name}/x"], port[f"{name}/m"], 16, 1.0),
        jpic.histogram_positions(jax_out[f"{name}/x"], jax_out[f"{name}/m"], 16, 1.0))


# -- single process ----------------------------------------------------------------

def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _buffers(rng, cap, fill, n_in):
    """A buffer with about ``fill`` of its slots valid (scattered), and
    ``n_in`` arrivals scattered over a buffer of the same capacity."""
    x = rng.uniform(0, 1, cap).astype(np.float32)
    v = rng.normal(size=cap).astype(np.float32)
    valid = (rng.uniform(size=cap) < fill).astype(np.float32)
    xin = rng.uniform(0, 1, cap).astype(np.float32)
    vin = rng.normal(size=cap).astype(np.float32)
    mask = np.zeros(cap, np.float32)
    mask[rng.permutation(cap)[:n_in]] = 1.0
    return x, v, valid, xin, vin, mask


@pytest.mark.parametrize("seed,fill,n_in", [(0, 0.3, 10), (1, 0.0, 64), (2, 1.0, 5),
                                            (3, 0.7, 30), (4, 0.5, 64), (5, 0.9, 0)])
def test_merge_in_matches_jax(seed, fill, n_in):
    """Slot for slot, the arrivals that overflow the capacity included
    (seeds 3, 2 and 4 bring more than the free slots)."""
    arrays = _buffers(np.random.default_rng(seed), 64, fill, n_in)
    got = tpic._merge_in(*_t(*arrays))
    want = jpic._merge_in(*_j(*arrays))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].sum() == min(64, arrays[2].sum() + n_in)


def test_compact_keeps_order_among_ties():
    rng = np.random.default_rng(6)
    valid = (rng.uniform(size=257) < 0.5).astype(np.float32)
    x = np.arange(257, dtype=np.float32)
    v = -x
    got = tpic._compact(*_t(x, v, valid))
    want = jpic._compact(*_j(x, v, valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n = int(valid.sum())
    assert (np.diff(got[0].numpy()[:n]) > 0).all() and (np.diff(got[0].numpy()[n:]) > 0).all()


@pytest.mark.parametrize("center", [None, 0.35])
def test_init_particles_bit_for_bit(center):
    cfg = tpic.PICCfg(capacity=512, n_particles_total=2000, skew=0.8)
    got = tpic.init_particles(cfg, 7, center=center)
    want = jpic.init_particles(jpic.PICCfg(**dataclasses.asdict(cfg)), 7, center=center)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_push_and_owner_match_jax():
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.05, 1.05, 4096).astype(np.float32)
    v = rng.normal(size=4096).astype(np.float32) * 3
    m = (rng.uniform(size=4096) < 0.8).astype(np.float32)
    got = tpic._push(*_t(x, v, m), 0.15, 1.0)
    want = jpic._push(*_j(x, v, m), 0.15, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    width = 1.0 / 7
    owner = tpic._owner(got[0], width).numpy()
    np.testing.assert_array_equal(owner, np.floor(got[0].numpy() / np.float32(width)))
    np.testing.assert_array_equal(owner, np.asarray(jpic._owner(want[0], width)))


def test_buckets_match_the_reference_per_destination():
    """The comm row's one stable sort by destination against the
    reference's stable sort per destination (`comm_decoupled`)."""
    rng = np.random.default_rng(8)
    n, cap = 5, 96
    m = (rng.uniform(size=(n, cap)) < 0.4).astype(np.float32)
    dst = np.where(m > 0, rng.integers(0, n, size=(n, cap)), -1).astype(np.float32)
    m[0, :] = 1.0  # row 0 sends everything to destination 2: one bucket overflows
    dst[0, :] = 2.0
    table = {"x": rng.uniform(size=(n, cap)).astype(np.float32) * m,
             "v": rng.normal(size=(n, cap)).astype(np.float32) * m, "m": m, "dst": dst}
    got = tpic._buckets(torch.from_numpy(np.stack([table[k] for k in ("x", "v", "m", "dst")])),
                        list(range(n)), cap)
    tj = {k: jnp.asarray(a) for k, a in table.items()}
    for d in range(n):
        sel = (tj["dst"] == d) & (tj["m"] > 0)
        flat = {k: (tj[k] * sel).reshape(-1) for k in ("x", "v", "m")}
        order = jnp.argsort(-flat["m"])
        for i, k in enumerate(("x", "v", "m")):
            np.testing.assert_array_equal(got[d, i].numpy(), np.asarray(flat[k][order][:cap]))


def test_histogram_positions_matches_the_reference():
    rng = np.random.default_rng(9)
    x = rng.uniform(size=(4, 100)).astype(np.float32)
    m = (rng.uniform(size=(4, 100)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(tpic.histogram_positions(x, m, 10, 1.0),
                                  jpic.histogram_positions(x, m, 10, 1.0))


def test_pic_graph_refuses_unknown_mode():
    from repro_torch.launch.mesh import Mesh

    assert tpic.pic_graph(Mesh(n_rows=8, device="cpu"), "reference", 0.125, 0.0) is None
    with pytest.raises(ValueError, match="not in"):
        tpic.pic_graph(Mesh(n_rows=8, device="cpu"), "ring", 0.125, 0.0)
