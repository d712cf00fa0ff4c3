"""PyTorch port, the CG Poisson solver (`apps/cg.py`) in its three halo
modes, at the reference test's size (`CGCfg(nx_local=14, ny=12, nz=12,
n_iters=20)`, 8 rows, alpha 0.125, `tests/test_multidevice.py`): the
port's `cg_world` in an 8-rank gloo world on the CPU against the
reference's `run_cg` under `shard_map` on 8 fake CPU devices, run side by
side; and the stencil in one process against the reference's.

Tolerances, with their reasons:
  * history r.r per iteration: 1e-4 relative to JAX's, and u within 1e-4
    of max |u| (the same f32 arithmetic per cell; the dot products sum in
    another order, and the differences grow over the iterations; measured
    ~2e-6 and ~4e-7);
  * blocking and nonblocking inside the port: bit for bit (the same
    operations in the same order; only the waiting moves);
  * decoupled against blocking: sqrt of the history within 1e-3 relative,
    the reference test's bound (another slab split, so other sums);
  * the reported residual sqrt(r.r) against the true ||b - A u||
    recomputed in float64 on the host: 1e-4 relative (the recursive
    residual drifts from the true one by the f32 rounding of the u and r
    updates; measured ~2e-5 at most on grids of this x extent,
    `scripts/torch_cg_drift.py`);
  * the stencil alone: bit for bit against the reference (elementwise f32
    adds in the reference's order).
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
from repro.apps import cg as jcg
from repro_torch.apps import cg as tcg
from repro_torch.launch.mesh import Mesh

N_ROWS = 8
CFG = dict(nx_local=14, ny=12, nz=12, n_iters=20)
MODES = ("blocking", "nonblocking", "decoupled")

JAX_CASES = """
import dataclasses
import numpy as np
from repro.apps.cg import CGCfg, run_cg
from repro.utils.compat import make_mesh
mesh = make_mesh(({n},), ("data",))
out = {{}}
for mode in {modes!r}:
    u, res, hist = run_cg(mesh, CGCfg(**{cfg}, mode=mode), alpha=0.125)
    out[mode + "/u"], out[mode + "/res"], out[mode + "/hist"] = u, np.float64(res), hist
np.savez({outputs!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's {mode/u, mode/res, mode/hist}, the port's {mode: (u, res, hist)})."""
    tmp = tmp_path_factory.mktemp("cg")
    jax_out = str(tmp / "jax.npz")
    code = JAX_CASES.format(n=N_ROWS, modes=MODES, cfg=json.dumps(CFG), outputs=jax_out)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={N_ROWS}",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = tcg.cg_world(tcg.CGCfg(**CFG), MODES, n_rows=N_ROWS, device="cpu")
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"JAX subprocess failed:\n{stdout}\n{stderr[-4000:]}")
    return dict(np.load(jax_out)), port


@pytest.mark.parametrize("mode", MODES)
def test_cg_matches_jax(results, mode):
    jax_out, port = results
    u, res, hist = port[mode]
    assert u.shape == jax_out[mode + "/u"].shape
    np.testing.assert_allclose(hist, jax_out[mode + "/hist"], rtol=1e-4, atol=0)
    assert np.abs(u - jax_out[mode + "/u"]).max() <= 1e-4 * np.abs(jax_out[mode + "/u"]).max()
    assert abs(res - float(jax_out[mode + "/res"])) <= 1e-4 * res


@pytest.mark.parametrize("mode", MODES)
def test_cg_converges(results, mode):
    _, port = results
    hist = port[mode][2]
    assert hist.shape == (CFG["n_iters"],) and hist[-1] < hist[0]


def test_cg_blocking_equals_nonblocking_bit_for_bit(results):
    _, port = results
    for got, want in zip(port["nonblocking"], port["blocking"]):
        np.testing.assert_array_equal(got, want)


def test_cg_decoupled_agrees_with_blocking(results):
    _, port = results
    blocking = np.sqrt(port["blocking"][2])
    assert np.max(np.abs(np.sqrt(port["decoupled"][2]) - blocking) / blocking) < 1e-3


@pytest.mark.parametrize("mode", MODES)
def test_cg_reported_residual_is_the_true_residual(results, mode):
    """The same global right-hand side in every mode; the halo row's slab
    (decoupled) is padding and stays zero."""
    _, port = results
    u, res, _ = port[mode]
    cfg = tcg.CGCfg(**CFG)
    work = N_ROWS - 1 if mode == "decoupled" else N_ROWS
    b = tcg.cg_rhs(cfg, N_ROWS, N_ROWS).reshape(-1, cfg.ny, cfg.nz)
    true = tcg.residual_norm(u[:work].reshape(-1, cfg.ny, cfg.nz), b)
    assert abs(true - res) <= 1e-4 * res
    assert not u[work:].any()


# -- single process ----------------------------------------------------------------

def _slab(seed=0, shape=(14, 12, 12)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(14, 12, 12), (1, 5, 7), (3, 1, 4)])
def test_laplacian_inner_matches_jax(shape):
    u = _slab(1, shape)
    np.testing.assert_array_equal(tcg._laplacian_inner(torch.from_numpy(u)).numpy(),
                                  np.asarray(jcg._laplacian_inner(jnp.asarray(u))))


def test_apply_halo_matches_jax():
    lap, below, above = _slab(2), _slab(3, (12, 12)), _slab(4, (12, 12))
    got = tcg._apply_halo(torch.from_numpy(lap.copy()), torch.from_numpy(below),
                          torch.from_numpy(above))
    want = jcg._apply_halo(jnp.asarray(lap), jnp.asarray(below), jnp.asarray(above))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_neighbor_perms_match_jax():
    for rows in (range(8), range(0, 7), range(2, 3)):
        assert tcg._neighbor_perms(rows) == jcg._neighbor_perms(rows)


def test_cg_rhs_keeps_the_global_grid():
    """The decoupled mode spreads the same global grid over 7 compute rows
    and zero-pads the halo row's slab."""
    cfg = tcg.CGCfg(**CFG)
    full = tcg.cg_rhs(cfg, 8, 8)
    split = tcg.cg_rhs(cfg, 8, 7)
    assert full.shape == (8, 14, 12, 12) and split.shape == (8, 16, 12, 12)
    np.testing.assert_array_equal(split[:7].reshape(-1, 12, 12), full.reshape(-1, 12, 12))
    assert not split[7].any()
    with pytest.raises(ValueError, match="must divide"):
        tcg.cg_rhs(dataclasses.replace(cfg, nx_local=13), 8, 7)


def test_cg_graph_refuses_unknown_mode():
    with pytest.raises(ValueError, match="not in"):
        tcg.cg_graph(Mesh(n_rows=8, device="cpu"), "ring", 0.125)
