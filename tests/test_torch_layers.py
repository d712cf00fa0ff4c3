"""PyTorch port, layer ops: each `repro_torch.models.layers` function
against its `repro.models.layers` counterpart on the same numpy inputs,
in f32 on the CPU; plus the port's import hygiene.

Tolerance: 1e-5 absolute and relative for f32 ops. Both sides compute in
f32 on the CPU; only the summation order of matmuls and reductions
differs (XLA vs ATen), which moves results by a few ulps.
"""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl
from repro_torch.utils.convert import tensor_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    r = _rng(1)
    x = r.normal(size=(2, 5, 16)).astype(np.float32)
    p = {"w": r.normal(size=(16, 8)).astype(np.float32)}
    if bias:
        p["b"] = r.normal(size=(8,)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(tl.linear(tp, torch.from_numpy(x), torch.float32),
           jl.linear({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.float32))


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_apply_norm(kind):
    r = _rng(2)
    x = r.normal(size=(3, 4, 32)).astype(np.float32) * 3
    p = {"scale": r.normal(size=(32,)).astype(np.float32)}
    if kind == "ln":
        p["bias"] = r.normal(size=(32,)).astype(np.float32)
    got = tl.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), kind)
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    _close(got, want)


def test_apply_norm_keeps_bf16():
    x = torch.randn(2, 16).to(torch.bfloat16)
    y = tl.apply_norm({"scale": torch.ones(16)}, x, "rms")
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("ragged", [False, True])
def test_apply_rope(ragged):
    r = _rng(3)
    x = r.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = (r.integers(0, 500, size=(2, 6)) if ragged else np.arange(6)).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [0, 3])
def test_causal_window_mask(window):
    q = np.arange(5, 12)
    k = np.arange(12)
    got = tl.causal_window_mask(torch.from_numpy(q), torch.from_numpy(k), window)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jl.causal_window_mask(jnp.asarray(q), jnp.asarray(k), window)))


@pytest.mark.parametrize("window", [0, 4])
def test_attention_plain(window):
    r = _rng(4)
    q = r.normal(size=(2, 9, 8, 16)).astype(np.float32)
    k = r.normal(size=(2, 9, 2, 16)).astype(np.float32)
    v = r.normal(size=(2, 9, 2, 16)).astype(np.float32)
    pos = np.arange(9)
    tm = tl.causal_window_mask(torch.from_numpy(pos), torch.from_numpy(pos), window)
    jm = jl.causal_window_mask(jnp.asarray(pos), jnp.asarray(pos), window)
    _close(tl.attention_plain(*map(torch.from_numpy, (q, k, v)), tm, 0.25),
           jl.attention_plain(*map(jnp.asarray, (q, k, v)), jm, 0.25))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("cache_bf16", [False, True])
def test_attention_decode(window, cache_bf16):
    """GQA decode against a flattened cache; a bf16 cache under an f32
    query promotes to f32, as in the reference."""
    r = _rng(5)
    q = r.normal(size=(3, 1, 8, 16)).astype(np.float32)
    kc = r.normal(size=(3, 20, 32)).astype(np.float32)
    vc = r.normal(size=(3, 20, 32)).astype(np.float32)
    vl = np.array([1, 12, 20], np.int32)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    if cache_bf16:
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    got = tl.attention_decode(torch.from_numpy(q), tk, tv, 2, torch.from_numpy(vl), window, 0.25)
    want = jl.attention_decode(jnp.asarray(q), jk, jv, 2, jnp.asarray(vl), window, 0.25)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_apply_mlp(kind):
    r = _rng(6)
    x = r.normal(size=(2, 3, 16)).astype(np.float32)
    names = ["w_gate", "w_up", "w_down"] if kind == "swiglu" else ["w_up", "w_down"]
    p = {}
    for n in names:
        shape = (32, 16) if n == "w_down" else (16, 32)
        p[n] = {"w": r.normal(size=shape).astype(np.float32) / 4,
                "b": r.normal(size=shape[1:]).astype(np.float32)}
    tp = {n: {k: torch.from_numpy(v) for k, v in d.items()} for n, d in p.items()}
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}
    _close(tl.apply_mlp(tp, torch.from_numpy(x), kind, torch.float32),
           jl.apply_mlp(jp, jnp.asarray(x), kind, jnp.float32), atol=1e-4, rtol=1e-4)


def test_embed_unembed():
    r = _rng(7)
    table = r.normal(size=(50, 16)).astype(np.float32)
    tok = r.integers(0, 50, size=(2, 5))
    x = r.normal(size=(2, 5, 16)).astype(np.float32)
    _close(tl.embed({"table": torch.from_numpy(table)}, torch.from_numpy(tok), torch.float32),
           jl.embed({"table": jnp.asarray(table)}, jnp.asarray(tok), jnp.float32))
    _close(tl.unembed({"table": torch.from_numpy(table)}, torch.from_numpy(x), torch.float32),
           jl.unembed({"table": jnp.asarray(table)}, jnp.asarray(x), jnp.float32))


def test_sinusoidal():
    pos = np.array([0, 3, 17, 250], np.int32)
    got = tl.sinusoidal_at(torch.from_numpy(pos), 32)
    for i, p in enumerate(pos):
        _close(got[i], jl.sinusoidal_at(jnp.int32(p), 32), atol=1e-4, rtol=1e-4)
    _close(tl.sinusoidal_positions(9, 32), jl.sinusoidal_positions(9, 32))


def test_tensor_from_numpy_bf16_bits():
    import ml_dtypes

    a = np.random.default_rng(8).normal(size=(4, 5)).astype(ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


# -- import hygiene -------------------------------------------------------------


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_reference():
    bad, seen = [], set()
    for path in _port_files():
        seen.add(os.path.relpath(path, REPO))
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {m}")
    assert not bad, bad
    assert {"src/repro_torch/serve/spec.py", "src/repro_torch/utils/prng.py",
            "src/repro_torch/serve/disagg.py", "src/repro_torch/serve/fleet.py",
            "src/repro_torch/serve/checkpoint_bridge.py", "chip_smoke.py"} <= seen


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
