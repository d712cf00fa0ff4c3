"""PyTorch port, the decoupling layer: `GroupedMesh`, `StreamChannel`
(`stream_fold`, `stream_fold_tree` in every schedule, wave fold and
codec), `stream_reduce(_and_return)` and the group collectives, in an
8-rank gloo world on the CPU (`repro_torch.launch.mesh.spawn`), against
the same functions of the JAX package under `shard_map` on 8 fake CPU
devices (6 compute rows, 2 reduce rows: 3 waves), on the same numpy
inputs. One JAX subprocess and one world run every case; each test
checks one of them.

Tolerances: identity and bf16 wires 1e-6 relative (the same decoded
values summed in the same wave order); the int8 wire within one
quantisation step per arriving wave (3 waves x max|x| / 127): the
reference under `jit` may quantise an element on a rounding edge one
step away (ROADMAP C, `kv_quantize`). In the port the "kernel", "add"
and "scan" wave folds agree bit for bit, as in the reference.
"""
import json

import numpy as np
import pytest
import torch

from repro.core.groups import GroupedMesh as JGroupedMesh
from repro_torch.core.channel import make_channel
from repro_torch.core.groups import GroupedMesh
from repro_torch.launch.mesh import Mesh, spawn
from torch_worlds import ALPHA, N_ROWS, TREE_VARIANTS, channel_cases

SERVICES = [{}, {"reduce": 1 / 8}, {"reduce": 0.25}, {"reduce": 0.3}, {"reduce": 0.5},
            {"reduce": 1 / 8, "io": 1 / 8}, {"reduce": 0.2, "analytics": 0.1}]

JAX_CASES = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import GroupedMesh, make_channel, stream_reduce, stream_reduce_and_return
from repro.core.decouple import conventional_allreduce, group_pmax, group_psum
from repro.utils.compat import make_mesh, shard_map
inp = dict(np.load({inputs!r}))
variants = json.loads({variants!r})
mesh = make_mesh(({n},), ("data",))
gm = GroupedMesh.build(mesh, services={{"reduce": {alpha}}})
ch = make_channel(gm, "reduce")

def run(body, *args):
    def inner(*a):
        out = body(*[jax.tree.map(lambda v: v[0], x) for x in a])
        return jax.tree.map(lambda y: y[None], out)
    f = jax.jit(shard_map(inner, mesh, tuple(P("data") for _ in args), P("data")))
    return f(*args)

def op(acc, elem, k):
    return acc.at[k].add(elem * (k + 1))

x = jnp.asarray(inp["x"])
out = {{}}
out["fold"] = run(lambda v: ch.stream_fold(v, op, jnp.zeros_like(v)), x)
out["fold_count"] = run(lambda v, c: ch.stream_fold(v, op, jnp.zeros_like(v), count=c),
                        x, jnp.asarray(inp["count"]))
out["fold_int8"] = run(lambda v: ch.stream_fold(v, op, jnp.zeros_like(v), codec="int8"), x)
out["reduce"] = run(lambda v: stream_reduce(v, ch), x)
out["reduce_return"] = run(lambda v: stream_reduce_and_return(v, ch, transform=lambda r: r * 2.0), x)
out["psum_reduce"] = run(lambda v: group_psum(v, gm, "reduce"), x)
out["pmax_compute"] = run(lambda v: group_pmax(v, gm, "compute"), x)
out["allreduce"] = run(lambda v: conventional_allreduce(v, gm), x)
payload = {{"a": jnp.asarray(inp["a"]), "b": jnp.asarray(inp["b"]),
           "c": jnp.asarray(inp["c"]).astype(jnp.bfloat16)}}

def max_combine(acc, new, ok):
    return jax.tree.map(lambda a, b: jnp.where(ok, jnp.maximum(a, b), a), acc, new)

for name, chunk_bytes, codec, wave_fold, generic in variants:
    got = run(lambda p: ch.stream_fold_tree(p, codec=codec, chunk_bytes=chunk_bytes,
                                            wave_fold=wave_fold,
                                            combine=max_combine if generic else None), payload)
    for k, v in got.items():
        out[f"tree_{{name}}_{{codec}}_{{k}}"] = v
np.savez({outputs!r}, **{{k: np.asarray(v, np.float32) for k, v in out.items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both packages' outputs of every case, and the inputs."""
    from conftest import run_multidevice

    tmp = tmp_path_factory.mktemp("channel")
    rng = np.random.default_rng(0)
    inputs = {"x": rng.normal(size=(N_ROWS, 4, 16)).astype(np.float32),
              "count": np.array([1, 4, 2, 3, 4, 1, 2, 3], np.int32),
              "a": rng.normal(size=(N_ROWS, 5, 7)).astype(np.float32),
              "b": (rng.normal(size=(N_ROWS, 33)) * 30).astype(np.float32),
              # bf16-representable, so both packages start from the same bf16
              "c": rng.normal(size=(N_ROWS, 6)).astype(np.float32).view(np.uint32)
              .__and__(np.uint32(0xFFFF0000)).view(np.float32)}
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    jax_out = str(tmp / "jax.npz")
    run_multidevice(JAX_CASES.format(inputs=path, outputs=jax_out, n=N_ROWS, alpha=ALPHA,
                                     variants=json.dumps(TREE_VARIANTS)),
                    n_devices=N_ROWS, timeout=300)
    port = spawn(channel_cases, N_ROWS, device="cpu", args=(path,), timeout_s=180)
    return inputs, dict(np.load(jax_out)), {k: np.stack([r[k] for r in port]) for k in port[0]}


def test_grouped_mesh_rows_match_jax():
    for n in (4, 8, 16):
        for services in SERVICES:
            try:
                want = JGroupedMesh.build(_FakeJaxMesh(n), services=services)
            except ValueError:
                with pytest.raises(ValueError):
                    GroupedMesh.build(Mesh(n_rows=n, device="cpu"), services=services)
                continue
            got = GroupedMesh.build(Mesh(n_rows=n, device="cpu"), services=services)
            assert [(g.name, g.start, g.stop) for g in got.groups] == \
                [(g.name, g.start, g.stop) for g in want.groups]
            for g in got.groups:
                assert got.alpha(g.name) == want.alpha(g.name)
                np.testing.assert_array_equal(got.role_mask(g.name), want.role_mask(g.name))
            assert got.describe() == want.describe()


def test_mesh_defaults_to_cuda_and_folds_only_on_its_device():
    """A Mesh runs on cuda unless the caller names another device (no
    GPU: an error, never a quiet CPU mesh); a fold refuses a payload on
    another device than the mesh's, so gradients on the card are never
    folded on the CPU."""
    assert Mesh(n_rows=2, device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh(n_rows=2)
    channel = make_channel(GroupedMesh.build(Mesh(n_rows=2, device="meta"),
                                             services={"reduce": 0.5}), "reduce")
    payload = {"w": torch.ones(4, 3)}
    for kw in ({}, {"chunk_bytes": 16}):
        with pytest.raises(ValueError, match="build the Mesh on the payload's device"):
            channel.stream_fold_tree(payload, **kw)
    with pytest.raises(ValueError, match="build the Mesh on the payload's device"):
        channel.stream_fold(torch.ones(2, 3), lambda acc, x, k: acc, None)


class _FakeJaxMesh:
    """The reference's `GroupedMesh` reads only ``mesh.shape[axis]``."""

    def __init__(self, n):
        self.shape = {"data": n}


FOLDS = ["fold", "fold_count", "fold_int8", "reduce", "reduce_return", "psum_reduce",
         "pmax_compute", "allreduce"]


@pytest.mark.parametrize("case", FOLDS)
def test_stream_fold_and_collectives_match_jax(results, case):
    inputs, jax_out, port = results
    want, got = jax_out[case], port[case]
    assert got.shape == want.shape
    if case == "fold_int8":
        step = np.abs(inputs["x"]).max() / 127 * 4  # 3 waves, k + 1 <= 4
        assert np.abs(got - want).max() <= step * 3
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", TREE_VARIANTS, ids=lambda v: f"{v[0]}-{v[2]}")
def test_stream_fold_tree_matches_jax(results, variant):
    inputs, jax_out, port = results
    name, _, codec, _, _ = variant
    for leaf in ("a", "b", "c"):
        key = f"tree_{name}_{codec}_{leaf}"
        want, got = jax_out[key], port[key]
        assert got.shape == want.shape
        if codec == "int8":
            step = np.abs(inputs[leaf]).max() / 127
            assert np.abs(got - want).max() <= 3 * step * (1 + 1e-6), key
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=key)
    # only the reducer rows fold anything
    assert not port[f"tree_{name}_{codec}_a"][:6].any()


@pytest.mark.parametrize("codec", ["identity", "bf16", "int8"])
def test_wave_folds_agree_bit_for_bit(results, codec):
    _, _, port = results
    for leaf in ("a", "b", "c"):
        kernel = port[f"tree_chunked_kernel_{codec}_{leaf}"]
        for other in ("add", "scan"):
            np.testing.assert_array_equal(port[f"tree_chunked_{other}_{codec}_{leaf}"], kernel)
        if codec == "identity":
            np.testing.assert_array_equal(port[f"tree_whole_identity_{leaf}"], kernel)
