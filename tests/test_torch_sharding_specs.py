"""PyTorch port, the model axis's parameter specs: `train.sharding.param_specs`
against the reference's `param_specs` on all ten architectures at full
size, from shapes alone (the reference's tree through ``jax.eval_shape``,
the port's as ``meta`` tensors), at model axes of 2, 4 and 16, and with
the reference's ``REPRO_REPLICATE_SSM`` branch (the port's
``replicate_ssm`` keyword). The reference evaluates its rule on stacked
``(L, ...)`` layer leaves: the port's rule on the stacked name and shape
(`spec_for_leaf`) equals them leaf for leaf, and its spec of a layer
leaf is that spec
without its leading entry, which is None for every leaf but llama4's
stacked shared expert ``w_gate``/``w_up`` (its ``L`` stands where the
rule looks for the expert dimension): there the port's rule
(`spec_list`) shards ff, the last dimension, as the rule does where ``L``
does not divide the axis. Then the slicing helpers on a small tree:
`shard_model` takes each column's slice, and the columns' slices
concatenate back to the whole leaf. No world."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.models import build as j_build
from repro.train import sharding as j_sharding
from repro_torch.configs import get
from repro_torch.configs.base import REGISTRY
from repro_torch.models.model_zoo import build
from repro_torch.train import sharding
from repro_torch.train.train_step import param_shapes

SIZES = (2, 4, 16)


def _reference(name: str, model_size: int) -> dict:
    like = jax.eval_shape(j_build(j_get(name)).init, jax.random.PRNGKey(0))
    specs = j_sharding.param_specs(like, model_size)
    return like, specs


def _at(tree, names):
    for k in names:
        tree = tree[k]
    return tree


def _compare(name: str, model_size: int, replicate_ssm: bool = False) -> int:
    like, ref = _reference(name, model_size)
    shapes = param_shapes(build(get(name), device="meta"))
    ours = sharding.spec_list(shapes, model_size, replicate_ssm=replicate_ssm)
    paths = sharding._leaf_paths(shapes)
    leaves = jax.tree.leaves(shapes)
    assert len(ours) == len(paths) == len(leaves)
    n_sharded = 0
    for (names, depth), leaf, spec in zip(paths, leaves, ours):
        stack = () if depth is None else (depth,)
        full = sharding.spec_for_leaf(names, stack + tuple(leaf.shape), model_size,
                                      replicate_ssm=replicate_ssm)
        ref_leaf, ref_spec = _at(like, names), _at(ref, names)
        nd = len(ref_leaf.shape)
        want = tuple(ref_spec) + (None,) * (nd - len(tuple(ref_spec)))
        assert full == want, (name, model_size, names, full, want)
        if depth is not None:
            assert tuple(ref_leaf.shape) == (depth,) + tuple(leaf.shape), names
            if full[0] is None:
                assert spec == full[1:]
            else:
                # only llama4's stacked shared expert w_gate/w_up shards its L, which no
                # per-layer spec says: the port's rule shards its ff (last) dimension
                assert (name, names[:3], names[-2]) in {
                    ("llama4-scout-17b-a16e", ("layers", "moe", "shared"), k)
                    for k in ("w_gate", "w_up")}, (names, full)
                assert spec == (None,) * (len(spec) - 1) + ("model",)
        else:
            assert tuple(ref_leaf.shape) == tuple(leaf.shape), names
            assert spec == full
        n_sharded += sharding.model_dim(full) is not None
    return n_sharded


@pytest.mark.parametrize("model_size", SIZES)
@pytest.mark.parametrize("name", list(REGISTRY))
def test_param_specs_are_the_reference_specs(name, model_size):
    """Every leaf's spec equals the reference's for the stacked leaf, on
    the full-size config; some leaf shards at every size."""
    assert _compare(name, model_size) > 0


@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b"])
def test_replicate_ssm_is_the_reference_branch(name, monkeypatch):
    """With the reference's variable set, its SSM leaves stay whole; the
    port's keyword gives the same specs (the port reads no variable)."""
    monkeypatch.setenv("REPRO_REPLICATE_SSM", "1")
    _compare(name, 2, replicate_ssm=True)
    shapes = param_shapes(build(get(name), device="meta"))
    on = sharding.spec_list(shapes, 2, replicate_ssm=True)
    off = sharding.spec_list(shapes, 2)
    assert on != off


@pytest.mark.parametrize("model_size", SIZES)
def test_shard_model_slices_and_reassembles(model_size):
    """Each column's slice of each leaf has the leaf's shape with the
    spec's dimension divided; the columns' slices concatenate to the leaf;
    a whole leaf is passed through; numpy arrays slice alike."""
    gen = torch.Generator().manual_seed(0)
    tree = {"embed": {"table": torch.randn(64, 32, generator=gen)},
            "layers": [{"attn": {"wq": {"w": torch.randn(32, 48, generator=gen),
                                        "b": torch.randn(48, generator=gen)},
                                 "wo": {"w": torch.randn(48, 32, generator=gen),
                                        "b": torch.randn(32, generator=gen)}},
                        "norm1": {"scale": torch.ones(32)}}] * 2}
    specs = sharding.spec_list(tree, model_size)
    leaves = jax.tree.leaves(tree)
    cols = [sharding.shard_model(tree, specs, model_size, c) for c in range(model_size)]
    for i, (leaf, spec) in enumerate(zip(leaves, specs)):
        d = sharding.model_dim(spec)
        parts = [jax.tree.leaves(c)[i] for c in cols]
        if d is None:
            assert all(p is leaf for p in parts)
            continue
        assert all(p.shape[d] * model_size == leaf.shape[d] and p.is_contiguous()
                   for p in parts)
        assert torch.equal(torch.cat(parts, dim=d), leaf)
        np_parts = [sharding.model_shard(leaf.numpy(), spec, model_size, c)
                    for c in range(model_size)]
        assert np.array_equal(np.concatenate(np_parts, axis=d), leaf.numpy())
