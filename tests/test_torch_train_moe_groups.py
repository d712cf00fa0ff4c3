"""PyTorch port, training the MoE family on the rank world at the shape
where each row's shard is whole routing groups: 8 sequences of 1,024
tokens of the mixtral-8x7b and llama4-scout-17b-a16e smoke configs in
f32, one SGD step (lr 1) of the conventional and overlap steps in an
8-row gloo world on the CPU against the reference's `make_jitted_step`
on an (8, 1) mesh of fake devices (tests/train_family_common.py runs
both). Every row's routing is its own here, but ``aux_loss`` is still
the global batch's (a mean of products is not the product of means), so
per-row semantics miss the reference's step all the same. The shape
where a group straddles rows is in tests/test_torch_train_moe.py.

Tolerances: tests/train_family_common.py.
"""
import pytest

import train_family_common as common

CASES = [
    dict(label="mixtral-1024", name="mixtral-8x7b", seq=1024, batch=8,
         sgd=("conventional", "overlap"), adamw=(), per_row=True),
    dict(label="llama4-1024", name="llama4-scout-17b-a16e", seq=1024, batch=8,
         sgd=("conventional", "overlap"), adamw=(), per_row=True),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return common.run_both(tmp_path_factory.mktemp("train_moe_groups"), CASES)


@pytest.mark.parametrize("label,mode", [(c["label"], m) for c in CASES for m in c["sgd"]])
def test_sgd_step_matches_jax(world, label, mode):
    common.check_sgd(world, CASES, label, mode)


@pytest.mark.parametrize("label", [c["label"] for c in CASES])
def test_per_row_routing_is_not_the_reference(world, label):
    common.check_per_row_routing_fails(world, CASES, label)
