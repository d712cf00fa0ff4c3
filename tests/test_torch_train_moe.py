"""PyTorch port, training the MoE family on the rank world: the
mixtral-8x7b and llama4-scout-17b-a16e smoke configs in f32 through
`make_step` and `Trainer` in an 8-row gloo world on the CPU, against the
reference's `make_jitted_step` on an (8, 1) mesh of fake devices, on
the same parameters and batches (tests/train_family_common.py runs both).

The reference's conventional and overlap steps are one program over the
global batch, so an MoE layer groups the global token stream and takes
``aux_loss`` over it; the port's rows route their shards over the world
(`models.moe.RouteWorld`). Here 8 sequences of 16 tokens: one routing
group of 128 straddles every row (tests/test_torch_train_moe_groups.py
has the shape where each row's shard is whole groups). Per-row routing
of the same shards misses the reference's step by far. The decoupled step routes per compute row, as the
reference's ``shard_map`` does. ``runtime_skip=False``, ``zero1=False``
and a crash, resume and one-row elastic restore run on mixtral.

Tolerances: tests/train_family_common.py.
"""
import pytest

import train_family_common as common

CASES = [
    dict(label="mixtral-16", name="mixtral-8x7b", seq=16, batch=8, sgd=common.MODES,
         adamw=common.MODES, per_row=True, runtime_skip=True, zero1=True, crash=True),
    dict(label="llama4-16", name="llama4-scout-17b-a16e", seq=16, batch=8, sgd=common.MODES,
         adamw=common.MODES, per_row=True),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return common.run_both(tmp_path_factory.mktemp("train_moe"), CASES)


@pytest.mark.parametrize("label,mode", [(c["label"], m) for c in CASES for m in c["sgd"]])
def test_sgd_step_matches_jax(world, label, mode):
    common.check_sgd(world, CASES, label, mode)


@pytest.mark.parametrize("label,mode", [(c["label"], m) for c in CASES for m in c["adamw"]])
def test_trainer_losses_match_jax(world, label, mode):
    common.check_trainer(world, label, mode)


@pytest.mark.parametrize("label", [c["label"] for c in CASES if c.get("per_row")])
def test_per_row_routing_is_not_the_reference(world, label):
    common.check_per_row_routing_fails(world, CASES, label)


def test_runtime_skip_off_matches_jax(world):
    common.check_runtime_skip(world, CASES, "mixtral-16")


def test_zero1_off_matches_jax(world):
    common.check_zero1_off(world, CASES, "mixtral-16")


def test_crash_resume_and_elastic_restore(world):
    common.check_crash_resume(world, CASES, "mixtral-16")
