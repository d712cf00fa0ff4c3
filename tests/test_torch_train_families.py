"""PyTorch port, training the hybrid and VLM families on the rank world:
the hymba-1.5b and pixtral-12b smoke configs in f32 through `make_step`
and `Trainer` in an 8-row gloo world on the CPU, in each step mode,
against the reference's `make_jitted_step` on an (8, 1) mesh of fake
devices, on the same parameters and batches (pixtral's 16 patch
embeddings from the pipeline before 16 text tokens;
tests/train_family_common.py runs both). The encoder-decoder is in
tests/test_torch_train_encdec.py, the MoE in tests/test_torch_train_moe.py.

Tolerances: tests/train_family_common.py.
"""
import pytest

import train_family_common as common

CASES = [
    dict(label="hymba-16", name="hymba-1.5b", seq=16, batch=8, sgd=common.MODES,
         adamw=common.MODES),
    dict(label="pixtral-16", name="pixtral-12b", seq=16, batch=8, sgd=common.MODES,
         adamw=common.MODES),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return common.run_both(tmp_path_factory.mktemp("train_families"), CASES)


@pytest.mark.parametrize("label,mode", [(c["label"], m) for c in CASES for m in c["sgd"]])
def test_sgd_step_matches_jax(world, label, mode):
    common.check_sgd(world, CASES, label, mode)


@pytest.mark.parametrize("label,mode", [(c["label"], m) for c in CASES for m in c["adamw"]])
def test_trainer_losses_match_jax(world, label, mode):
    common.check_trainer(world, label, mode)
