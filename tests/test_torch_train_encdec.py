"""PyTorch port, training the encoder-decoder family on the rank world:
the whisper-small smoke config in f32 (its 32 frames from the pipeline)
through `make_step` and `Trainer` in an 8-row gloo world on the CPU, in
each step mode, against the reference's `make_jitted_step` on an (8, 1)
mesh of fake devices, on the same parameters and batches
(tests/train_family_common.py runs both); ``runtime_skip=False``,
``zero1=False``, and a crash, resume and one-row elastic restore with its
``enc_layers`` and ``dec_layers`` through the checkpoint, whose files the
reference reads.

Tolerances: tests/train_family_common.py.
"""
import pytest

import train_family_common as common

CASES = [
    dict(label="whisper-16", name="whisper-small", seq=16, batch=8, sgd=common.MODES,
         adamw=common.MODES, runtime_skip=True, zero1=True, crash=True),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return common.run_both(tmp_path_factory.mktemp("train_encdec"), CASES)


@pytest.mark.parametrize("mode", common.MODES)
def test_sgd_step_matches_jax(world, mode):
    common.check_sgd(world, CASES, "whisper-16", mode)


@pytest.mark.parametrize("mode", common.MODES)
def test_trainer_losses_match_jax(world, mode):
    common.check_trainer(world, "whisper-16", mode)


def test_runtime_skip_off_matches_jax(world):
    common.check_runtime_skip(world, CASES, "whisper-16")


def test_zero1_off_matches_jax(world):
    common.check_zero1_off(world, CASES, "whisper-16")


def test_crash_resume_and_elastic_restore(world):
    common.check_crash_resume(world, CASES, "whisper-16")
