"""PyTorch port, the model axis (tensor parallelism by hand, the reference's
GSPMD ``model`` axis) for the SSM, hybrid, VLM and encoder-decoder
families: the f32 smoke configs of mamba2-130m (its Mamba blocks'
``in_proj`` and ``conv_w`` column-sharded, ``conv_b``, ``A_log``, ``D`` and
``dt_bias`` sharded on their heads or channels, ``out_proj`` row-sharded;
and in the ``replicate_ssm`` layout, the reference's
``REPRO_REPLICATE_SSM=1``), hymba-1.5b (attention, MLP and a Mamba block
side by side; and with one KV head, where the heads do not divide the
axis and the projections are gathered, as hymba-1.5b's 25 / 5 heads are
on the card), pixtral-12b (the dense layer after prepended patch
embeddings) and whisper-small (the encoder's, the decoder's and the
cross-attention's projections, the MLPs, a vocabulary-sharded table) on a
(data 2, model 2) world of four CPU ranks, against the reference's
``make_jitted_step`` and ``Trainer`` on ``make_host_mesh(2, 2)`` with 4
fake devices, run side by side in one JAX subprocess
(tests/model_axis_common.py); against the port's own step on a (2, 1)
world; and hymba's (2, 2) checkpoint restored onto (2, 1) and (1, 2)
worlds.

The port's decoupled step is held to the reference's conventional step on
the decoupled layout's batch (tests/test_torch_model_axis.py says why);
mamba2's streams its gradient in wire chunks and folds it with
`chunk_accumulate`'s wrapper, once on each column's reducer.

Tolerances (tests/train_family_common.py's): one SGD step (lr 1) within
1e-5 absolute of the reference's; the AdamW trainer's losses within 1e-5
relative. Against the one-column step, the (2, 2) step within `SELF_REL`
(1e-6) x max |gradient| leaf by leaf, but `EMBED_SELF_REL` (2e-6) for the
embedding table (see `EMBED_SELF_REL`); the ``replicate_ssm`` step within
the same of the default layout's. Each rank's stored leaves at step 0,
its column's slice of the reference's tree by the reference's
``param_specs`` (and FSDP's part of that slice), bit for bit; the
restored state against the files bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import train_family_common as common
from model_axis_common import (
    RESTORE_WORLDS,
    case_leaves,
    fsdp_parts,
    leaf_names,
    reference_slices,
    run_worlds,
)
from model_axis_worlds import CKPT_EVERY, DATA, MODES, case_config, run_tag, trains_adamw
from repro_torch.models.model_zoo import build
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import param_shapes
from repro_torch.utils.treeutil import tree_flatten

SELF_REL = 1e-6
# the same for the embedding table, the leaf into whose rows the model
# axis's f32 rounding (the vocabulary-parallel embedding and cross-entropy,
# the columns' sums of the row-parallel products and of the input gradients
# of the column-sharded ones) is summed over every position of a token, as
# for the MoE configs (tests/test_torch_model_axis.py, `MOE_SELF_REL`):
# hymba's step is off one column by 1.32e-6 of max |gradient| there (0.92e-6
# with its Mamba blocks whole on every column), pixtral's by 1.0e-6, and
# every other leaf of every case by at most 4.0e-7
# (`python tests/model_axis_floor.py` prints them)
EMBED_SELF_REL = 2e-6
EMBED_LEAF = "embed.table"
CASES = [
    dict(label="mamba2-16", name="mamba2-130m", seq=16, batch=8, modes=MODES, adamw=True,
         count_folds=True),
    dict(label="mamba2-repl-16", name="mamba2-130m", seq=16, batch=8,
         modes=("conventional",), replicate_ssm=True),
    dict(label="hymba-16", name="hymba-1.5b", seq=16, batch=8, modes=MODES, fsdp=True,
         adamw=True, adamw_whole=True),
    dict(label="hymba-kv1-16", name="hymba-1.5b", n_kv_heads=1, seq=16, batch=8, modes=MODES),
    dict(label="pixtral-16", name="pixtral-12b", seq=16, batch=8, modes=MODES),
    dict(label="whisper-16", name="whisper-small", seq=16, batch=8, modes=MODES, fsdp=True,
         adamw=True, adamw_whole=True),
]
REPL_CASE, DEFAULT_CASE = CASES[1], CASES[0]
CKPT_CASE = CASES[2]  # hymba: its (2, 2) conventional AdamW run's files
FOLD_CASE = CASES[0]
RUNS = [(c, fsdp, m) for c in CASES for fsdp in ((False, True) if c.get("fsdp") else (False,))
        for m in c["modes"]]
RUN_IDS = [f"{c['label']}-{'fsdp' if f else 'whole'}-{m}" for c, f, m in RUNS]
ADAMW_RUNS = [(r, i) for r, i in zip(RUNS, RUN_IDS) if trains_adamw(r[0], r[1])]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's runs in one JAX subprocess beside the port's (2, 2)
    world, then the (2, 1) and (1, 2) worlds restoring hymba's checkpoint."""
    return run_worlds(tmp_path_factory.mktemp("model_axis_families"), CASES,
                      restores=((CKPT_CASE, run_tag(CKPT_CASE, False, "conventional")),))


def _p0(world, case: dict) -> list:
    return case_leaves(world["p0"], case, f"{case['label']}/p0/")


# -- against the reference ----------------------------------------------------------

@pytest.mark.parametrize("case,fsdp,mode", RUNS, ids=RUN_IDS)
def test_sgd_step_matches_jax(world, case, fsdp, mode):
    """Every rank's whole new parameters within 1e-5 of the reference's
    (2, 2) step, with its loss; FSDP resolves as asked; the step moved the
    parameters and went through the model axis's collectives."""
    jax_out, port = world["jax"], world["port"]
    tag = run_tag(case, fsdp, mode)
    want = case_leaves(jax_out, case, f"{tag}/sgd/new/")
    assert common.max_diff(_p0(world, case), want) > 1e-3  # it moved
    for rank in port:
        assert bool(rank[f"{tag}/sgd/fsdp_on"]) == fsdp
        got = common.port_leaves(rank, f"{tag}/sgd/new/")
        assert common.max_diff(got, want) <= common.SGD_ATOL, int(rank["rank"])
        assert float(rank[f"{tag}/sgd/loss"]) == pytest.approx(
            float(jax_out[f"{tag}/sgd/loss"]), rel=common.LOSS_REL)
        assert int(rank[f"{tag}/sgd/model_collectives"]) > 0


@pytest.mark.parametrize("case,fsdp,mode", [r for r, _ in ADAMW_RUNS],
                         ids=[i for _, i in ADAMW_RUNS])
def test_trainer_losses_match_jax(world, case, fsdp, mode):
    want = world["jax"][f"{run_tag(case, fsdp, mode)}/adamw/loss"]
    assert len(want) == 3 and np.isfinite(want).all()
    for rank in world["port"]:
        np.testing.assert_allclose(rank[f"{run_tag(case, fsdp, mode)}/adamw/loss"], want,
                                   rtol=common.LOSS_REL)


# -- against the port's own steps ---------------------------------------------------

def _within(got: list, want: list, gmax: float, names: list) -> None:
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        budget = EMBED_SELF_REL if name == EMBED_LEAF else SELF_REL
        assert float(np.abs(a - b).max()) <= budget * gmax, name


@pytest.mark.parametrize("case,mode", [(c, m) for c in CASES for m in c["modes"]],
                         ids=[f"{c['label']}-{m}" for c in CASES for m in c["modes"]])
def test_model_axis_step_matches_one_column(world, case, mode):
    """Every leaf of the (2, 2) step within `SELF_REL` x max |gradient| of
    the one-column step (the embedding table within `EMBED_SELF_REL`), on
    every rank."""
    tag = run_tag(case, False, mode)
    ref = common.port_leaves(world["restored"][(DATA, 1)][0], f"{tag}/sgd/new/")
    gmax = common.max_diff(_p0(world, case), ref)
    for rank in world["port"]:
        _within(common.port_leaves(rank, f"{tag}/sgd/new/"), ref, gmax, leaf_names(case))


def test_replicate_ssm_matches_default_layout(world):
    """mamba2's step in the ``replicate_ssm`` layout (in_proj, conv, A_log
    and dt_bias whole on every column; D and out_proj split) within
    `SELF_REL` x max |gradient| of the default layout's, on every rank; its
    ranks hold more than the default layout's."""
    tag = run_tag(REPL_CASE, False, "conventional")
    for rank in world["port"]:
        want = common.port_leaves(rank, f"{run_tag(DEFAULT_CASE, False, 'conventional')}/sgd/new/")
        gmax = common.max_diff(_p0(world, DEFAULT_CASE), want)
        _within(common.port_leaves(rank, f"{tag}/sgd/new/"), want, gmax, leaf_names(REPL_CASE))
        held = [common.port_leaves(rank, f"{c['label']}/stored/") for c in (REPL_CASE, DEFAULT_CASE)]
        assert sum(x.size for x in held[0]) > sum(x.size for x in held[1])


def test_decoupled_step_folds_once_on_each_reducer(world):
    """mamba2's decoupled step streams its gradient slices in wire chunks:
    `chunk_accumulate`'s wrapper folds the one compute row's gradient once
    on each column's reducer row (the last row), never on a compute row;
    the ranks' losses are equal."""
    tag = run_tag(FOLD_CASE, False, "decoupled")
    port = world["port"]
    calls = {int(r["rank"]): int(r[f"{tag}/sgd/accumulate_calls"]) for r in port}
    assert calls == {int(r["rank"]): int(int(r["row"]) == DATA - 1) for r in port}
    assert len({float(r[f"{tag}/sgd/loss"]) for r in port}) == 1


# -- what each rank holds -------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[c["label"] for c in CASES])
def test_each_rank_holds_its_param_specs_slice(world, case):
    """At step 0 each rank's leaves are its column's slice of the whole
    tree by the reference's specs (under ``REPRO_REPLICATE_SSM=1`` for the
    ``replicate_ssm`` case), bit for bit: converted from the reference's
    tree, drawn by the trainer (against one process's ``model.init(0)``),
    and under FSDP its row's part of that slice; the rank holds less than
    the whole."""
    whole = _p0(world, case)
    drawn = [t.numpy() for t in tree_flatten(
        build(case_config(case), device="cpu").init(0, param_dtype=torch.float32))[0]]
    n_whole = sum(x.size for x in whole)
    ported = []
    reference_slices(case, whole, 0, ported)
    assert ported == []
    for rank in world["port"]:
        col = int(rank["col"])
        want = reference_slices(case, whole, col)
        got = common.port_leaves(rank, f"{case['label']}/stored/")
        assert len(got) == len(want) and all(a.tobytes() == b.tobytes()
                                             for a, b in zip(got, want))
        assert 0.5 * n_whole <= sum(x.size for x in got) < n_whole
        if case.get("adamw"):
            init = common.port_leaves(rank, f"{case['label']}/init/")
            assert all(a.tobytes() == b.tobytes()
                       for a, b in zip(init, reference_slices(case, drawn, col)))
        if case.get("fsdp"):
            assert fsdp_parts(case, want, int(rank["row"])).tobytes() == \
                rank[f"{run_tag(case, True, MODES[0])}/parts"].tobytes()


# -- checkpoints ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", RESTORE_WORLDS, ids=["2x1", "1x2"])
def test_restore_onto_another_world(world, shape):
    """hymba's (2, 2) run's step-2 files restored onto a (2, 1) and a
    (1, 2) world: gathered whole, the parameters and moments equal the
    files bit for bit; resumed, step 3's loss is the reference's within
    1e-5."""
    from repro_torch.io import checkpoint as ckpt

    tag = run_tag(CKPT_CASE, False, "conventional")
    label = CKPT_CASE["label"]
    shapes = param_shapes(build(case_config(CKPT_CASE), device="meta"))
    like = {"params": shapes, "opt": init_opt_state(OptConfig(), shapes), "step": 0}
    files = ckpt.restore(os.path.join(world["ckpt"], tag), CKPT_EVERY, like, device="cpu")
    want_loss = world["jax"][f"{tag}/adamw/loss"][CKPT_EVERY:]
    for out in world["restored"][shape]:
        assert int(out[f"{label}/restored_step"]) == CKPT_EVERY
        for k, tree in (("params", files["params"]), ("m", files["opt"]["m"]),
                        ("v", files["opt"]["v"])):
            want = [t.numpy() for t in tree_flatten(tree)[0]]
            got = common.port_leaves(out, f"{label}/restored/{k}/")
            assert len(got) == len(want) and all(a.tobytes() == b.tobytes()
                                                 for a, b in zip(got, want)), k
        assert int(out[f"{label}/resumed"]) == CKPT_EVERY
        np.testing.assert_allclose(out[f"{label}/loss"], want_loss, rtol=common.LOSS_REL)
