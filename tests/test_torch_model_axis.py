"""PyTorch port, the model axis (tensor parallelism by hand, the reference's
GSPMD ``model`` axis): the dense family's f32 smoke configs
(tinyllama-1.1b, qwen1.5-0.5b, qwen2.5-3b, starcoder2-15b, and tinyllama
with one KV head, where the heads do not divide the axis and the
projections are gathered) and the MoE family's (mixtral-8x7b, whose four
experts shard over the axis; llama4-scout-17b-a16e, top-1 with a shared
expert; mixtral with three experts, each expert's ff sharded and the
router whole) on a (data 2, model 2) world of four CPU ranks
(`model_axis_worlds.model_axis_cases`), against the reference's
``make_jitted_step`` and ``Trainer`` on ``make_host_mesh(2, 2)`` with 4
fake devices, run side by side in one JAX subprocess; against the port's
own step on a (2, 1) world; and a (2, 2) checkpoint restored onto (2, 1)
and (1, 2) worlds (`model_axis_worlds.restore_case`).

The reference's decoupled step does not run on a (2, 2) mesh of CPU
devices under jax 0.9.0: inside its ``shard_map`` (manual over ``data``)
its attention's sharding constraint (``layers.maybe_shard``) names the
manual data axis and raises where a row's batch divides the data axis,
and where it does not, XLA's CPU collective permute between the two
one-row groups waits for all four devices and aborts. So the port's
decoupled step is held to the reference's conventional step on the
decoupled layout's batch (every row padded, the reducer row's sequences
masked; the reference's Trainer reads it through ``Padded``), which is
what the reference's own test holds its decoupled step to
(tests/test_multidevice.py::test_decoupled_equals_conventional_grads,
1e-5). An MoE model's decoupled step routes its compute row's shard
alone, which that batch does not (the reducer row's masked sequences
route too), so it is held to the port's one-column decoupled step alone
(whose routing tests/test_torch_train_moe.py holds to the reference on data rows), with
`chunk_accumulate`'s wrapper called once on each column's reducer. The
ragged-tail layers: one MoE layer's forward and backward over 2 x 600
tokens (one routing group, then a tail of 176 tokens that expert 0 takes
whole), routed over the world, against the same layer in one process.

Tolerances (tests/train_family_common.py's): one SGD step (lr 1) within
1e-5 absolute of the reference's, with a binding clip too (``grad_clip``
0.05: a whole leaf counted once per column would move its norm); the AdamW
trainer's losses within 1e-5 relative. Against the one-column step, the
(2, 2) step within `SELF_REL` (1e-6) x max |gradient| leaf by leaf, but
`MOE_SELF_REL` (2e-6) for an MoE config's embedding table (see
`MOE_SELF_REL`; mixtral's step with its experts split is held bit for bit
to its step with the MoE whole on every column): the column sums of
the row-sharded products add the f32 terms in another order; the decoupled
step folds its one compute row's gradient on its reducer row in each
column, the same fold order as one column. Each rank's stored leaves at
step 0, its column's slice of the reference's tree by the reference's
``param_specs`` (and FSDP's part of that slice), bit for bit; the restored
state against the files bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_family_common as common
from model_axis_common import RESTORE_WORLDS, run_worlds
from model_axis_common import case_leaves as _case_leaves
from model_axis_common import leaf_names as _leaf_names
from model_axis_common import reference_slices as _reference_slices
from model_axis_common import unflatten_like as _unflatten_like
from model_axis_worlds import (
    CKPT_EVERY,
    CLIP,
    DATA,
    MODEL,
    MODES,
    TAIL_AUX,
    TAIL_BATCH,
    TAIL_LAYERS,
    TAIL_SEQ,
    case_config,
    run_tag,
    tail_layer,
    trains_adamw,
)
from repro.configs import get as j_get
from repro.models import build as j_build
from repro_torch.configs import get, get_smoke
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models.model_zoo import build
from repro_torch.train import sharding
from repro_torch.train.train_step import TrainStepConfig, param_shapes, use_fsdp
from repro_torch.utils.treeutil import tree_flatten
from torch_worlds import FAMILY_STEPS

SELF_REL = 1e-6
# the same for the embedding table of the MoE smoke configs, the one leaf
# whose f32 floor against one column passes SELF_REL (1.12e-6 of max
# |gradient| in mixtral's decoupled step, 1.02e-6 with three experts; the
# dense configs' 2.7e-7 to 5.2e-7, every other leaf of every config within
# 3.0e-7; tests/model_axis_floor.py prints them). The MoE's own split adds no rounding: the experts' layer is one
# process's bit for bit on the same inputs (`test_ragged_tail_matches_one_process`),
# and mixtral's (2, 2) step with its experts over the columns is bit for
# bit the step with the MoE whole on every column (`MOE_WHOLE_CASE`,
# `test_moe_split_adds_no_rounding`), whose floor it therefore is: the
# dense model-axis arithmetic (the vocabulary-parallel embedding and
# cross-entropy, the row-parallel attention output), summed into the
# embedding's rows over every position of a token
MOE_SELF_REL = 2e-6
EMBED_LEAF = "embed.table"
DENSE = ("tinyllama-1.1b", "qwen1.5-0.5b", "qwen2.5-3b", "starcoder2-15b")
CASES = [dict(label=f"{name}-16", name=name, seq=16, batch=8, modes=MODES, adamw=True,
              fsdp=name == "qwen2.5-3b", clip=name == "qwen2.5-3b") for name in DENSE] + [
    dict(label="tinyllama-kv1-16", name="tinyllama-1.1b", n_kv_heads=1, seq=16, batch=8,
         modes=MODES)]
MOE_CASES = [
    dict(label="mixtral-16", name="mixtral-8x7b", seq=16, batch=8, modes=MODES, adamw=True,
         fsdp=True, moe=True),
    dict(label="llama4-16", name="llama4-scout-17b-a16e", seq=16, batch=8, modes=MODES,
         moe=True),
    dict(label="mixtral-e3-16", name="mixtral-8x7b", n_experts=3, seq=16, batch=8,
         modes=("conventional", "overlap"), clip=True, moe=True)]
CASES += MOE_CASES
# mixtral with every MoE leaf whole on every column (`model_axis_worlds.moe_whole`),
# run by the (2, 2) world alone: its steps are held to mixtral's with the
# experts split over the columns, bit for bit
MOE_WHOLE_CASE = dict(MOE_CASES[0], label="mixtral-whole-16", adamw=False, fsdp=False,
                      moe_whole=True)
CKPT_CASE = CASES[2]  # qwen2.5-3b: its (2, 2) conventional AdamW run's files
MOE_CKPT_CASE = MOE_CASES[0]  # mixtral: the same
RUNS = [(c, fsdp, m) for c in CASES for fsdp in ((False, True) if c.get("fsdp") else (False,))
        for m in c["modes"]]
RUN_IDS = [f"{c['label']}-{'fsdp' if f else 'whole'}-{m}" for c, f, m in RUNS]
# the runs held to the reference: all but an MoE model's decoupled step
JAX_RUNS = [(r, i) for r, i in zip(RUNS, RUN_IDS) if not (r[0].get("moe") and r[2] == "decoupled")]
MOE_DECOUPLED = [(r, i) for r, i in zip(RUNS, RUN_IDS) if r[0].get("moe") and r[2] == "decoupled"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's runs in one JAX subprocess beside the port's (2, 2)
    world, then the (2, 1) and (1, 2) worlds restoring its checkpoint."""
    restores = tuple((c, run_tag(c, False, "conventional")) for c in (CKPT_CASE, MOE_CKPT_CASE))
    return run_worlds(tmp_path_factory.mktemp("model_axis"), CASES,
                      port_only=(MOE_WHOLE_CASE,), tails=TAIL_LAYERS, restores=restores)


# -- against the reference ----------------------------------------------------------

@pytest.mark.parametrize("case,fsdp,mode", [r for r, _ in JAX_RUNS], ids=[i for _, i in JAX_RUNS])
def test_sgd_step_matches_jax(world, case, fsdp, mode):
    """Every rank's whole new parameters within 1e-5 of the reference's
    (2, 2) step, with its loss; FSDP resolves as asked; the step moved the
    parameters and went through the model axis's collectives."""
    jax_out, port = world["jax"], world["port"]
    tag = run_tag(case, fsdp, mode)
    names = ("sgd", "clip") if case.get("clip") and not case.get("moe") else ("sgd",)
    p0 = _case_leaves(world["p0"], case, f"{case['label']}/p0/")
    for name in names:
        want = _case_leaves(jax_out, case, f"{tag}/{name}/new/")
        assert common.max_diff(p0, want) > 1e-3  # it moved
        for rank in port:
            assert bool(rank[f"{tag}/{name}/fsdp_on"]) == fsdp
            got = common.port_leaves(rank, f"{tag}/{name}/new/")
            assert common.max_diff(got, want) <= common.SGD_ATOL, (name, int(rank["rank"]))
            assert float(rank[f"{tag}/{name}/loss"]) == pytest.approx(
                float(jax_out[f"{tag}/{name}/loss"]), rel=common.LOSS_REL)
            assert int(rank[f"{tag}/{name}/model_collectives"]) > 0


@pytest.mark.parametrize("case,fsdp,mode", [r for r, _ in JAX_RUNS if trains_adamw(r[0], r[1])],
                         ids=[i for r, i in JAX_RUNS if trains_adamw(r[0], r[1])])
def test_trainer_losses_match_jax(world, case, fsdp, mode):
    want = world["jax"][f"{run_tag(case, fsdp, mode)}/adamw/loss"]
    assert len(want) == FAMILY_STEPS and np.isfinite(want).all()
    for rank in world["port"]:
        np.testing.assert_allclose(rank[f"{run_tag(case, fsdp, mode)}/adamw/loss"], want,
                                   rtol=common.LOSS_REL)


def _check_clip(world, case: dict, fsdp: bool, mode: str) -> None:
    """The clip run's update against the SGD run's, scaled by max_norm over
    the norm that counts each element once; off by far more when each
    whole leaf counts once per column."""
    p0 = _case_leaves(world["p0"], case, f"{case['label']}/p0/")
    shapes = param_shapes(build(case_config(case), device="meta"))
    whole = [sharding.model_dim(x) is None for x in sharding.spec_list(shapes, MODEL)]
    assert any(whole) and not all(whole)
    tag = run_tag(case, fsdp, mode)
    port = world["port"][0]
    g = [(a - b).astype(np.float64)
         for a, b in zip(p0, common.port_leaves(port, f"{tag}/sgd/new/"))]
    c = [(a - b).astype(np.float64)
         for a, b in zip(p0, common.port_leaves(port, f"{tag}/clip/new/"))]
    sq = [float(np.sum(x ** 2)) for x in g]
    once = np.sqrt(sum(sq))
    per_column = np.sqrt(sum(q * (MODEL if w else 1) for q, w in zip(sq, whole)))
    assert once > 4 * CLIP
    eps = float(np.finfo(np.float32).eps)

    def off(norm):
        """The worst leaf's miss over its budget: the f32 norm's rounding,
        and the update read back as p0 - new, which rounds at p0's ulp."""
        return max(float(np.abs(a * CLIP / norm - b).max())
                   / (1e-6 * float(np.abs(b).max()) + 4 * eps * float(np.abs(p).max()))
                   for a, b, p in zip(g, c, p0))

    assert off(once) <= 1
    assert off(per_column) > 10


@pytest.mark.parametrize("mode", MODES)
def test_clip_binds_and_counts_whole_leaves_once(world, mode):
    """The clip case's update is the unclipped one scaled (lr 1, no
    momentum) by max_norm over the whole gradient's norm, each element
    counted once; a norm that counted each whole leaf once per column
    would miss it by far more than the rounding."""
    for fsdp in (False, True):
        _check_clip(world, CKPT_CASE, fsdp, mode)


@pytest.mark.parametrize("mode", MOE_CASES[2]["modes"])
def test_clip_counts_the_whole_router_once(world, mode):
    """With three experts on two columns the router is whole on every
    column (and each expert's ff sharded): the clip counts it, the norms
    and every other whole leaf once."""
    case = MOE_CASES[2]
    shapes = param_shapes(build(case_config(case), device="meta"))
    specs = dict(zip([".".join(n) for n, _ in sharding._leaf_paths(shapes)],
                     sharding.spec_list(shapes, MODEL)))
    assert specs["layers.moe.router.w"] == (None, None)
    assert specs["layers.moe.w_gate"] == (None, None, "model")
    _check_clip(world, case, False, mode)


# -- against the port's one-column step ----------------------------------------------

@pytest.mark.parametrize("case,mode", [(c, m) for c in CASES for m in c["modes"]],
                         ids=[f"{c['label']}-{m}" for c in CASES for m in c["modes"]])
def test_model_axis_step_matches_one_column(world, case, mode):
    """Every leaf of the (2, 2) step within `SELF_REL` x max |gradient| of
    the one-column step; an MoE config's embedding table within
    `MOE_SELF_REL`."""
    tag = run_tag(case, False, mode)
    one = world["restored"][(DATA, 1)][0]
    ref = common.port_leaves(one, f"{tag}/sgd/new/")
    p0 = _case_leaves(world["p0"], case, f"{case['label']}/p0/")
    gmax = common.max_diff(p0, ref)
    names = _leaf_names(case)
    for rank in world["port"]:
        got = common.port_leaves(rank, f"{tag}/sgd/new/")
        assert len(got) == len(ref) == len(names)
        for name, a, b in zip(names, got, ref):
            budget = MOE_SELF_REL if case.get("moe") and name == EMBED_LEAF else SELF_REL
            assert float(np.abs(a - b).max()) <= budget * gmax, (name, int(rank["rank"]))


@pytest.mark.parametrize("mode", MOE_WHOLE_CASE["modes"])
def test_moe_split_adds_no_rounding(world, mode):
    """mixtral's (2, 2) step with its experts (and the router's columns for
    them) over the columns is bit for bit the step with every MoE leaf
    whole on every column, on every rank: the split computes what one
    process computes, so the step's distance to one column is the dense
    model-axis arithmetic's alone (`MOE_SELF_REL`)."""
    split, whole = MOE_CASES[0], MOE_WHOLE_CASE
    for rank in world["port"]:
        got = common.port_leaves(rank, f"{run_tag(whole, False, mode)}/sgd/new/")
        want = common.port_leaves(rank, f"{run_tag(split, False, mode)}/sgd/new/")
        assert len(got) == len(want) and all(a.tobytes() == b.tobytes()
                                             for a, b in zip(got, want)), int(rank["rank"])
        assert float(rank[f"{run_tag(whole, False, mode)}/sgd/loss"]) == \
            float(rank[f"{run_tag(split, False, mode)}/sgd/loss"])


@pytest.mark.parametrize("case,fsdp,mode", [r for r, _ in MOE_DECOUPLED],
                         ids=[i for _, i in MOE_DECOUPLED])
def test_moe_decoupled_step_folds_once_on_each_reducer(world, case, fsdp, mode):
    """An MoE model's decoupled step on the model axis: FSDP as asked, the
    ranks' losses equal, the step moved the parameters through the model
    axis's collectives, and `chunk_accumulate`'s wrapper folded the one
    compute row's gradient once on each column's reducer row (the last
    row), never on a compute row."""
    tag = run_tag(case, fsdp, mode)
    port = world["port"]
    p0 = _case_leaves(world["p0"], case, f"{case['label']}/p0/")
    assert common.max_diff(p0, common.port_leaves(port[0], f"{tag}/sgd/new/")) > 1e-3
    calls = {int(r["rank"]): int(r[f"{tag}/sgd/accumulate_calls"]) for r in port}
    assert calls == {int(r["rank"]): int(int(r["row"]) == DATA - 1) for r in port}
    for rank in port:
        assert bool(rank[f"{tag}/sgd/fsdp_on"]) == fsdp
        assert float(rank[f"{tag}/sgd/loss"]) == float(port[0][f"{tag}/sgd/loss"])
        assert int(rank[f"{tag}/sgd/model_collectives"]) > 0


# -- the ragged tail --------------------------------------------------------------------

@pytest.mark.parametrize("label,arch,n_experts", TAIL_LAYERS, ids=[t[0] for t in TAIL_LAYERS])
def test_ragged_tail_matches_one_process(world, label, arch, n_experts):
    """One MoE layer over 2 x 600 tokens routed over the (2, 2) world (a
    group of 1,024, then a 176-token tail that expert 0 takes whole, on row
    1): the output, the input gradient and every parameter gradient (summed
    over the rows) within `SELF_REL` of their largest magnitude against the
    same layer in one process; the columns agree bit for bit; aux_loss as
    one process's. The experts split over E (expert 0 on column 0 alone;
    the output and input gradient then one process's bit for bit), over
    ff, and beside a shared expert."""
    from repro_torch.models import moe
    from repro_torch.utils.treeutil import tree_unflatten

    cfg, p, x, r = tail_layer(arch, n_experts)
    assert (TAIL_BATCH * TAIL_SEQ) % moe.DEFAULT_GROUP and TAIL_BATCH * TAIL_SEQ > moe.DEFAULT_GROUP
    leaves, treedef = tree_flatten(p)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    x = x.clone().requires_grad_(True)
    y, aux = moe.apply_moe(tree_unflatten(treedef, leaves), x, cfg, torch.float32)
    ((y * r).sum() + TAIL_AUX * aux["aux_loss"]).backward()
    port = world["port"]
    by_rank = {(int(q["row"]), int(q["col"])): q for q in port}
    key = f"tail/{label}/"
    assert all(str(q[key + "split"]) == ("ff" if label == "ff" else "experts") for q in port)
    for row in range(DATA):
        for k in ("y", "gx"):
            assert by_rank[(row, 0)][key + k].tobytes() == by_rank[(row, 1)][key + k].tobytes()
    for k, want in (("y", y), ("gx", x.grad)):
        got = np.concatenate([by_rank[(row, 0)][key + k] for row in range(DATA)])
        want = want.detach().numpy()
        assert np.abs(got - want).max() <= SELF_REL * np.abs(want).max(), k
        if label == "experts":  # each expert's rows on one column: one process's sums
            assert got.tobytes() == want.tobytes(), k
    grads = [t.grad.numpy() for t in leaves]
    gmax = max(float(np.abs(g).max()) for g in grads)
    for q in port:
        got = [q[f"{key}g/{i}"] for i in range(len(grads))]
        assert max(float(np.abs(a - b).max()) for a, b in zip(got, grads)) <= SELF_REL * gmax
        assert float(q[key + "aux_loss"]) == pytest.approx(float(aux["aux_loss"].detach()),
                                                           rel=common.LOSS_REL)


# -- what each rank holds -------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[c["label"] for c in CASES])
def test_each_rank_holds_its_param_specs_slice(world, case):
    """At step 0 each rank's leaves are its column's slice of the whole
    tree by the reference's specs (llama4's shared expert by the port's
    rule: the reference shards its stacked L, the port its ff), bit for
    bit: converted from the
    reference's tree, drawn by the trainer (against one process's
    ``model.init(0)``), and under FSDP its row's part of that slice; the
    rank holds about a half of the parameters."""
    whole = _case_leaves(world["p0"], case, f"{case['label']}/p0/")
    drawn = [t.numpy() for t in tree_flatten(
        build(case_config(case), device="cpu").init(0, param_dtype=torch.float32))[0]]
    n_whole = sum(x.size for x in whole)
    ported = []
    _reference_slices(case, whole, 0, ported)
    if case["name"] == "llama4-scout-17b-a16e":  # the port rule, each layer's two leaves
        assert ported == ["layers.moe.shared.w_gate.w", "layers.moe.shared.w_up.w"] * 2
    else:
        assert ported == []
    for rank in world["port"]:
        col = int(rank["col"])
        want = _reference_slices(case, whole, col)
        got = common.port_leaves(rank, f"{case['label']}/stored/")
        assert len(got) == len(want) and all(a.tobytes() == b.tobytes()
                                             for a, b in zip(got, want))
        assert 0.5 * n_whole <= sum(x.size for x in got) < 0.62 * n_whole
        if case.get("adamw"):
            init = common.port_leaves(rank, f"{case['label']}/init/")
            assert all(a.tobytes() == b.tobytes()
                       for a, b in zip(init, _reference_slices(case, drawn, col)))
        if case.get("fsdp"):
            units = sharding.units_of(_unflatten_like(case, want))
            parts = []
            for _, tree in units:
                flat = np.concatenate([x.reshape(-1) for x in tree_flatten(tree)[0]])
                part = -(-flat.size // DATA)
                flat = np.pad(flat, (0, part * DATA - flat.size))
                parts.append(flat[int(rank["row"]) * part:(int(rank["row"]) + 1) * part])
            assert np.concatenate(parts).tobytes() == \
                rank[f"{run_tag(case, True, MODES[0])}/parts"].tobytes()


# -- checkpoints ------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True], ids=["whole", "fsdp"])
def test_checkpoint_is_whole(world, fsdp):
    """The (2, 2) conventional AdamW run's last files hold the whole
    parameters in the port's tree and the reference's leaf shapes, which
    the reference's ``checkpoint.restore`` reads; they are the run's
    final state gathered over both axes, bit for bit."""
    from repro.io import checkpoint as jckpt
    from repro_torch.utils.treeutil import tree_map

    tag = run_tag(CKPT_CASE, fsdp, "conventional")
    shapes = param_shapes(build(case_config(CKPT_CASE), device="meta"))
    zeros = tree_map(lambda t: jnp.zeros(tuple(t.shape), jnp.float32), shapes)
    like = {"opt": {"m": zeros, "step": 0, "v": zeros}, "params": zeros, "step": 0}
    back = jckpt.restore(os.path.join(world["ckpt"], tag), FAMILY_STEPS, like)
    got = [np.asarray(x) for x in jax.tree.leaves(back["params"])]
    final = common.port_leaves(world["port"][0], f"{tag}/adamw/params/")
    assert len(got) == len(final) and all(a.tobytes() == b.tobytes()
                                          for a, b in zip(got, final))
    assert int(back["step"]) == FAMILY_STEPS


def _check_restore(world, case: dict, shape) -> None:
    from repro_torch.io import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    tag = run_tag(case, False, "conventional")
    label = case["label"]
    shapes = param_shapes(build(case_config(case), device="meta"))
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
        assert int(out[f"{label}/step"]) == FAMILY_STEPS
        np.testing.assert_allclose(out[f"{label}/loss"], want_loss, rtol=common.LOSS_REL)


@pytest.mark.parametrize("shape", RESTORE_WORLDS, ids=["2x1", "1x2"])
def test_restore_onto_another_world(world, shape):
    """The (2, 2) run's step-2 files restored onto a (2, 1) and a (1, 2)
    world: gathered whole, the parameters and moments equal the files bit
    for bit; resumed, step 3's loss is the reference's within 1e-5."""
    _check_restore(world, CKPT_CASE, shape)


@pytest.mark.parametrize("shape", RESTORE_WORLDS, ids=["2x1", "1x2"])
def test_moe_restore_onto_another_world(world, shape):
    """The same for mixtral's (2, 2) run, whose experts are sharded over E
    on two columns: onto (2, 1) they are whole, onto (1, 2) sharded again."""
    _check_restore(world, MOE_CKPT_CASE, shape)


# -- rules and refusals (no world) ------------------------------------------------------

def test_mesh_layout_and_fsdp_rule():
    """Rank = row x model + col (the device order of a (data, model)
    mesh); the launcher's and the example's default world is (data, 2);
    FSDP's "auto" divides the whole parameters' bytes by the model axis as
    the reference does (qwen2.5-3b: 12.34e9 B / 2 = 6.17e9 > 6e9, / 4 not)."""
    from repro_torch.examples.train_lm import parse_args as example_args
    from repro_torch.launch.train import parse_args as launch_args

    mesh = Mesh(n_rows=4, row=3, col=1, model_size=2, device="cpu")
    assert (mesh.rank, mesh.rank_of(1), mesh.shape) == (7, 3, {"data": 4, "model": 2})
    assert make_host_mesh(4, 2, device="cpu").shape == {"data": 4, "model": 2}
    assert make_host_mesh(device="cpu").shape == {"data": 4, "model": 2}  # the reference's
    assert launch_args([]).model == 2
    assert (example_args([]).data, example_args([]).model) == (4, 2)
    cfg, jcfg = get("qwen2.5-3b"), j_get("qwen2.5-3b")
    like = jax.eval_shape(j_build(jcfg).init, jax.random.PRNGKey(0))
    param_bytes = sum(int(np.prod(x.shape)) * 4 for x in jax.tree.leaves(like))
    for m in (1, 2, 4):
        assert use_fsdp(cfg, TrainStepConfig(), m) == (param_bytes / m > 6e9), m
    assert use_fsdp(cfg, TrainStepConfig(), 2) and not use_fsdp(cfg, TrainStepConfig(), 4)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "llama4-scout-17b-a16e"])
def test_moe_family_builds_on_the_model_axis(name):
    """The MoE family builds on a model axis of 2 (``model.tp`` the mesh),
    and the launcher's check before its world starts passes at its default
    ``--model 2``; each column holds half the experts and half the
    router's columns, and llama4's shared expert half its ff."""
    from repro_torch.launch.train import config, parse_args
    from repro_torch.models.model_zoo import model_axis

    cfg = get_smoke(name)
    mesh = make_host_mesh(2, 2, device="cpu")
    model = build(cfg, device="cpu", tp=mesh)
    assert model.tp is mesh
    args = parse_args(["--arch", name, "--smoke", "--device", "cpu", "--data", "2"])
    assert args.model == 2
    assert model_axis(config(args), make_host_mesh(args.data, args.model, device="cpu"))
    moe_p = param_shapes(model)["layers"][0]["moe"]
    e, ff = cfg.n_experts, cfg.d_ff
    assert tuple(moe_p["w_gate"].shape) == (e // 2, cfg.d_model, ff)
    assert tuple(moe_p["w_down"].shape) == (e // 2, ff, cfg.d_model)
    assert tuple(moe_p["router"]["w"].shape) == (cfg.d_model, e // 2)
    if cfg.shared_expert:
        assert tuple(moe_p["shared"]["w_up"]["w"].shape) == (cfg.d_model, ff // 2)
        assert tuple(moe_p["shared"]["w_down"]["w"].shape) == (ff // 2, cfg.d_model)


@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b", "pixtral-12b", "whisper-small"])
def test_every_family_builds_on_the_model_axis(name):
    """The SSM, hybrid, VLM and encoder-decoder families build on a model
    axis of 2 (``model_axis`` gives the mesh, ``model.tp`` is it): every
    rank's leaves, drawn whole and sliced, have its specs' slice shapes
    (the default layout and ``replicate_ssm``'s); one column builds as
    before. Their steps are held in tests/test_torch_model_axis_families.py."""
    from repro_torch.models.model_zoo import model_axis

    cfg = get_smoke(name)
    mesh = make_host_mesh(2, 2, device="cpu")
    assert model_axis(cfg, mesh) is mesh
    whole = param_shapes(build(cfg, device="meta"))
    leaves = tree_flatten(whole)[0]
    for replicate_ssm in (False, True):
        specs = sharding.spec_list(whole, MODEL, replicate_ssm=replicate_ssm)
        assert any(sharding.model_dim(s) is not None for s in specs)
        for col in range(MODEL):
            rank = Mesh(n_rows=2, row=1, col=col, model_size=MODEL, device="cpu")
            model = build(cfg, device="cpu", tp=rank, replicate_ssm=replicate_ssm)
            assert model.tp is rank and model.replicate_ssm == replicate_ssm
            got = tree_flatten(model.init(0, param_dtype=torch.float32))[0]
            want = [sharding.model_shard(x, s, MODEL, col) for x, s in zip(leaves, specs)]
            assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert build(cfg, device="cpu", tp=make_host_mesh(2, 1, device="cpu")).tp is None


def test_adaptive_trainer_and_reshard_refuse_the_model_axis():
    """The adaptive trainer and the in-memory reshard on a (data, model)
    world raise ValueError naming ROADMAP A8 (listed as left there)."""
    from repro_torch.core.adapt import AdaptPolicy
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.launch.elastic import reshard_state
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mesh = make_host_mesh(4, 2, device="cpu")
    model = build(get_smoke("qwen2.5-3b"), device="cpu", tp=mesh)
    with pytest.raises(ValueError, match="ROADMAP A8"):
        Trainer(model, mesh, None, OptConfig(), TrainStepConfig(mode="decoupled"),
                TrainerConfig(adapt=AdaptPolicy()))
    with pytest.raises(ValueError, match="tp=mesh"):
        Trainer(build(get_smoke("qwen2.5-3b"), device="cpu"), mesh, None, OptConfig(),
                TrainStepConfig(), TrainerConfig())
    g = GroupedMesh.build_rows(mesh, rows={"reduce": 1})
    with pytest.raises(ValueError, match="ROADMAP A8"):
        reshard_state({"x": torch.zeros(4)}, g, g)
