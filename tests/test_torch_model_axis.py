"""PyTorch port, the model axis (tensor parallelism by hand, the reference's
GSPMD ``model`` axis): the dense family's f32 smoke configs
(tinyllama-1.1b, qwen1.5-0.5b, qwen2.5-3b, starcoder2-15b, and tinyllama
with one KV head, where the heads do not divide the axis and the
projections are gathered) on a (data 2, model 2) world of four CPU ranks
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
1e-5).

Tolerances (tests/train_family_common.py's): one SGD step (lr 1) within
1e-5 absolute of the reference's, with a binding clip too (``grad_clip``
0.05: a whole leaf counted once per column would move its norm); the AdamW
trainer's losses within 1e-5 relative. Against the one-column step, the
(2, 2) step within `SELF_REL` (1e-6) x max |gradient|: the column sums of
the row-sharded products add the f32 terms in another order; the decoupled
step folds its one compute row's gradient on its reducer row in each
column, the same fold order as one column. Each rank's stored leaves at
step 0, its column's slice of the reference's tree by the reference's
``param_specs`` (and FSDP's part of that slice), bit for bit; the restored
state against the files bit for bit.
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_family_common as common
from model_axis_worlds import (
    CKPT_EVERY,
    CLIP,
    DATA,
    MODEL,
    MODES,
    case_config,
    model_axis_cases,
    restore_case,
    run_tag,
)
from repro.configs import get as j_get
from repro.configs import get_smoke as j_get_smoke
from repro.models import build as j_build
from repro.train import sharding as j_sharding
from repro_torch.configs import get, get_smoke
from repro_torch.launch.mesh import Mesh, make_host_mesh, spawn
from repro_torch.models.model_zoo import build
from repro_torch.train import sharding
from repro_torch.train.train_step import TrainStepConfig, param_shapes, use_fsdp
from repro_torch.utils.treeutil import tree_flatten
from torch_worlds import ADAMW_LR, FAMILY_ALPHA, FAMILY_STEPS

SELF_REL = 1e-6
DENSE = ("tinyllama-1.1b", "qwen1.5-0.5b", "qwen2.5-3b", "starcoder2-15b")
CASES = [dict(label=f"{name}-16", name=name, seq=16, batch=8, modes=MODES, adamw=True,
              fsdp=name == "qwen2.5-3b", clip=name == "qwen2.5-3b") for name in DENSE] + [
    dict(label="tinyllama-kv1-16", name="tinyllama-1.1b", n_kv_heads=1, seq=16, batch=8,
         modes=MODES)]
CKPT_CASE = CASES[2]  # qwen2.5-3b: its (2, 2) conventional AdamW run's files
RESTORE_WORLDS = ((2, 1), (1, 2))
RUNS = [(c, fsdp, m) for c in CASES for fsdp in ((False, True) if c.get("fsdp") else (False,))
        for m in c["modes"]]
RUN_IDS = [f"{c['label']}-{'fsdp' if f else 'whole'}-{m}" for c, f, m in RUNS]

JAX_MODEL_AXIS = """
import dataclasses, json, os
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke
from repro.data.pipeline import DataConfig, Pipeline
from repro.launch.mesh import make_host_mesh
from repro.models import build
from repro.train.optimizer import OptConfig, init_opt_state
from repro.train.train_step import TrainStepConfig, make_jitted_step
from repro.train.trainer import Trainer, TrainerConfig
cases = json.loads({cases!r})
n, compute = {data}, {compute}
mesh = make_host_mesh({data}, {model})
def sgd(clip):
    return OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=clip,
                     weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
adamw = OptConfig(lr={lr}, warmup_steps=0, total_steps={steps})
out = {{}}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

def batch_of(pipe, mode, step):
    return pipe.padded_for_groups(step, compute, n) if mode == "decoupled" else \\
        pipe.global_batch(step)

class Padded:  # the decoupled layout's batches as a conventional trainer takes them
    def __init__(self, pipe):
        self.pipe = pipe
    def global_batch(self, step):
        return self.pipe.padded_for_groups(step, compute, n)

with jax.set_mesh(mesh):
    for c in cases:
        cfg = dataclasses.replace(get_smoke(c["name"]), dtype=jnp.float32)
        if c.get("n_kv_heads"):
            cfg = dataclasses.replace(cfg, n_kv_heads=c["n_kv_heads"])
        model = build(cfg)
        params = model.init(jax.random.PRNGKey(0))
        flat(params, c["label"] + "/p0/")
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq"],
                                   global_batch=c["batch"], seed=1, kind="zipf", skew=0.4))
        for fsdp in ((False, True) if c.get("fsdp") else (False,)):
            for mode in c["modes"]:
                tag = c["label"] + "/" + ("fsdp" if fsdp else "whole") + "/" + mode
                # the decoupled step: the conventional step on its layout's batch
                ts = TrainStepConfig(mode="conventional" if mode == "decoupled" else mode,
                                     reduce_alpha={alpha}, fsdp=fsdp)
                runs = [("sgd", 0.0)] + ([("clip", {clip})] if c.get("clip") else [])
                for name, clip in runs:
                    step, sh = make_jitted_step(model, mesh, sgd(clip), ts,
                                                jax.eval_shape(lambda: params),
                                                batch_of(pipe, mode, 0), donate=False)
                    p, o, m = step(jax.device_put(params, sh[0]),
                                   jax.device_put(init_opt_state(sgd(clip), params), sh[1]),
                                   batch_of(pipe, mode, 0))
                    flat(p, tag + "/" + name + "/new/")
                    out[tag + "/" + name + "/loss"] = np.asarray(m["loss"])
                if not c.get("adamw"):
                    continue
                tr = Trainer(model, mesh, Padded(pipe) if mode == "decoupled" else pipe,
                             adamw, ts,
                             TrainerConfig(total_steps={steps}, ckpt_every={ckpt_every},
                                           log_every=1,
                                           ckpt_dir=os.path.join({tmp!r}, tag)))
                start = jax.tree.map(jnp.copy, params)
                tr.run({{"params": start, "opt": init_opt_state(adamw, start), "step": 0}},
                       resume=False)
                tr.close()
                out[tag + "/adamw/loss"] = np.asarray([r["loss"] for r in tr.metrics_log])
np.savez({outputs!r}, **out)
print("OK")
"""


def _reference_p0(case: dict) -> dict:
    """The reference's initial parameters of a case, as the subprocess
    draws them, keyed as its outputs are."""
    cfg = dataclasses.replace(j_get_smoke(case["name"]), dtype=jnp.float32)
    if case.get("n_kv_heads"):
        cfg = dataclasses.replace(cfg, n_kv_heads=case["n_kv_heads"])
    params = j_build(cfg).init(jax.random.PRNGKey(0))
    return {f"{case['label']}/p0/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's runs in one JAX subprocess beside the port's (2, 2)
    world, then the (2, 1) and (1, 2) worlds restoring its checkpoint."""
    from conftest import run_multidevice

    tmp = tmp_path_factory.mktemp("model_axis")
    inputs = str(tmp / "inputs.npz")
    p0 = {}
    for case in CASES:
        p0.update(_reference_p0(case))
    np.savez(inputs, **p0)
    jax_path = str(tmp / "jax.npz")
    compute = DATA - max(1, int(round(FAMILY_ALPHA * DATA)))
    code = JAX_MODEL_AXIS.format(cases=json.dumps(CASES), data=DATA, model=MODEL,
                                 compute=compute, lr=ADAMW_LR, steps=FAMILY_STEPS,
                                 alpha=FAMILY_ALPHA, clip=CLIP, ckpt_every=CKPT_EVERY,
                                 tmp=str(tmp / "jax_ckpt"), outputs=jax_path)
    failed = []

    def reference():
        try:
            run_multidevice(code, n_devices=DATA * MODEL, timeout=900)
        except BaseException as exc:  # re-raised on the test's thread
            failed.append(exc)

    thread = threading.Thread(target=reference)
    thread.start()
    try:
        ckpt = str(tmp / "ckpt")
        port = spawn(model_axis_cases, DATA, model=MODEL, device="cpu",
                     args=(inputs, ckpt, CASES), timeout_s=900)
        src = run_tag(CKPT_CASE, False, "conventional")
        restored = {}
        for data, model in RESTORE_WORLDS:
            sgd_cases = CASES if (data, model) == (DATA, 1) else []
            restored[(data, model)] = spawn(restore_case, data, model=model, device="cpu",
                                            args=(inputs, ckpt, CKPT_CASE, src, sgd_cases),
                                            timeout_s=600)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return {"jax": dict(np.load(jax_path)), "port": port, "restored": restored, "ckpt": ckpt,
            "p0": p0}


def _case_leaves(tree_np: dict, case: dict, prefix: str) -> list:
    """The reference's tree under ``prefix`` as the port's whole leaves."""
    from repro_torch.utils.convert import params_from_numpy
    from torch_worlds import unflatten_params

    tree = params_from_numpy(unflatten_params(tree_np, prefix), case_config(case), "cpu",
                             param_dtype=torch.float32)
    return [t.numpy() for t in tree_flatten(tree)[0]]


# -- against the reference ----------------------------------------------------------

@pytest.mark.parametrize("case,fsdp,mode", RUNS, ids=RUN_IDS)
def test_sgd_step_matches_jax(world, case, fsdp, mode):
    """Every rank's whole new parameters within 1e-5 of the reference's
    (2, 2) step, with its loss; FSDP resolves as asked; the step moved the
    parameters and went through the model axis's collectives."""
    jax_out, port = world["jax"], world["port"]
    tag = run_tag(case, fsdp, mode)
    names = ("sgd", "clip") if case.get("clip") else ("sgd",)
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


@pytest.mark.parametrize("case,fsdp,mode", [r for r in RUNS if r[0].get("adamw")],
                         ids=[i for r, i in zip(RUNS, RUN_IDS) if r[0].get("adamw")])
def test_trainer_losses_match_jax(world, case, fsdp, mode):
    want = world["jax"][f"{run_tag(case, fsdp, mode)}/adamw/loss"]
    assert len(want) == FAMILY_STEPS and np.isfinite(want).all()
    for rank in world["port"]:
        np.testing.assert_allclose(rank[f"{run_tag(case, fsdp, mode)}/adamw/loss"], want,
                                   rtol=common.LOSS_REL)


@pytest.mark.parametrize("mode", MODES)
def test_clip_binds_and_counts_whole_leaves_once(world, mode):
    """The clip case's update is the unclipped one scaled (lr 1, no
    momentum) by max_norm over the whole gradient's norm, each element
    counted once; a norm that counted each whole leaf once per column
    would miss it by far more than the rounding."""
    case = CKPT_CASE
    p0 = _case_leaves(world["p0"], case, f"{case['label']}/p0/")
    shapes = param_shapes(build(case_config(case), device="meta"))
    whole = [sharding.model_dim(x) is None for x in sharding.spec_list(shapes, MODEL)]
    assert any(whole) and not all(whole)
    for fsdp in (False, True):
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


# -- against the port's one-column step ----------------------------------------------

@pytest.mark.parametrize("case,mode", [(c, m) for c in CASES for m in c["modes"]],
                         ids=[f"{c['label']}-{m}" for c in CASES for m in c["modes"]])
def test_model_axis_step_matches_one_column(world, case, mode):
    tag = run_tag(case, False, mode)
    one = world["restored"][(DATA, 1)][0]
    ref = common.port_leaves(one, f"{tag}/sgd/new/")
    p0 = _case_leaves(world["p0"], case, f"{case['label']}/p0/")
    gmax = common.max_diff(p0, ref)
    for rank in world["port"]:
        assert common.max_diff(common.port_leaves(rank, f"{tag}/sgd/new/"), ref) \
            <= SELF_REL * gmax


# -- what each rank holds -------------------------------------------------------------

def _reference_slices(case: dict, whole: list, col: int) -> list:
    """Column ``col``'s slices of the port's whole leaves by the reference's
    own ``param_specs`` of its stacked tree (the port's spec code unused)."""
    cfg = dataclasses.replace(j_get_smoke(case["name"]), dtype=jnp.float32)
    if case.get("n_kv_heads"):
        cfg = dataclasses.replace(cfg, n_kv_heads=case["n_kv_heads"])
    like = jax.eval_shape(j_build(cfg).init, jax.random.PRNGKey(0))
    specs = j_sharding.param_specs(like, MODEL)
    shapes = param_shapes(build(case_config(case), device="meta"))
    out = []
    for (names, depth), leaf in zip(sharding._leaf_paths(shapes), whole):
        spec = specs
        for k in names:
            spec = spec[k]
        spec = tuple(spec) + (None,) * (leaf.ndim + (depth is not None) - len(tuple(spec)))
        spec = spec[1:] if depth is not None else spec
        if "model" not in spec:
            out.append(leaf)
            continue
        d = spec.index("model")
        out.append(np.split(leaf, MODEL, axis=d)[col])
    return out


@pytest.mark.parametrize("case", CASES, ids=[c["label"] for c in CASES])
def test_each_rank_holds_its_param_specs_slice(world, case):
    """At step 0 each rank's leaves are its column's slice of the whole
    tree by the reference's specs, bit for bit: converted from the
    reference's tree, drawn by the trainer (against one process's
    ``model.init(0)``), and under FSDP its row's part of that slice; the
    rank holds about a half of the parameters."""
    whole = _case_leaves(world["p0"], case, f"{case['label']}/p0/")
    drawn = [t.numpy() for t in tree_flatten(
        build(case_config(case), device="cpu").init(0, param_dtype=torch.float32))[0]]
    n_whole = sum(x.size for x in whole)
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


def _unflatten_like(case: dict, leaves: list) -> dict:
    shapes = param_shapes(build(case_config(case), device="meta"))
    from repro_torch.utils.treeutil import tree_unflatten

    return tree_unflatten(tree_flatten(shapes)[1], leaves)


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


@pytest.mark.parametrize("shape", RESTORE_WORLDS, ids=["2x1", "1x2"])
def test_restore_onto_another_world(world, shape):
    """The (2, 2) run's step-2 files restored onto a (2, 1) and a (1, 2)
    world: gathered whole, the parameters and moments equal the files bit
    for bit; resumed, step 3's loss is the reference's within 1e-5."""
    from repro_torch.io import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    tag = run_tag(CKPT_CASE, False, "conventional")
    shapes = param_shapes(build(case_config(CKPT_CASE), device="meta"))
    like = {"params": shapes, "opt": init_opt_state(OptConfig(), shapes), "step": 0}
    files = ckpt.restore(os.path.join(world["ckpt"], tag), CKPT_EVERY, like, device="cpu")
    want_loss = world["jax"][f"{tag}/adamw/loss"][CKPT_EVERY:]
    for out in world["restored"][shape]:
        assert int(out["restored_step"]) == CKPT_EVERY
        for k, tree in (("params", files["params"]), ("m", files["opt"]["m"]),
                        ("v", files["opt"]["v"])):
            want = [t.numpy() for t in tree_flatten(tree)[0]]
            got = common.port_leaves(out, f"restored/{k}/")
            assert len(got) == len(want) and all(a.tobytes() == b.tobytes()
                                                 for a, b in zip(got, want)), k
        assert int(out["resumed"]) == CKPT_EVERY and int(out["step"]) == FAMILY_STEPS
        np.testing.assert_allclose(out["loss"], want_loss, rtol=common.LOSS_REL)


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
    assert launch_args([]).model == 2
    assert (example_args([]).data, example_args([]).model) == (4, 2)
    cfg, jcfg = get("qwen2.5-3b"), j_get("qwen2.5-3b")
    like = jax.eval_shape(j_build(jcfg).init, jax.random.PRNGKey(0))
    param_bytes = sum(int(np.prod(x.shape)) * 4 for x in jax.tree.leaves(like))
    for m in (1, 2, 4):
        assert use_fsdp(cfg, TrainStepConfig(), m) == (param_bytes / m > 6e9), m
    assert use_fsdp(cfg, TrainStepConfig(), 2) and not use_fsdp(cfg, TrainStepConfig(), 4)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "mamba2-130m", "hymba-1.5b", "pixtral-12b",
                                  "whisper-small"])
def test_other_families_refuse_the_model_axis(name):
    """A model axis of 2 on any family but the dense one raises ValueError
    naming ROADMAP A8 and the family, at `build` and in the launcher before
    its world starts; one column builds as before."""
    from repro_torch.launch.train import main as launch_main

    cfg = get_smoke(name)
    with pytest.raises(ValueError, match="ROADMAP A8") as err:
        build(cfg, device="cpu", tp=make_host_mesh(2, 2, device="cpu"))
    assert cfg.family in str(err.value)
    with pytest.raises(ValueError, match="ROADMAP A8"):
        launch_main(["--arch", name, "--smoke", "--device", "cpu", "--data", "2"])
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
