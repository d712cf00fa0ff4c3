"""PyTorch port, FSDP training (the reference's ``fsdp`` and
``fsdp_threshold``): `use_fsdp` against the reference's rule on every
registry config; for every family's f32 smoke config (qwen, mixtral,
hymba, pixtral, whisper) in each step mode with ``fsdp=True``, one SGD
step and a 3-step AdamW `Trainer` run in one 4-row gloo world on the CPU
(`fsdp_worlds.fsdp_cases`) against the reference's
``make_jitted_step(..., TrainStepConfig(mode, fsdp=True))`` on a (4, 1)
mesh of fake devices, run side by side in one JAX subprocess, and against
the port's own ``fsdp=False`` step; each row's parts; a checkpoint
written under FSDP against the one written without it, a crash and its
resume, and an elastic restore onto a 2-row world.

Tolerances: against the reference, tests/train_family_common.py's (the
SGD step 1e-5 absolute, the AdamW losses 1e-5 relative). Against the
port's ``fsdp=False`` step, `SELF_REL`: the SGD step's new parameters
within 1e-6 of the largest gradient element and the AdamW losses within
1e-6 relative (a reduce-scatter and an all-reduce may sum the rows in
another order); the decoupled step bit for bit (the same reduced
gradient, the same elementwise update on a part). The checkpoints, the
resumed run and the restored state bit for bit.
"""
import dataclasses
import json
import math
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_family_common as common
from fsdp_worlds import ELASTIC_ROWS, MODES, N_ROWS, elastic_fsdp_case, fsdp_cases
from repro.configs import get as j_get
from repro.configs import get_smoke as j_get_smoke
from repro.models import build as j_build
from repro_torch.configs import get, get_smoke
from repro_torch.configs.base import REGISTRY
from repro_torch.launch.mesh import spawn
from repro_torch.models.model_zoo import build
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import TrainStepConfig, param_shapes, use_fsdp
from torch_worlds import (
    ADAMW_LR,
    FAMILY_ALPHA,
    FAMILY_CRASH_AT,
    FAMILY_STEPS,
)

SELF_REL = 1e-6
CASES = [dict(label=f"{name}-16", name=name, seq=16, batch=8)
         for name in ("qwen2.5-3b", "mixtral-8x7b", "hymba-1.5b", "pixtral-12b", "whisper-small")]
CKPT_CASE = CASES[0]
# phase 8b's cut depths on the card (chip_smoke.FAMILY_TRAIN), and whole models
DEPTHS = [(name, None) for name in REGISTRY] + [
    ("mixtral-8x7b", 1), ("pixtral-12b", 1), ("hymba-1.5b", 8)]

JAX_FSDP = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke
from repro.data.pipeline import DataConfig, Pipeline
from repro.models import build
from repro.train.optimizer import OptConfig, init_opt_state
from repro.train.train_step import TrainStepConfig, make_jitted_step
from repro.utils.compat import make_mesh
cases = json.loads({cases!r})
n, compute = {n}, {compute}
mesh = make_mesh((n, 1), ("data", "model"))
sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
adamw = OptConfig(lr={lr}, warmup_steps=0, total_steps={steps})
out = {{}}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

def batch_of(pipe, mode, step):
    return pipe.padded_for_groups(step, compute, n) if mode == "decoupled" else \\
        pipe.global_batch(step)

with jax.set_mesh(mesh):
    for c in cases:
        cfg = dataclasses.replace(get_smoke(c["name"]), dtype=jnp.float32)
        model = build(cfg)
        params = model.init(jax.random.PRNGKey(0))
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq"],
                                   global_batch=c["batch"], seed=1, kind="zipf", skew=0.4,
                                   frontend=cfg.frontend,
                                   n_frontend_tokens=cfg.n_frontend_tokens,
                                   d_model=cfg.d_model))
        for mode in {modes!r}:
            ts = TrainStepConfig(mode=mode, reduce_alpha={alpha}, fsdp=True)
            for name, opt, steps in (("sgd", sgd, 1), ("adamw", adamw, {steps})):
                step, sh = make_jitted_step(model, mesh, opt, ts,
                                            jax.eval_shape(lambda: params),
                                            batch_of(pipe, mode, 0), donate=False)
                p = jax.device_put(params, sh[0])
                o = jax.device_put(init_opt_state(opt, params), sh[1])
                ms = []
                for s in range(steps):
                    p, o, m = step(p, o, batch_of(pipe, mode, s))
                    ms.append({{k: float(np.asarray(v).reshape(-1)[0]) for k, v in m.items()
                               if k != "work_rows"}})
                tag = c["label"] + "/" + mode + "/" + name
                flat(p, tag + "/new/")
                for k in ms[0]:
                    out[tag + "/" + k] = np.asarray([x[k] for x in ms])
np.savez({outputs!r}, **out)
print("OK")
"""


def _reference_p0(case: dict) -> dict:
    """The reference's initial parameters of a case, as the subprocess
    draws them (``PRNGKey(0)``), keyed as its outputs are."""
    cfg = dataclasses.replace(j_get_smoke(case["name"]), dtype=jnp.float32)
    params = j_build(cfg).init(jax.random.PRNGKey(0))
    return {f"{case['label']}/p0/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's runs in one JAX subprocess beside the port's 4-row
    world, then the 2-row world restoring the 4-row run's checkpoint."""
    from conftest import run_multidevice

    tmp = tmp_path_factory.mktemp("fsdp")
    inputs = str(tmp / "inputs.npz")
    p0 = {}
    for case in CASES:
        p0.update(_reference_p0(case))
    np.savez(inputs, **p0)
    jax_path = str(tmp / "jax.npz")
    compute = N_ROWS - max(1, int(round(FAMILY_ALPHA * N_ROWS)))
    code = JAX_FSDP.format(cases=json.dumps(CASES), n=N_ROWS, compute=compute, lr=ADAMW_LR,
                           steps=FAMILY_STEPS, alpha=FAMILY_ALPHA, modes=MODES,
                           outputs=jax_path)
    failed = []

    def reference():
        try:
            run_multidevice(code, n_devices=N_ROWS, timeout=900)
        except BaseException as exc:  # re-raised on the test's thread
            failed.append(exc)

    thread = threading.Thread(target=reference)
    thread.start()
    try:
        ckpt = str(tmp / "ckpt")
        port = spawn(fsdp_cases, N_ROWS, device="cpu",
                     args=(inputs, ckpt, CASES, CKPT_CASE["label"]), timeout_s=900)
        elastic = spawn(elastic_fsdp_case, ELASTIC_ROWS, device="cpu",
                        args=(inputs, ckpt, CKPT_CASE), timeout_s=300)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return {"jax": dict(np.load(jax_path)), "port": port, "elastic": elastic, "ckpt": ckpt,
            "p0": p0}


# -- (a) the rule -------------------------------------------------------------------

def _reference_rule(jcfg, fsdp, threshold: float) -> bool:
    """`make_jitted_step`'s arithmetic on ``jax.eval_shape`` of the
    reference's ``model.init`` (model axis 1)."""
    like = jax.eval_shape(j_build(jcfg).init, jax.random.PRNGKey(0))
    param_bytes = sum(int(np.prod(x.shape)) * 4 for x in jax.tree.leaves(like))
    return param_bytes / 1 > threshold if fsdp == "auto" else bool(fsdp)


@pytest.mark.parametrize("name,layers", DEPTHS)
def test_use_fsdp_is_the_reference_rule(name, layers):
    """The port's rule equals the reference's at its default threshold, at
    0 and at infinity, and with ``fsdp`` forced either way; the port's
    training tree has the reference's element count."""
    jcfg, cfg = j_get(name), get(name)
    if layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    like = jax.eval_shape(j_build(jcfg).init, jax.random.PRNGKey(0))
    want_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(like))
    shapes = param_shapes(build(cfg, device="meta"))
    assert sum(t.numel() for t in jax.tree.leaves(shapes)) == want_count
    for fsdp, threshold in (("auto", 6e9), ("auto", 0.0), ("auto", math.inf), (True, math.inf),
                            (False, 0.0)):
        ts = TrainStepConfig(fsdp=fsdp, fsdp_threshold=threshold)
        assert use_fsdp(cfg, ts) == _reference_rule(jcfg, fsdp, threshold), (fsdp, threshold)
        assert use_fsdp(shapes, ts) == use_fsdp(cfg, ts)


def test_default_rule_on_the_trained_models():
    """The models the card trains: qwen2.5-3b whole and phase 8b's mixtral
    and pixtral layers shard by default; hymba at 8 layers, whisper and
    qwen1.5-0.5b do not."""
    ts = TrainStepConfig()
    assert ts.fsdp == "auto" and ts.fsdp_threshold == 6e9
    cut = {n: dataclasses.replace(get(n), n_layers=k)
           for n, k in (("mixtral-8x7b", 1), ("pixtral-12b", 1), ("hymba-1.5b", 8))}
    assert all(use_fsdp(c, ts) for c in (get("qwen2.5-3b"), cut["mixtral-8x7b"],
                                         cut["pixtral-12b"], get("hymba-1.5b")))
    assert not any(use_fsdp(c, ts) for c in (get("qwen1.5-0.5b"), get("tinyllama-1.1b"),
                                             get("whisper-small"), cut["hymba-1.5b"]))


# -- (b) against the reference, (c) against the port without FSDP --------------------

def _tags(case, mode):
    return f"{case['label']}/fsdp/{mode}", f"{case['label']}/whole/{mode}"


@pytest.mark.parametrize("case,mode", [(c, m) for c in CASES for m in MODES],
                         ids=[f"{c['label']}-{m}" for c in CASES for m in MODES])
def test_sgd_step_matches_jax_fsdp(world, case, mode):
    jax_out, port = world["jax"], world["port"]
    fsdp, _ = _tags(case, mode)
    want = common.jax_leaves(jax_out, case["name"], f"{case['label']}/{mode}/sgd/new/")
    for row in range(N_ROWS):
        assert bool(port[row][f"{fsdp}/sgd/fsdp_on"])
        assert common.max_diff(common.port_leaves(port[row], f"{fsdp}/sgd/new/"), want) \
            <= common.SGD_ATOL
    p0 = common.jax_leaves(world["p0"], case["name"], f"{case['label']}/p0/")
    assert common.max_diff(p0, want) > 1e-3  # it moved
    keys = ("loss",) if mode == "decoupled" else ("loss", "aux_loss", "router_entropy")
    for k in keys:
        if f"{case['label']}/{mode}/sgd/{k}" in jax_out:
            assert float(port[0][f"{fsdp}/sgd/{k}"]) == pytest.approx(
                float(jax_out[f"{case['label']}/{mode}/sgd/{k}"][0]), rel=common.LOSS_REL), k


@pytest.mark.parametrize("case,mode", [(c, m) for c in CASES for m in MODES],
                         ids=[f"{c['label']}-{m}" for c in CASES for m in MODES])
def test_trainer_losses_match_jax_fsdp(world, case, mode):
    jax_out, port = world["jax"], world["port"]
    fsdp, _ = _tags(case, mode)
    want = jax_out[f"{case['label']}/{mode}/adamw/loss"]
    assert len(want) == FAMILY_STEPS and np.isfinite(want).all()
    for row in range(N_ROWS):
        np.testing.assert_allclose(port[row][f"{fsdp}/adamw/loss"], want, rtol=common.LOSS_REL)


@pytest.mark.parametrize("case,mode", [(c, m) for c in CASES for m in MODES],
                         ids=[f"{c['label']}-{m}" for c in CASES for m in MODES])
def test_fsdp_step_matches_the_whole_step(world, case, mode):
    """FSDP against the port's own step without it: the same numbers up
    to the order of the rows' sums; in decoupled mode bit for bit."""
    port = world["port"]
    fsdp, whole = _tags(case, mode)
    p0 = common.jax_leaves(world["p0"], case["name"], f"{case['label']}/p0/")
    for row in range(N_ROWS):
        got = common.port_leaves(port[row], f"{fsdp}/sgd/new/")
        ref = common.port_leaves(port[row], f"{whole}/sgd/new/")
        gmax = common.max_diff(p0, ref)  # lr 1: the largest gradient element
        assert common.max_diff(got, ref) <= SELF_REL * gmax
        np.testing.assert_allclose(port[row][f"{fsdp}/adamw/loss"],
                                   port[row][f"{whole}/adamw/loss"], rtol=SELF_REL)
        if mode == "decoupled":
            assert common.max_diff(got, ref) == 0.0
            assert common.max_diff(common.port_leaves(port[row], f"{fsdp}/adamw/params/"),
                                   common.port_leaves(port[row], f"{whole}/adamw/params/")) == 0
            np.testing.assert_array_equal(port[row][f"{fsdp}/adamw/loss"],
                                          port[row][f"{whole}/adamw/loss"])


# -- (d) the parts ------------------------------------------------------------------

@pytest.mark.parametrize("case,mode", [(c, m) for c in CASES for m in MODES],
                         ids=[f"{c['label']}-{m}" for c in CASES for m in MODES])
def test_each_row_holds_its_parts(world, case, mode):
    """Between steps each row holds ceil(unit / 4) elements of every
    unit's parameters and moments, and the moments it holds are those
    parts: a quarter of the whole run's (less the padding)."""
    port = world["port"]
    fsdp, whole = _tags(case, mode)
    n_params = sum(x.size for x in common.port_leaves(port[0], f"{fsdp}/adamw/params/"))
    for row in range(N_ROWS):
        sizes = {k: port[row][f"{fsdp}/adamw/sizes/{k}"] for k in ("params", "m", "v")}
        for k, s in sizes.items():
            assert (s[:, 0] == s[:, 1]).all(), k
        assert len(sizes["params"]) == len(build(get_smoke(case["name"]), device="cpu").units)
        held = int(port[row][f"{fsdp}/adamw/moment_bytes"])
        assert held == 2 * 4 * int(sizes["m"][:, 0].sum())
        assert 0 <= N_ROWS * held - 2 * 4 * n_params < 2 * 4 * N_ROWS * len(sizes["m"])
        if mode != "overlap":  # ZeRO-1 keeps moment parts without FSDP too
            assert int(port[row][f"{whole}/adamw/moment_bytes"]) == 2 * 4 * n_params


# -- (e) checkpoints ------------------------------------------------------------------

def _files(directory: str, step: int) -> list:
    """The manifest and every leaf's bytes of a committed step."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "treedef.json")) as f:
        text = f.read()
    return [text] + [np.load(os.path.join(d, f"leaf_{i:05d}.npy")).tobytes()
                     for i in range(len(json.loads(text)["paths"]))]


def test_checkpoint_under_fsdp_is_the_whole_one(world):
    """The decoupled trainer's files under FSDP equal, byte for byte, its
    files without FSDP at every step (the same state, gathered unit by
    unit on the writer)."""
    root = os.path.join(world["ckpt"], CKPT_CASE["label"])
    np.testing.assert_array_equal(world["port"][0]["ckpt/fsdp/loss"],
                                  world["port"][0]["ckpt/whole/loss"])
    for step in range(1, FAMILY_STEPS + 1):
        got, want = _files(os.path.join(root, "ckpt_fsdp"), step), \
            _files(os.path.join(root, "ckpt_whole"), step)
        assert len(got) == len(want) > 1
        assert all(a == b for a, b in zip(got, want)), step


def test_crash_resume_under_fsdp(world):
    """The crash after step 2's save; the resumed run's step 3 and last
    parameters equal the straight decoupled FSDP run's bit for bit."""
    p0 = world["port"][0]
    label = CKPT_CASE["label"]
    straight = p0[f"{label}/fsdp/decoupled/adamw/loss"]
    assert bool(p0["crash/raised"])
    np.testing.assert_array_equal(p0["crash/loss"], straight[:FAMILY_CRASH_AT])
    assert int(p0["crash/resumed"]) == FAMILY_CRASH_AT
    np.testing.assert_array_equal(p0["crash/resumed_loss"], straight[FAMILY_CRASH_AT:])
    assert common.max_diff(common.port_leaves(p0, "crash/params/"),
                           common.port_leaves(p0, f"{label}/fsdp/decoupled/adamw/params/")) == 0


def test_elastic_restore_onto_two_rows(world):
    """The 4-row run's step-2 files restored onto 2 rows under FSDP: each
    row holds ceil(unit / 2) of every unit; gathered, the parameters and
    moments equal the files bit for bit; the 2-row conventional run resumed
    from them takes step 3 at the 4-row run's loss."""
    from repro_torch.io import checkpoint as ckpt
    from repro_torch.utils.treeutil import tree_flatten

    label = CKPT_CASE["label"]
    cfg = dataclasses.replace(get_smoke(CKPT_CASE["name"]), dtype=torch.float32)
    model = build(cfg, device="cpu")
    shapes, n_units = param_shapes(model), len(model.units)
    like = {"params": shapes, "opt": init_opt_state(OptConfig(), shapes), "step": 0}
    files = ckpt.restore(os.path.join(world["ckpt"], label, "crash"), FAMILY_CRASH_AT, like,
                         device="cpu")
    straight = world["port"][0][f"{label}/fsdp/decoupled/adamw/loss"]
    for row, out in enumerate(world["elastic"]):
        assert int(out["restored_step"]) == FAMILY_CRASH_AT
        sizes = out["restored_sizes"]
        assert (sizes[:, 0] == sizes[:, 1]).all() and len(sizes) == n_units
        for k, tree in (("params", files["params"]), ("m", files["opt"]["m"]),
                        ("v", files["opt"]["v"])):
            want = [t.numpy() for t in tree_flatten(tree)[0]]
            got = common.port_leaves(out, f"restored/{k}/")
            assert len(got) == len(want) and all(a.tobytes() == b.tobytes()
                                                 for a, b in zip(got, want)), (row, k)
        assert int(out["resumed"]) == FAMILY_CRASH_AT and int(out["step"]) == FAMILY_STEPS
        np.testing.assert_allclose(out["loss"], straight[FAMILY_CRASH_AT:], rtol=common.LOSS_REL)
