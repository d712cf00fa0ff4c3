"""Shared by tests/test_torch_train_moe.py and
tests/test_torch_train_families.py: the reference's runs of a list of
cases (`torch_worlds.family_train_cases` describes them) in one JAX
subprocess on 8 fake devices, an (8, 1) mesh, and the port's in one
8-row gloo world on the CPU, and the checks both files make of them.

Tolerances (the budgets of tests/test_torch_train_step.py and
tests/test_torch_trainer.py): one SGD step with lr 1 (new params =
params - gradient) within `SGD_ATOL` absolute; the AdamW trainer's
losses and the reported ``aux_loss`` and ``router_entropy`` within
`LOSS_REL` relative; the port's ``runtime_skip=False`` step equal to its
default step bit for bit (the service rows' work is dropped); its
``zero1=False`` run equal to its ZeRO-1 run within `ZERO1_ATOL` (the same
per-element AdamW arithmetic on whole tensors or on flat parts; bit for
bit is expected); a resumed run equal to the straight one bit for bit
(the files hold the state's own bits); a per-row-routed MoE step off the
reference's global one by more than `PER_ROW_MIN` x `SGD_ATOL`.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import spawn
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.treeutil import tree_flatten
from torch_worlds import (
    ADAMW_LR,
    FAMILY_ALPHA,
    FAMILY_CRASH_AT,
    FAMILY_STEPS,
    N_ROWS,
    family_train_cases,
    unflatten_params,
)

MODES = ("conventional", "decoupled", "overlap")
SGD_ATOL = 1e-5
LOSS_REL = 1e-5
ZERO1_ATOL = 1e-7
PER_ROW_MIN = 10

JAX_FAMILY = """
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

def run(model, params, opt, ts, pipe, steps, start=0):
    step, sh = make_jitted_step(model, mesh, opt, ts, jax.eval_shape(lambda: params),
                                batch_of(pipe, ts.mode, start), donate=False)
    p, o = jax.device_put(params, sh[0]), jax.device_put(init_opt_state(opt, params), sh[1])
    metrics = []
    for s in range(start, start + steps):
        p, o, m = step(p, o, batch_of(pipe, ts.mode, s))
        metrics.append({{k: float(np.asarray(v).reshape(-1)[0]) for k, v in m.items()
                        if k != "work_rows"}})
    return p, metrics

with jax.set_mesh(mesh):
    for c in cases:
        label = c["label"]
        cfg = dataclasses.replace(get_smoke(c["name"]), dtype=jnp.float32)
        model = build(cfg)
        params = model.init(jax.random.PRNGKey(0))
        flat(params, label + "/p0/")
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq"],
                                   global_batch=c["batch"], seed=1, kind="zipf", skew=0.4,
                                   frontend=cfg.frontend,
                                   n_frontend_tokens=cfg.n_frontend_tokens,
                                   d_model=cfg.d_model))
        runs = [("sgd/" + m, sgd, dict(mode=m), 1) for m in c["sgd"]]
        runs += [("adamw/" + m, adamw, dict(mode=m), {steps}) for m in c["adamw"]]
        if c.get("runtime_skip"):
            runs.append(("sgd/decoupled_noskip", sgd, dict(mode="decoupled",
                                                           runtime_skip=False), 1))
        if c.get("zero1"):
            runs.append(("adamw/overlap_whole", adamw, dict(mode="overlap", zero1=False),
                         {steps}))
        for name, opt, kw, steps in runs:
            new, ms = run(model, params, opt, TrainStepConfig(reduce_alpha={alpha}, **kw),
                          pipe, steps)
            flat(new, f"{{label}}/{{name}}/new/")
            for k in ms[0]:
                out[f"{{label}}/{{name}}/{{k}}"] = np.asarray([m[k] for m in ms])
np.savez({outputs!r}, **out)
print("OK")
"""


def run_both(tmp, cases: list) -> tuple[dict, list]:
    """The reference's outputs, then the port's world's (every rank's) on
    the reference's initial parameters."""
    from conftest import run_multidevice

    jax_path = str(tmp / "jax.npz")
    compute = N_ROWS - max(1, int(round(FAMILY_ALPHA * N_ROWS)))
    run_multidevice(JAX_FAMILY.format(cases=json.dumps(cases), n=N_ROWS, compute=compute,
                                      lr=ADAMW_LR, steps=FAMILY_STEPS, alpha=FAMILY_ALPHA,
                                      outputs=jax_path),
                    n_devices=N_ROWS, timeout=900)
    jax_out = dict(np.load(jax_path))
    both = str(tmp / "inputs.npz")
    np.savez(both, **{k: v for k, v in jax_out.items() if "/p0/" in k})
    port = spawn(family_train_cases, N_ROWS, device="cpu",
                 args=(both, str(tmp / "ckpt"), cases), timeout_s=900)
    return jax_out, port


def case_of(cases: list, label: str) -> dict:
    return next(c for c in cases if c["label"] == label)


def port_leaves(out: dict, prefix: str) -> list:
    n = sum(1 for k in out if k.startswith(prefix))
    return [out[f"{prefix}{i}"] for i in range(n)]


def jax_leaves(jax_out: dict, name: str, prefix: str) -> list:
    """The reference's tree under ``prefix`` as the port's leaves."""
    cfg = dataclasses.replace(get_smoke(name), dtype=torch.float32)
    tree = params_from_numpy(unflatten_params(jax_out, prefix), cfg, "cpu",
                             param_dtype=torch.float32)
    return [t.numpy() for t in tree_flatten(tree)[0]]


def max_diff(a: list, b: list) -> float:
    assert len(a) == len(b) and len(a) > 0
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def check_sgd(world, cases, label: str, mode: str) -> None:
    """The port's SGD step of ``mode`` on every row against the
    reference's; it moved the parameters; the loss and, for an MoE
    model, the global ``aux_loss`` and ``router_entropy`` reported."""
    jax_out, port = world
    name = case_of(cases, label)["name"]
    want = jax_leaves(jax_out, name, f"{label}/sgd/{mode}/new/")
    for row in range(N_ROWS):  # every row applies the same update
        assert max_diff(port_leaves(port[row], f"{label}/sgd/{mode}/new/"), want) <= SGD_ATOL
    assert max_diff(jax_leaves(jax_out, name, f"{label}/p0/"), want) > 1e-3  # it moved
    keys = ("loss",) if mode == "decoupled" else ("loss", "aux_loss", "router_entropy")
    for k in keys:
        if f"{label}/sgd/{mode}/{k}" in jax_out:
            for row in (0, N_ROWS - 1):
                assert float(port[row][f"{label}/sgd/{mode}/{k}"]) == pytest.approx(
                    float(jax_out[f"{label}/sgd/{mode}/{k}"][0]), rel=LOSS_REL), k


def check_trainer(world, label: str, mode: str) -> None:
    jax_out, port = world
    want = jax_out[f"{label}/adamw/{mode}/loss"]
    assert len(want) == FAMILY_STEPS and np.isfinite(want).all()
    for row in range(N_ROWS):
        np.testing.assert_allclose(port[row][f"{label}/adamw/{mode}/loss"], want,
                                   rtol=LOSS_REL)


def check_per_row_routing_fails(world, cases, label: str) -> None:
    """Per-row routing (each row's shard its own groups and aux_loss) is
    not the reference's conventional step: it misses by far more than the
    budget, while the port's routed step is inside it."""
    jax_out, port = world
    name = case_of(cases, label)["name"]
    want = jax_leaves(jax_out, name, f"{label}/sgd/conventional/new/")
    assert max_diff(port_leaves(port[0], f"{label}/sgd/conventional/new/"), want) <= SGD_ATOL
    assert max_diff(port_leaves(port[0], f"{label}/per_row/new/"), want) > PER_ROW_MIN * SGD_ATOL


def check_runtime_skip(world, cases, label: str) -> None:
    """``runtime_skip=False``: the reference's step, and the port's default
    step bit for bit on every row."""
    jax_out, port = world
    name = case_of(cases, label)["name"]
    want = jax_leaves(jax_out, name, f"{label}/sgd/decoupled_noskip/new/")
    for row in range(N_ROWS):
        got = port_leaves(port[row], f"{label}/sgd/decoupled_noskip/new/")
        assert max_diff(got, want) <= SGD_ATOL
        assert max_diff(got, port_leaves(port[row], f"{label}/sgd/decoupled/new/")) == 0.0
    assert float(port[0][f"{label}/sgd/decoupled_noskip/loss"]) == pytest.approx(
        float(jax_out[f"{label}/sgd/decoupled_noskip/loss"][0]), rel=LOSS_REL)


def check_zero1_off(world, cases, label: str) -> None:
    """``zero1=False``: the reference's losses; the port's ZeRO-1 run's
    parameters within `ZERO1_ATOL`; whole moments held on every row,
    ``N_ROWS`` times ZeRO-1's parts (less their padding)."""
    jax_out, port = world
    want = jax_out[f"{label}/adamw/overlap_whole/loss"]
    for row in range(N_ROWS):
        np.testing.assert_allclose(port[row][f"{label}/adamw/overlap_whole/loss"], want,
                                   rtol=LOSS_REL)
        whole = port_leaves(port[row], f"{label}/adamw/overlap_whole/params/")
        assert max_diff(whole, port_leaves(port[row], f"{label}/adamw/overlap/params/")) \
            <= ZERO1_ATOL
    held = int(port[0][f"{label}/adamw/overlap_whole/moment_bytes"])
    part = int(port[0][f"{label}/adamw/overlap/moment_bytes"])
    assert held == 2 * 4 * sum(x.size for x in port_leaves(port[0], f"{label}/adamw/overlap/"
                                                                    f"params/"))
    assert N_ROWS * part - held < 2 * 4 * N_ROWS  # the parts pad to a multiple of the rows


def check_crash_resume(world, cases, label: str) -> None:
    """The crash at step 2 after its save; the resumed run's step 3 equal to
    the straight conventional run's bit for bit; the step-2 files on one
    row in one process give the reference's step-3 loss; the files read
    by the reference's `restore` equal the port's state bit for bit."""
    import jax.numpy as jnp

    from repro.io import checkpoint as jckpt
    from repro_torch.utils.treeutil import tree_map

    jax_out, port = world
    name = case_of(cases, label)["name"]
    p0 = port[0]
    assert bool(p0[f"{label}/crash/raised"])
    straight = p0[f"{label}/adamw/conventional/loss"]
    np.testing.assert_array_equal(p0[f"{label}/crash/loss"], straight[:FAMILY_CRASH_AT])
    assert int(p0[f"{label}/crash/resumed"]) == FAMILY_CRASH_AT
    np.testing.assert_array_equal(p0[f"{label}/crash/resumed_loss"], straight[FAMILY_CRASH_AT:])
    final = port_leaves(p0, f"{label}/crash/params/")
    assert max_diff(final, port_leaves(p0, f"{label}/adamw/conventional/params/")) == 0.0
    want = jax_out[f"{label}/adamw/conventional/loss"]
    assert int(p0[f"{label}/elastic/step"]) == FAMILY_CRASH_AT
    assert float(p0[f"{label}/elastic/loss"]) == pytest.approx(float(want[FAMILY_CRASH_AT]),
                                                               rel=LOSS_REL)
    # the reference reads the port's last files (step 3) in the port's tree
    cfg = dataclasses.replace(get_smoke(name), dtype=torch.float32)
    tree = params_from_numpy(unflatten_params(jax_out, f"{label}/p0/"), cfg, "cpu",
                             param_dtype=torch.float32)
    zeros = tree_map(lambda t: jnp.zeros(tuple(t.shape), jnp.float32), tree)
    like = {"opt": {"m": zeros, "step": 0, "v": zeros}, "params": zeros, "step": 0}
    back = jckpt.restore(str(p0[f"{label}/crash/dir"]), FAMILY_STEPS, like)
    got = [np.asarray(x) for x in tree_flatten(tree_map(np.asarray, back["params"]))[0]]
    assert len(got) == len(final)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, final))
    assert int(back["step"]) == FAMILY_STEPS
