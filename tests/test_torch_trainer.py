"""PyTorch port, the training path as users launch it: the data-parallel
conventional step and the ZeRO-1 overlap step in an 8-rank gloo world on
the CPU, each against the JAX package's `make_jitted_step` on an (8, 1)
mesh of fake CPU devices; the reference's crash -> resume -> elastic
sequence (decoupled on 8 rows crashing at step 5, then conventional on 4
rows to step 8) against the reference's `Trainer`; and checkpoints that
cross between overlap and conventional mode. The f32 tinyllama smoke
config, the reference's parameters (`params_from_numpy`). And the
reference's adaptive drill: the decoupled trainer with the adaptive loop
on the f32 qwen2.5-3b smoke config, one reduce row of 8 to start, every
step's wall a constant in both packages (the decisions then depend on the
token counts alone). One JAX subprocess, then the port's 8-row world and
its 4-row world.

Tolerances:
  * one SGD step (lr 1: new params = params - gradient), 1e-5 absolute:
    the reference's own budget for its step modes against each other
    (tests/test_multidevice.py); the batch is that test's, masked from
    sequence 6 on, so rows 6 and 7 hold no real token;
  * three AdamW steps with a clip a quarter of the batches' smallest
    gradient norm: parameters `ADAMW_ATOL` absolute (a tenth of one
    step's move, see there), moments 1e-5 of their largest element
    (summation order of the gradients and of the norm);
  * losses 1e-5 relative (test_torch_train_step.py's);
  * checkpoints: what a trainer saved reads back bit for bit; a run that
    crosses modes at a checkpoint ends within the AdamW budget of one mode
    run straight through;
  * the adaptive trainer: its regroup log identical (step, rows), the
    predicted speedup within 1e-12 relative; losses 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import spawn
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.treeutil import tree_flatten
from torch_worlds import (
    ADAMW_LR,
    ADAMW_STEPS,
    ADAPT_STEP_WALL,
    ADAPT_TRAIN,
    CRASH,
    MOMENT_STEPS,
    N_ROWS,
    elastic_case,
    trainer_cases,
    unflatten_params,
)

# AdamW moves an element by up to about lr per step whatever its
# gradient's size: an element whose gradients are near their f32 rounding
# noise (1e-6 of the largest) is moved up to a full step in a direction
# that noise sets. So the parameters are held to a tenth of one step's
# move (a wrong learning rate, schedule or step count shows; measured
# <= 0.04 lr), and the clip and the gradients themselves through the
# moments, which are linear and quadratic in the clipped gradients.
ADAMW_ATOL = 0.1 * ADAMW_LR
SGD_ATOL = 1e-5
MOMENT_REL = 1e-5
LOSS_REL = 1e-5

JAX_TRAIN = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke
from repro.data.pipeline import DataConfig, Pipeline
from repro.models import build, synthetic_batch
from repro.train.optimizer import OptConfig, init_opt_state
from repro.train.train_step import TrainStepConfig, make_jitted_step
from repro.train.trainer import SimulatedFailure, Trainer, TrainerConfig
from repro.utils.compat import make_mesh
mesh = make_mesh(({n}, 1), ("data", "model"))
cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=jnp.float32)
model = build(cfg)
params = model.init(jax.random.PRNGKey(0))
params_like = jax.eval_shape(lambda: params)
out = {{}}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

# the batch of tests/test_multidevice.py::test_decoupled_equals_conventional_grads
batch = synthetic_batch(cfg, 8, 32)
mask = np.asarray(batch["mask"]).copy(); mask[6:] = 0.0
batch["mask"] = jnp.asarray(mask)
for k, v in batch.items():
    out["batch/" + k] = np.asarray(v)
sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                           kind="zipf", skew=0.4))
batches = [pipe.global_batch(s) for s in range({steps})]
norms = [float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(
    jax.grad(lambda p, b: model.loss(p, b)[0])(params, b))))) for b in batches]
clip = min(norms) / 4
out["clip"], out["norms"] = np.float32(clip), np.asarray(norms)
adamw = OptConfig(lr={lr}, warmup_steps=0, total_steps={steps}, grad_clip=clip)
with jax.set_mesh(mesh):
    for mode in ("conventional", "overlap"):
        step, sh = make_jitted_step(model, mesh, sgd, TrainStepConfig(mode=mode), params_like,
                                    batch, donate=False)
        new, _, m = step(jax.device_put(params, sh[0]),
                         jax.device_put(init_opt_state(sgd, params), sh[1]), batch)
        flat(new, f"sgd/{{mode}}/new/")
        out[f"sgd/{{mode}}/loss"] = np.asarray([float(m["loss"])])
        step, sh = make_jitted_step(model, mesh, adamw, TrainStepConfig(mode=mode),
                                    params_like, batches[0], donate=False)
        p, o = jax.device_put(params, sh[0]), jax.device_put(init_opt_state(adamw, params), sh[1])
        losses = []
        for b in batches:
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
        flat(p, f"adamw/{{mode}}/params/")
        flat(o["m"], f"adamw/{{mode}}/m/")
        flat(o["v"], f"adamw/{{mode}}/v/")
        out[f"adamw/{{mode}}/loss"] = np.asarray(losses)
flat(params, "p0/")

# the reference's crash -> resume -> elastic sequence, losses logged every step
c = {crash!r}
cpipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq"],
                            global_batch=c["global_batch"]))
copt = OptConfig(lr=c["lr"], warmup_steps=c["warmup"], total_steps=c["total"])
with jax.set_mesh(mesh):
    tr = Trainer(model, mesh, cpipe, copt, TrainStepConfig(mode="decoupled", reduce_alpha=0.25),
                 TrainerConfig(total_steps=c["steps"], ckpt_every=c["ckpt_every"],
                               ckpt_dir={ckpt!r}, log_every=1, fail_at_step=c["fail_at"]))
    try:
        tr.run(); raise SystemExit("expected failure")
    except SimulatedFailure:
        pass
    tr.close()
out["crash/loss"] = np.asarray([r["loss"] for r in tr.metrics_log])
mesh2 = make_mesh((4, 1), ("data", "model"))
with jax.set_mesh(mesh2):
    tr2 = Trainer(model, mesh2, cpipe, copt, TrainStepConfig(mode="conventional"),
                  TrainerConfig(total_steps=c["steps"], ckpt_every=c["ckpt_every"],
                                ckpt_dir={ckpt!r}, log_every=1))
    state = tr2.run(); tr2.close()
assert state["step"] == c["steps"]
out["elastic/loss"] = np.asarray([r["loss"] for r in tr2.metrics_log])
flat(state["params"], "elastic/final/")

# the reference's adaptive drill (tests/test_dataflow.py): the decoupled
# trainer with the adaptive loop on the qwen2.5-3b smoke config, 8 rows,
# one reduce row to start, every step's wall a constant
import time, types
import repro.train.trainer as trmod
from repro.core.adapt import AdaptPolicy
qcfg = dataclasses.replace(get_smoke("qwen2.5-3b"), dtype=jnp.float32)
qmodel = build(qcfg)
flat(qmodel.init(jax.random.PRNGKey(0)), "q0/")
clock = {{"t": 0.0}}

def tick():
    clock["t"] += {step_wall}
    return clock["t"]

trmod.time = types.SimpleNamespace(perf_counter=tick, time=time.time)
a = {adapt!r}
qpipe = Pipeline(DataConfig(vocab_size=qcfg.vocab_size, seq_len=a["seq"],
                            global_batch=a["global_batch"]))
with jax.set_mesh(mesh):
    tr = Trainer(qmodel, mesh, qpipe, OptConfig(lr=a["lr"], warmup_steps=a["warmup"],
                                                total_steps=a["total"]),
                 TrainStepConfig(mode="decoupled", reduce_alpha=a["reduce_alpha"]),
                 TrainerConfig(total_steps=a["steps"], ckpt_every=100, ckpt_dir={ckpt!r} + "_adapt",
                               log_every=1, adapt=AdaptPolicy(**a["policy"])))
    tr.run(resume=False)
    tr.close()
out["adapt/loss"] = np.asarray([r["loss"] for r in tr.metrics_log])
out["adapt/log"] = np.asarray([[e["step"], e["regroup"]["reduce"], e["predicted_speedup"]]
                               for e in tr.adapt_log], np.float64).reshape(-1, 3)
np.savez({outputs!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX run, then the port's 8-row world and its 4-row world on the
    reference's initial parameters and batch."""
    from conftest import run_multidevice

    tmp = tmp_path_factory.mktemp("trainer")
    jax_path = str(tmp / "jax.npz")
    run_multidevice(JAX_TRAIN.format(outputs=jax_path, n=N_ROWS, steps=ADAMW_STEPS,
                                     lr=ADAMW_LR, crash=CRASH, adapt=ADAPT_TRAIN,
                                     step_wall=ADAPT_STEP_WALL,
                                     ckpt=str(tmp / "jax_ckpt")),
                    n_devices=N_ROWS, timeout=600)
    jax_out = dict(np.load(jax_path))
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **{k: v for k, v in jax_out.items()
                        if k.startswith(("p0/", "q0/", "batch/")) or k == "clip"})
    ckpt_root = str(tmp / "port_ckpt")
    port = spawn(trainer_cases, N_ROWS, device="cpu", args=(inputs, ckpt_root), timeout_s=300)
    elastic = spawn(elastic_case, N_ROWS // 2, device="cpu", args=(inputs, ckpt_root),
                    timeout_s=300)
    return jax_out, port, elastic


def _port(out, prefix):
    n = sum(1 for k in out if k.startswith(prefix) and k[len(prefix):].isdigit())
    return [out[f"{prefix}{i}"] for i in range(n)]


def _jax(jax_out, prefix):
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    tree = params_from_numpy(unflatten_params(jax_out, prefix), cfg, "cpu",
                             param_dtype=torch.float32)
    return [t.numpy() for t in tree_flatten(tree)[0]]


def _maxdiff(xs, ys):
    assert len(xs) == len(ys) > 0
    return max(float(np.abs(a - b).max()) for a, b in zip(xs, ys))


def _absmax(xs):
    return max(float(np.abs(a).max()) for a in xs)


@pytest.mark.parametrize("mode", ["conventional", "overlap"])
def test_sgd_step_matches_jax(world, mode):
    jax_out, port, _ = world
    want = _jax(jax_out, f"sgd/{mode}/new/")
    assert _maxdiff(_jax(jax_out, "p0/"), want) > 1e-3  # it moved
    for row in range(N_ROWS):  # every row holds the same parameters
        assert _maxdiff(_port(port[row], f"sgd/{mode}/new/"), want) <= SGD_ATOL
        np.testing.assert_allclose(port[row][f"sgd/{mode}/loss"], jax_out[f"sgd/{mode}/loss"],
                                   rtol=LOSS_REL)
    phases = {"conventional": ["fwd_bwd_s", "all_reduce_s", "update_s"],
              "overlap": ["fwd_bwd_s", "reduce_scatter_s", "update_s", "all_gather_s"]}[mode]
    assert set(phases) <= set(port[0][f"sgd/{mode}/phases"])


@pytest.mark.parametrize("mode", ["conventional", "overlap"])
def test_adamw_steps_with_a_binding_clip_match_jax(world, mode):
    jax_out, port, _ = world
    assert float(jax_out["clip"]) < jax_out["norms"].min() / 2  # the clip binds
    for part, check in (("params", lambda g, w: _maxdiff(g, w) <= ADAMW_ATOL),
                        ("m", lambda g, w: _maxdiff(g, w) <= MOMENT_REL * _absmax(w)),
                        ("v", lambda g, w: _maxdiff(g, w) <= MOMENT_REL * _absmax(w))):
        want = _jax(jax_out, f"adamw/{mode}/{part}/")
        for row in range(N_ROWS):
            assert check(_port(port[row], f"adamw_clip/{mode}/{part}/"), want), (part, row)
    for row in range(N_ROWS):
        np.testing.assert_allclose(port[row][f"adamw_clip/{mode}/loss"],
                                   jax_out[f"adamw/{mode}/loss"], rtol=LOSS_REL)
    # the clip changed the update: the moments by far more than their
    # budget (about the clip's factor), the parameters by more than theirs
    for part, budget in (("m", 0.1), ("params", ADAMW_ATOL)):
        clipped = _port(port[0], f"adamw_clip/{mode}/{part}/")
        unclipped = _port(port[0], f"adamw_noclip/conventional/{part}/")
        scale = _absmax(unclipped) if part == "m" else 1.0
        assert _maxdiff(clipped, unclipped) > budget * scale, part


def test_overlap_holds_a_part_of_the_moments(world):
    _, port, _ = world
    whole = sum(a.size for a in _port(port[0], "adamw_clip/conventional/m/"))
    parts = [int(port[r]["overlap/moment_elems"]) for r in range(N_ROWS)]
    assert parts == [-(-whole // N_ROWS)] * N_ROWS
    # the bytes a trainer reports holding while it steps: m and v in f32
    for r in range(N_ROWS):
        assert int(port[r]["cross/overlap_then_conventional/0/moment_bytes"]) == 2 * 4 * parts[r]
        assert int(port[r]["cross/overlap_then_conventional/1/moment_bytes"]) == 2 * 4 * whole


def test_crash_resume_and_elastic_match_jax(world):
    jax_out, port, elastic = world
    c = CRASH
    for row in range(N_ROWS):
        assert bool(port[row]["crash/raised"])
        np.testing.assert_allclose(port[row]["crash/loss"], jax_out["crash/loss"],
                                   rtol=LOSS_REL)
    assert len(jax_out["crash/loss"]) == c["fail_at"]
    assert int(port[0]["crash/latest"]) == 3
    for row in range(N_ROWS // 2):
        e = elastic[row]
        assert int(e["resumed"]) == 3 and int(e["step"]) == c["steps"]
        assert list(e["steps"]) == list(range(4, c["steps"] + 1))
        np.testing.assert_allclose(e["loss"], jax_out["elastic/loss"], rtol=LOSS_REL)
        assert _maxdiff(_port(e, "final/"), _jax(jax_out, "elastic/final/")) <= ADAMW_ATOL


@pytest.mark.parametrize("name", ["overlap_then_conventional", "conventional_then_overlap"])
def test_checkpoint_moments_cross_modes(world, name):
    _, port, _ = world
    straight = {p: _port(port[0], f"cross/straight/0/{p}/") for p in ("params", "m", "v")}
    for row in range(N_ROWS):
        first = f"cross/{name}/0"
        # the first mode's files hold its whole moments, bit for bit
        for p in ("m", "v"):
            assert _maxdiff(_port(port[row], f"{first}/saved_{p}/"),
                            _port(port[row], f"{first}/{p}/")) == 0.0
        assert list(port[row][f"{first}/steps"]) == list(range(1, MOMENT_STEPS + 1))
        then = f"cross/{name}/1"
        assert list(port[row][f"{then}/steps"]) == [MOMENT_STEPS + 1]  # resumed
        assert _maxdiff(_port(port[row], f"{then}/params/"), straight["params"]) <= ADAMW_ATOL
        for p in ("m", "v"):
            assert _maxdiff(_port(port[row], f"{then}/{p}/"), straight[p]) \
                <= MOMENT_REL * _absmax(straight[p])


def test_adaptive_trainer_matches_jax(world):
    """The reference's regroup: one reduce row to three after step 3
    (predicted speedup 1.2406...), the same on every row, and the losses
    of all six steps, before and after it, within the loss budget."""
    jax_out, port, _ = world
    want = jax_out["adapt/log"]
    assert want.shape == (1, 3) and list(want[0, :2]) == [3, 3]
    assert abs(want[0, 2] - 1.2406182890164847) <= 1e-12 * want[0, 2]
    for row in range(N_ROWS):
        got = port[row]["adapt/log"]
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-12)
        assert list(port[row]["adapt/steps"]) == list(range(1, ADAPT_TRAIN["steps"] + 1))
        np.testing.assert_allclose(port[row]["adapt/loss"], jax_out["adapt/loss"], rtol=LOSS_REL)
        assert int(port[row]["adapt/reduce_rows"]) == 3
