"""PyTorch port, the training slice: the optimizer, `model.loss` and its
gradient, the decoupled train step (with and without the analytics
chain) in an 8-rank gloo world on the CPU, and a 3-step `Trainer` run,
each against the JAX package on the same parameters and batches (the
f32 smoke configs; the JAX multi-device run on 8 fake CPU devices in a
subprocess, an (8, 1) mesh, ``reduce_alpha=0.25``, ``wire_chunk_bytes=
65536``).

Tolerances: the optimizer 1e-6 relative (the same f32 arithmetic,
scalars computed in f32 on both sides); the loss 1e-5 relative and its
gradient 1e-5 of the largest gradient element (summation order of the
matmuls and of the chunked cross-entropy); one SGD step with lr 1 (new
params = params - gradient) 1e-5 absolute, the reference's own budget
for decoupled against conventional (tests/test_multidevice.py); the
int8 wire 1e-2 of the largest gradient element (`INT8_GRAD_ERR`); the
trainer's losses 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import build as j_build
from repro.train import optimizer as jopt
from repro_torch.configs import get_smoke
from repro_torch.models.model_zoo import build, synthetic_batch
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import value_and_grad
from repro_torch.launch.mesh import Mesh, make_host_mesh, spawn
from repro_torch.launch.train import parse_args
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.treeutil import tree_flatten, tree_leaves
from torch_worlds import ALPHA, N_ROWS, train_cases, unflatten_params

SEQ = 32
# the int8 wire's error budget, relative to max |gradient|: one scale per
# 64 KiB chunk, each of 3 compute rows rounded once (measured 6.1e-3 in
# both packages on this test's batch; compute row 1 dropped is 0.78)
INT8_GRAD_ERR = 0.01


def _opt_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(4, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(7,)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("kind,clip", [("adamw", 1.0), ("adamw", 0.0), ("sgdm", 0.5)])
def test_apply_updates_matches_jax(kind, clip):
    cfg_kw = dict(kind=kind, lr=3e-3, grad_clip=clip, warmup_steps=2, total_steps=5,
                  weight_decay=0.1)
    jcfg, tcfg = jopt.OptConfig(**cfg_kw), opt.OptConfig(**cfg_kw)
    p = _opt_tree(0)
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)
    js, ts = jopt.init_opt_state(jcfg, jp), opt.init_opt_state(tcfg, tp)
    for step in range(4):
        g = _opt_tree(10 + step, scale=3.0)
        jp, js = jopt.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = opt.apply_updates(tcfg, tp, jax.tree.map(torch.from_numpy, g), ts,
                                   inplace=step % 2 == 1)
        assert ts["step"] == int(js["step"])
        assert opt.schedule_lr(tcfg, ts["step"]) == pytest.approx(
            float(jopt.schedule_lr(jcfg, js["step"])), rel=1e-6)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    for key in ("m", "v"):
        if key in js:
            for a, b in zip(jax.tree.leaves(js[key]), tree_leaves(ts[key])):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
def test_sliced_inplace_update_is_the_whole_update(monkeypatch, kind):
    """An in-place update of a leaf over `UPDATE_SLICE` elements goes slice
    by slice: bit for bit the functional update of the whole leaf, written
    into the given tensors."""
    monkeypatch.setattr(opt, "UPDATE_SLICE", 1000)
    cfg = opt.OptConfig(kind=kind, lr=1e-2, warmup_steps=0, total_steps=5, grad_clip=1.0)
    p = {"a": _opt_tree(0)["a"].repeat(200, 1).reshape(-1), "b": _opt_tree(1)["a"]}
    g = {k: np.random.default_rng(2).normal(size=v.shape).astype(np.float32)
         for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    want_p, want_s = opt.apply_updates(cfg, tp, tg, opt.init_opt_state(cfg, tp))
    live = {k: v.clone() for k, v in tp.items()}
    state = opt.init_opt_state(cfg, live)
    got_p, got_s = opt.apply_updates(cfg, live, tg, state, inplace=True)
    assert all(got_p[k] is live[k] and got_s["m"][k] is state["m"][k] for k in p)
    assert live["a"].numel() > 1000 >= live["b"].numel()
    for key in [k for k in ("m", "v") if k in want_s]:
        for k in p:
            assert torch.equal(got_s[key][k], want_s[key][k])
    assert all(torch.equal(got_p[k], want_p[k]) for k in p)


def _reference(name, seed=0, batch=3):
    """The f32 smoke config's reference model, params and a masked batch."""
    jcfg = dataclasses.replace(j_get_smoke(name), dtype=jnp.float32)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    mask = np.ones((batch, SEQ), np.float32)
    mask[-1, SEQ // 2:] = 0.0
    data = {"tokens": rng.integers(0, jcfg.vocab_size, (batch, SEQ)).astype(np.int32),
            "labels": rng.integers(0, jcfg.vocab_size, (batch, SEQ)).astype(np.int32),
            "mask": mask}
    return jmodel, jparams, data


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen1.5-0.5b"])
def test_loss_and_gradient_match_jax(name):
    jmodel, jparams, data = _reference(name)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, data))
    cfg = dataclasses.replace(get_smoke(name), dtype=torch.float32)
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                               param_dtype=torch.float32)
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))
    loss, metrics, grads = value_and_grad(
        model.loss, params, {k: torch.from_numpy(v) for k, v in data.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(metrics["ce"]) == float(loss)
    want = params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg, "cpu",
                             param_dtype=torch.float32)
    gmax = max(float(g.abs().max()) for g in tree_leaves(want))
    for a, b in zip(tree_leaves(want), tree_leaves(grads)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5 * gmax)


def test_model_loss_without_autograd_needs_no_checkpoint():
    _, jparams, data = _reference("qwen1.5-0.5b")
    cfg = dataclasses.replace(get_smoke("qwen1.5-0.5b"), dtype=torch.float32)
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                               param_dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    with torch.no_grad():
        plain, _ = model.loss(params, batch)
    tracked, _, _ = value_and_grad(model.loss, params, batch)
    assert float(plain) == float(tracked)


def test_unported_modes_and_options_are_refused():
    """What is still unported raises naming its ROADMAP item: the adaptive
    trainer and the in-memory reshard on a model axis (A8). Every family
    builds on a model axis, at the launcher's default ``--model 2`` (held
    against the reference in tests/test_torch_model_axis.py and
    tests/test_torch_model_axis_families.py). Every family now trains: the MoE, hybrid, VLM and
    encoder-decoder models build their step in each mode, and the
    reference's ``runtime_skip``, ``zero1``, ``fsdp`` and
    ``fsdp_threshold`` options are fields of `TrainStepConfig`, FSDP's
    with the reference's defaults (held against the reference in
    tests/test_torch_train_moe.py, tests/test_torch_train_families.py and
    tests/test_torch_fsdp.py). `reshard_state` between meshes of different
    sizes is refused by design (one gloo world has one size; the serving
    fleet moves its global layout on the host, tests/test_torch_fleet.py).
    Checkpoints, the conventional and overlap steps over many rows and
    adaptive sizing are ported (tests/test_torch_trainer.py)."""
    from repro_torch.core.adapt import AdaptPolicy
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.launch.elastic import reshard_state
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainStepConfig, make_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    with pytest.raises(ValueError, match="one gloo world has one size"):
        reshard_state({"x": torch.zeros(4)},
                      GroupedMesh.build_rows(Mesh(n_rows=8, device="cpu"), rows={"reduce": 2}),
                      GroupedMesh.build_rows(Mesh(n_rows=4, device="cpu"), rows={"reduce": 1}))
    assert make_host_mesh(4, 2, device="cpu").shape == {"data": 4, "model": 2}
    assert parse_args(["--smoke", "--device", "cpu"]).model == 2
    for name in ("mixtral-8x7b", "llama4-scout-17b-a16e", "hymba-1.5b", "whisper-small",
                 "pixtral-12b", "mamba2-130m"):
        mesh = make_host_mesh(4, 2, device="cpu")
        assert build(get_smoke(name), device="cpu", tp=mesh).tp is mesh
    mesh = make_host_mesh(4, 2, device="cpu")
    model = build(get_smoke("hymba-1.5b"), device="cpu", tp=mesh)
    with pytest.raises(ValueError, match="ROADMAP A8"):
        Trainer(model, mesh, None, OptConfig(), TrainStepConfig(mode="decoupled"),
                TrainerConfig(adapt=AdaptPolicy()))
    g = GroupedMesh.build_rows(mesh, rows={"reduce": 1})
    with pytest.raises(ValueError, match="ROADMAP A8"):
        reshard_state({"x": torch.zeros(4)}, g, g)
    fields = {f.name for f in dataclasses.fields(TrainStepConfig)}
    assert {"runtime_skip", "zero1", "fsdp", "fsdp_threshold"} <= fields
    assert (TrainStepConfig().fsdp, TrainStepConfig().fsdp_threshold) == ("auto", 6e9)
    for name in ("mixtral-8x7b", "hymba-1.5b", "whisper-small", "pixtral-12b"):
        model = build(get_smoke(name), device="cpu")
        for mode in ("conventional", "decoupled", "overlap"):
            step = make_step(model, Mesh(n_rows=8, device="cpu"), OptConfig(),
                             TrainStepConfig(mode=mode))
            assert callable(step) and step.timings == []


JAX_TRAIN = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke
from repro.data.pipeline import DataConfig, Pipeline
from repro.models import build
from repro.train.optimizer import OptConfig, init_opt_state
from repro.train.train_step import TrainStepConfig, make_jitted_step
from repro.utils.compat import make_mesh
inp = dict(np.load({inputs!r}))
mesh = make_mesh(({n}, 1), ("data", "model"))
cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=jnp.float32)
model = build(cfg)
params = model.init(jax.random.PRNGKey(0))
sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
batch = {{k: jnp.asarray(inp["batch/" + k]) for k in ("tokens", "labels", "mask")}}
params_like = jax.eval_shape(lambda: params)
out = {{}}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

with jax.set_mesh(mesh):
    for name, kw in [("decoupled", dict(mode="decoupled", reduce_alpha={alpha},
                                        wire_chunk_bytes=65536)),
                     ("analytics", dict(mode="decoupled", reduce_alpha={alpha},
                                        analytics_alpha=0.125, wire_chunk_bytes=65536)),
                     ("int8", dict(mode="decoupled", reduce_alpha={alpha}, compress="int8",
                                   wire_chunk_bytes=65536)),
                     ("conventional", dict(mode="conventional"))]:
        step, _ = make_jitted_step(model, mesh, sgd, TrainStepConfig(**kw), params_like, batch,
                                   donate=False)
        new, _, m = step(params, init_opt_state(sgd, params), batch)
        flat(new, name + "/new/")
        for k in ("loss", "grad_norm", "grad_absmax", "work_rows"):
            if k in m:
                out[name + "/metric/" + k] = np.asarray(m[k])
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len={seq}, global_batch=6,
                               kind="zipf", skew=0.4))
    adamw = OptConfig(lr=1e-3, warmup_steps=10, total_steps=3)
    ts = TrainStepConfig(mode="decoupled", reduce_alpha={alpha}, wire_chunk_bytes=65536)
    step, _ = make_jitted_step(model, mesh, adamw, ts, params_like,
                               pipe.padded_for_groups(0, 6, {n}), donate=False)
    p, o, losses = params, init_opt_state(adamw, params), []
    for s in range(3):
        p, o, m = step(p, o, pipe.padded_for_groups(s, 6, {n}))
        losses.append(float(m["loss"]))
    out["trainer/loss"] = np.asarray(losses, np.float64)
flat(params, "p0/")
np.savez({outputs!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX run, then the port's world on its initial parameters."""
    from conftest import run_multidevice

    tmp = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(1)
    vocab = get_smoke("tinyllama-1.1b").vocab_size
    mask = np.ones((16, SEQ), np.float32)
    mask[6:] = 0.0  # six real sequences, on compute rows 0-2
    mask[2, SEQ // 2:] = 0.0
    batch = {"batch/tokens": rng.integers(0, vocab, (16, SEQ)).astype(np.int32),
             "batch/labels": rng.integers(0, vocab, (16, SEQ)).astype(np.int32),
             "batch/mask": mask}
    path = str(tmp / "inputs.npz")
    np.savez(path, **batch)
    jax_path = str(tmp / "jax.npz")
    run_multidevice(JAX_TRAIN.format(inputs=path, outputs=jax_path, n=N_ROWS, alpha=ALPHA,
                                     seq=SEQ), n_devices=N_ROWS, timeout=600)
    jax_out = dict(np.load(jax_path))
    both = str(tmp / "both.npz")
    np.savez(both, **batch, **{k: v for k, v in jax_out.items() if k.startswith("p0/")})
    port = spawn(train_cases, N_ROWS, device="cpu", args=(both, str(tmp / "ckpt")),
                 timeout_s=240)
    return jax_out, port


def _port_leaves(out, prefix):
    n = sum(1 for k in out if k.startswith(prefix))
    return [out[f"{prefix}{i}"] for i in range(n)]


def _jax_leaves(jax_out, prefix):
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    tree = params_from_numpy(unflatten_params(jax_out, prefix), cfg, "cpu",
                             param_dtype=torch.float32)
    return [t.numpy() for t in tree_flatten(tree)[0]]


@pytest.mark.parametrize("name", ["decoupled", "analytics"])
def test_decoupled_step_matches_jax(world, name):
    jax_out, port = world
    want = _jax_leaves(jax_out, f"{name}/new/")
    for row in range(N_ROWS):  # every row applies the same update
        got = _port_leaves(port[row], f"{name}/new/")
        assert len(got) == len(want)
        assert max(float(np.abs(a - b).max()) for a, b in zip(got, want)) <= 1e-5
    p0 = _jax_leaves(jax_out, "p0/")
    assert max(float(np.abs(a - b).max()) for a, b in zip(p0, want)) > 1e-3  # it moved
    for key in ("loss", "grad_norm", "grad_absmax"):
        jk = f"{name}/metric/{key}"
        if jk in jax_out:
            assert float(port[0][jk]) == pytest.approx(float(jax_out[jk]), rel=1e-5)
    np.testing.assert_array_equal(port[0][f"{name}/work_rows"],
                                  jax_out[f"{name}/metric/work_rows"])
    assert (f"{name}/metric/grad_norm" in jax_out) == (name == "analytics")


def test_decoupled_step_matches_conventional(world):
    jax_out, port = world
    conv = _port_leaves(port[0], "conventional/new/")
    np.testing.assert_allclose(
        [float(np.abs(a - b).max()) for a, b in
         zip(conv, _jax_leaves(jax_out, "conventional/new/"))], 0.0, atol=1e-5)
    for name in ("decoupled", "analytics"):
        got = _port_leaves(port[0], f"{name}/new/")
        assert max(float(np.abs(a - b).max()) for a, b in zip(got, conv)) <= 1e-5
    assert float(port[0]["conventional/metric/loss"]) == pytest.approx(
        float(port[0]["decoupled/metric/loss"]), rel=1e-6)


def test_int8_wire_step_stays_within_the_references_budget(world):
    """The int8 gradient wire against the conventional step (SGD at lr 1:
    the difference is the error of the gradient), in both packages, within
    INT8_GRAD_ERR of the largest gradient element; the port against the
    reference within twice it (each side's error is up to one budget, by
    rounding edges apart). A planted fault (compute row 1's gradient
    dropped, or sent twice) must exceed the budget by far, so a wire that
    loses a row cannot pass."""
    jax_out, port = world
    p0 = _jax_leaves(jax_out, "p0/")
    conv = _port_leaves(port[0], "conventional/new/")
    gmax = max(float(np.abs(a - b).max()) for a, b in zip(p0, conv))
    assert gmax > 1e-3  # it moved

    def err(x, y):
        return max(float(np.abs(a - b).max()) for a, b in zip(x, y)) / gmax

    got = _port_leaves(port[0], "int8/new/")
    want = _jax_leaves(jax_out, "int8/new/")
    assert 0 < err(got, conv) <= INT8_GRAD_ERR  # a lossy wire, within budget
    assert err(want, conv) <= INT8_GRAD_ERR
    assert err(got, want) <= 2 * INT8_GRAD_ERR
    # row 1's share of the update: (p0 - new on its shard alone) x its token share
    share = [(a - b) * port[0]["row1/share"]
             for a, b in zip(p0, _port_leaves(port[0], "row1/new/"))]
    dropped = [c + d for c, d in zip(conv, share)]
    doubled = [c - d for c, d in zip(conv, share)]
    assert min(err(dropped, conv), err(doubled, conv)) > 10 * INT8_GRAD_ERR


def test_synthetic_batch_feeds_the_loss():
    cfg = dataclasses.replace(get_smoke("qwen1.5-0.5b"), dtype=torch.float32)
    model = build(cfg, device="cpu")
    batch = synthetic_batch(cfg, 2, SEQ, seed=3, device="cpu")
    assert batch["tokens"].shape == batch["labels"].shape == (2, SEQ)
    assert batch["tokens"].dtype == torch.int32 and batch["mask"].dtype == torch.float32
    assert int(batch["tokens"].max()) < cfg.vocab_size and bool(batch["mask"].all())
    loss, _ = model.loss(model.init(0, param_dtype=torch.float32), batch)
    assert np.isfinite(float(loss))
    assert torch.equal(synthetic_batch(cfg, 2, SEQ, seed=3, device="cpu")["tokens"],
                       batch["tokens"])


def test_trainer_losses_match_the_jax_step_loop(world):
    jax_out, port = world
    want = jax_out["trainer/loss"]
    assert np.isfinite(want).all() and len(want) == 3
    for row in range(N_ROWS):
        np.testing.assert_allclose(port[row]["trainer/loss"], want, rtol=1e-5)
