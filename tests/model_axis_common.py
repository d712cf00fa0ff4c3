"""Shared by tests/test_torch_model_axis.py and
tests/test_torch_model_axis_families.py: the reference's runs of a list of
model-axis cases (`model_axis_worlds.model_axis_cases` describes them) in
one JAX subprocess on ``make_host_mesh(2, 2)`` with 4 fake devices, beside
the port's (2, 2) world of four CPU ranks, then the (2, 1) and (1, 2)
worlds that restore its checkpoints (`model_axis_worlds.restore_case`);
and the reference-side helpers both files hold the port's results with.

The reference's decoupled step does not run on a (2, 2) mesh of CPU
devices under jax 0.9.0 (tests/test_torch_model_axis.py says why), so
its conventional step runs on the decoupled layout's batch in its place.
A case with ``replicate_ssm`` runs with ``REPRO_REPLICATE_SSM=1`` on the
reference's side and ``build(..., replicate_ssm=True)`` on the port's.
"""
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from model_axis_worlds import (
    CKPT_EVERY,
    CLIP,
    DATA,
    MODEL,
    case_config,
    model_axis_cases,
    restore_case,
)
from repro.configs import get_smoke as j_get_smoke
from repro.models import build as j_build
from repro.train import sharding as j_sharding
from repro_torch.launch.mesh import spawn
from repro_torch.models.model_zoo import build
from repro_torch.train import sharding
from repro_torch.train.train_step import param_shapes
from repro_torch.utils.treeutil import tree_flatten, tree_unflatten
from torch_worlds import ADAMW_LR, FAMILY_ALPHA, FAMILY_STEPS

RESTORE_WORLDS = ((2, 1), (1, 2))

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
        os.environ["REPRO_REPLICATE_SSM"] = "1" if c.get("replicate_ssm") else ""
        cfg = dataclasses.replace(get_smoke(c["name"]), dtype=jnp.float32)
        if c.get("n_kv_heads"):
            cfg = dataclasses.replace(cfg, n_kv_heads=c["n_kv_heads"])
        if c.get("n_experts"):
            cfg = dataclasses.replace(cfg, n_experts=c["n_experts"])
        model = build(cfg)
        params = model.init(jax.random.PRNGKey(0))
        flat(params, c["label"] + "/p0/")
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq"],
                                   global_batch=c["batch"], seed=1, kind="zipf", skew=0.4,
                                   frontend=cfg.frontend,
                                   n_frontend_tokens=cfg.n_frontend_tokens,
                                   d_model=cfg.d_model))
        for fsdp in ((False, True) if c.get("fsdp") else (False,)):
            for mode in c["modes"]:
                if c.get("moe") and mode == "decoupled":  # held to the port's own step
                    continue
                tag = c["label"] + "/" + ("fsdp" if fsdp else "whole") + "/" + mode
                # the decoupled step: the conventional step on its layout's batch
                ts = TrainStepConfig(mode="conventional" if mode == "decoupled" else mode,
                                     reduce_alpha={alpha}, fsdp=fsdp)
                # an MoE case's clip run is held to its own SGD run alone
                runs = [("sgd", 0.0)] + ([("clip", {clip})]
                                         if c.get("clip") and not c.get("moe") else [])
                for name, clip in runs:
                    step, sh = make_jitted_step(model, mesh, sgd(clip), ts,
                                                jax.eval_shape(lambda: params),
                                                batch_of(pipe, mode, 0), donate=False)
                    p, o, m = step(jax.device_put(params, sh[0]),
                                   jax.device_put(init_opt_state(sgd(clip), params), sh[1]),
                                   batch_of(pipe, mode, 0))
                    flat(p, tag + "/" + name + "/new/")
                    out[tag + "/" + name + "/loss"] = np.asarray(m["loss"])
                if not c.get("adamw") or (fsdp and (c.get("moe") or c.get("adamw_whole"))):
                    continue  # trains_adamw
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


def reference_config(case: dict):
    """The reference's f32 smoke config of a case, with its overrides."""
    cfg = dataclasses.replace(j_get_smoke(case["name"]), dtype=jnp.float32)
    overrides = {k: case[k] for k in ("n_kv_heads", "n_experts") if case.get(k)}
    return dataclasses.replace(cfg, **overrides)


def reference_p0(case: dict) -> dict:
    """The reference's initial parameters of a case, as the subprocess
    draws them, keyed as its outputs are."""
    params = j_build(reference_config(case)).init(jax.random.PRNGKey(0))
    return {f"{case['label']}/p0/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def run_worlds(tmp, cases: list, *, port_only: tuple = (), tails: tuple = (),
               restores: tuple = ()) -> dict:
    """The reference's runs of ``cases`` in one JAX subprocess beside the
    port's (2, 2) world over ``cases`` and ``port_only`` (then ``tails``),
    then the (2, 1) world (the one-column SGD steps of ``cases``, and the
    ``restores``) and the (1, 2) world (the ``restores``): ``restores`` are
    (case, run tag) pairs whose (2, 2) step-2 files are restored and resumed."""
    from conftest import run_multidevice

    inputs = str(tmp / "inputs.npz")
    p0 = {}
    for case in list(cases) + list(port_only):
        p0.update(reference_p0(case))
    np.savez(inputs, **p0)
    jax_path = str(tmp / "jax.npz")
    compute = DATA - max(1, int(round(FAMILY_ALPHA * DATA)))
    code = JAX_MODEL_AXIS.format(cases=json.dumps(list(cases)), data=DATA, model=MODEL,
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
                     args=(inputs, ckpt, list(cases) + list(port_only), tails),
                     timeout_s=900)
        restored = {}
        for data, model in RESTORE_WORLDS:
            sgd_cases = list(cases) if (data, model) == (DATA, 1) else []
            restored[(data, model)] = spawn(restore_case, data, model=model, device="cpu",
                                            args=(inputs, ckpt, list(restores), sgd_cases),
                                            timeout_s=600)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return {"jax": dict(np.load(jax_path)), "port": port, "restored": restored, "ckpt": ckpt,
            "p0": p0}


def case_leaves(tree_np: dict, case: dict, prefix: str) -> list:
    """The reference's tree under ``prefix`` as the port's whole leaves."""
    from repro_torch.utils.convert import params_from_numpy
    from torch_worlds import unflatten_params

    tree = params_from_numpy(unflatten_params(tree_np, prefix), case_config(case), "cpu",
                             param_dtype=torch.float32)
    return [t.numpy() for t in tree_flatten(tree)[0]]


def leaf_names(case: dict) -> list:
    shapes = param_shapes(build(case_config(case), device="meta"))
    return [".".join(n) for n, _ in sharding._leaf_paths(shapes)]


def reference_slices(case: dict, whole: list, col: int, ported: list | None = None) -> list:
    """Column ``col``'s slices of the port's whole leaves by the reference's
    own ``param_specs`` of its stacked tree (the port's spec code unused;
    under ``REPRO_REPLICATE_SSM=1`` where the case says ``replicate_ssm``),
    but for the port rule of `sharding.spec_list`: where the reference
    shards a stacked leaf's ``L`` (llama4's shared expert ``w_gate`` and
    ``w_up``), the port slices its last dimension, ff (the leaf's path
    appended to ``ported``)."""
    import os

    like = jax.eval_shape(j_build(reference_config(case)).init, jax.random.PRNGKey(0))
    saved = os.environ.get("REPRO_REPLICATE_SSM")
    os.environ["REPRO_REPLICATE_SSM"] = "1" if case.get("replicate_ssm") else ""
    try:
        specs = j_sharding.param_specs(like, MODEL)
    finally:
        if saved is None:
            del os.environ["REPRO_REPLICATE_SSM"]
        else:
            os.environ["REPRO_REPLICATE_SSM"] = saved
    shapes = param_shapes(build(case_config(case), device="meta"))
    out = []
    for (names, depth), leaf in zip(sharding._leaf_paths(shapes), whole):
        spec = specs
        for k in names:
            spec = spec[k]
        spec = tuple(spec) + (None,) * (leaf.ndim + (depth is not None) - len(tuple(spec)))
        if depth is not None and spec[0] == "model":
            if ported is not None:
                ported.append(".".join(names))
            spec = (None,) * (leaf.ndim - 1) + ("model",)
        else:
            spec = spec[1:] if depth is not None else spec
        if "model" not in spec:
            out.append(leaf)
            continue
        d = spec.index("model")
        out.append(np.split(leaf, MODEL, axis=d)[col])
    return out


def unflatten_like(case: dict, leaves: list) -> dict:
    shapes = param_shapes(build(case_config(case), device="meta"))
    return tree_unflatten(tree_flatten(shapes)[1], leaves)


def fsdp_parts(case: dict, sliced: list, row: int) -> np.ndarray:
    """Row ``row``'s FSDP parts of a column's slices, unit by unit, as
    one flat array."""
    parts = []
    for _, tree in sharding.units_of(unflatten_like(case, sliced)):
        flat = np.concatenate([x.reshape(-1) for x in tree_flatten(tree)[0]])
        part = -(-flat.size // DATA)
        flat = np.pad(flat, (0, part * DATA - flat.size))
        parts.append(flat[row * part:(row + 1) * part])
    return np.concatenate(parts)
