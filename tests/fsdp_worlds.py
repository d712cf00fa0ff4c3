"""World functions of tests/test_torch_fsdp.py: each runs in every rank of a
`repro_torch.launch.mesh.spawn` world on the CPU and returns numpy
results. This module imports no JAX (the ranks load only the port); the
test file holds the results against the JAX package.

Every case runs each step mode twice, with FSDP forced on and off, from
the reference's initial parameters (taken into this row's parts unit by
unit, `utils.convert.unit_from_numpy`): one SGD step (lr 1) through
`make_step` and a 3-step AdamW `Trainer` run. The checkpoint case runs
the decoupled trainer both ways into two directories, and an FSDP run
that fails at step 2 and is resumed.
"""
import dataclasses
import os
import shutil

import numpy as np
import torch

from torch_worlds import (
    ADAMW_LR,
    FAMILY_ALPHA,
    FAMILY_CRASH_AT,
    FAMILY_STEPS,
    _clone,
    _np,
    family_batch,
    family_pipeline,
    unflatten_params,
)

N_ROWS = 4
ELASTIC_ROWS = 2  # the world that restores the 4-row run's checkpoint
MODES = ("conventional", "decoupled", "overlap")


def _opts():
    from repro_torch.train.optimizer import OptConfig

    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    return sgd, OptConfig(lr=ADAMW_LR, warmup_steps=0, total_steps=FAMILY_STEPS)


def _case_parts(inp: dict, case: dict):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model_zoo import build
    from repro_torch.utils.convert import params_from_numpy

    cfg = dataclasses.replace(get_smoke(case["name"]), dtype=torch.float32)
    tree = unflatten_params(inp, f"{case['label']}/p0/")
    params = params_from_numpy(tree, cfg, "cpu", param_dtype=torch.float32)
    return cfg, build(cfg, device="cpu"), tree, params


def _part_sizes(plan, parts: list) -> list:
    """[this row's elements of the unit, ceil(unit / n_rows)] a unit."""
    return [[p.numel(), -(-u.spec.total // plan.n_rows)] for p, u in zip(parts, plan.units)]


def fsdp_cases(mesh, inputs_path: str, ckpt_root: str, cases: list, ckpt_label: str) -> dict:
    """For each case, in each mode, with FSDP on and off: the SGD step's
    new parameters and loss (and an MoE model's world metrics), the
    AdamW trainer's losses and last parameters (gathered whole under
    FSDP), and under FSDP the sizes of this row's parts of the parameters
    and moments after the run. Then, for ``ckpt_label``'s case, the
    decoupled trainer with a checkpoint at every step, with and without
    FSDP, and an FSDP run that fails at step 2 and a fresh trainer that
    resumes it. Torch on one thread a rank."""
    from repro_torch.data.pipeline import row_shard
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_step
    from repro_torch.train.trainer import SimulatedFailure, Trainer, TrainerConfig
    from repro_torch.utils.convert import unit_from_numpy
    from repro_torch.utils.treeutil import tree_flatten

    torch.set_num_threads(1)
    inp = dict(np.load(inputs_path))
    n = mesh.n_rows
    sgd, adamw = _opts()
    out = {}

    def flat(tree, prefix):
        out.update({f"{prefix}{i}": _np(v) for i, v in enumerate(tree_flatten(tree)[0])})

    for case in cases:
        label = case["label"]
        cfg, model, tree, params = _case_parts(inp, case)
        pipe = family_pipeline(cfg, case)

        def ts_of(mode, fsdp):
            return TrainStepConfig(mode=mode, reduce_alpha=FAMILY_ALPHA, fsdp=fsdp)

        def trainer(ts, name, **kw):
            return Trainer(model, mesh, pipe, adamw, ts,
                           TrainerConfig(total_steps=FAMILY_STEPS, log_every=1,
                                         ckpt_dir=os.path.join(ckpt_root, label, name), **kw))

        def fresh():
            return {"params": _clone(params), "opt": init_opt_state(adamw, params), "step": 0}

        for mode in MODES:
            for fsdp in (True, False):
                tag = f"{label}/{'fsdp' if fsdp else 'whole'}/{mode}"
                step = make_step(model, mesh, sgd, ts_of(mode, fsdp))
                plan = step.fsdp
                if fsdp:  # the reference's tree into this row's parts, unit by unit
                    p = plan.shard_units(lambda u: unit_from_numpy(
                        tree, cfg, u, "cpu", param_dtype=torch.float32))
                    opt = init_opt_state(sgd, p)
                else:
                    p, opt = params, init_opt_state(sgd, params)
                    if mode == "overlap":
                        opt = sharding.shard_opt_state(sharding.zero1_plan(params, n, mesh.row),
                                                       opt)
                batch = row_shard(family_batch(pipe, mode, 0, n), mesh.row, n)
                new, _, metrics = step(p, opt, batch)
                out[f"{tag}/sgd/fsdp_on"] = np.bool_(plan is not None)
                if plan is not None:
                    new = sharding.FsdpWorld(plan, mesh).gather_all(new)
                flat(new, f"{tag}/sgd/new/")
                for k in ("loss", "aux_loss", "router_entropy"):
                    if k in metrics:
                        out[f"{tag}/sgd/{k}"] = np.float64(metrics[k])

                tr = trainer(ts_of(mode, fsdp), f"{'fsdp' if fsdp else 'whole'}_{mode}")
                state = tr.run(fresh(), resume=False)
                tr.close()
                out[f"{tag}/adamw/loss"] = np.array([r["loss"] for r in tr.metrics_log])
                out[f"{tag}/adamw/moment_bytes"] = np.int64(tr.moment_bytes)
                params_out = state["params"]
                if fsdp:
                    for k in ("params", "m", "v"):
                        parts = params_out if k == "params" else state["opt"][k]
                        out[f"{tag}/adamw/sizes/{k}"] = np.array(_part_sizes(tr.fsdp, parts))
                    params_out = sharding.FsdpWorld(tr.fsdp, mesh).gather_all(params_out)
                flat(params_out, f"{tag}/adamw/params/")

        if label != ckpt_label:
            continue
        # the checkpoint: the decoupled trainer (the same update bit for bit
        # with FSDP and without) saving at every step, both ways
        for fsdp in (True, False):
            tr = trainer(ts_of("decoupled", fsdp), f"ckpt_{'fsdp' if fsdp else 'whole'}",
                         ckpt_every=1, keep=FAMILY_STEPS)
            tr.run(fresh(), resume=False)
            tr.close()
            out[f"ckpt/{'fsdp' if fsdp else 'whole'}/loss"] = np.array(
                [r["loss"] for r in tr.metrics_log])
        # a crash at step 2 after its save, and a fresh trainer resuming it
        ts = ts_of("decoupled", True)
        tr = trainer(ts, "crash", ckpt_every=FAMILY_CRASH_AT, fail_at_step=FAMILY_CRASH_AT)
        try:
            tr.run(fresh(), resume=False)
            out["crash/raised"] = np.bool_(False)
        except SimulatedFailure:
            out["crash/raised"] = np.bool_(True)
        tr.close()
        out["crash/loss"] = np.array([r["loss"] for r in tr.metrics_log])
        tr = trainer(ts, "crash")
        state = tr.run(fresh())
        tr.close()
        out["crash/resumed"] = np.int64(tr.resumed["step"])
        out["crash/resumed_loss"] = np.array([r["loss"] for r in tr.metrics_log])
        flat(sharding.FsdpWorld(tr.fsdp, mesh).gather_all(state["params"]), "crash/params/")
        mesh.barrier()
    return out


def elastic_fsdp_case(mesh, inputs_path: str, ckpt_root: str, case: dict) -> dict:
    """The 4-row FSDP run's step-2 checkpoint (the crash run's directory)
    restored onto this world's rows under FSDP, gathered whole, then
    resumed to step 3 in conventional mode."""
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.utils.treeutil import tree_flatten

    torch.set_num_threads(1)
    inp = dict(np.load(inputs_path))
    cfg, model, _, params = _case_parts(inp, case)
    _, adamw = _opts()
    tr = Trainer(model, mesh, family_pipeline(cfg, case), adamw,
                 TrainStepConfig(mode="conventional", fsdp=True),
                 TrainerConfig(total_steps=FAMILY_STEPS, log_every=1,
                               ckpt_dir=os.path.join(ckpt_root, case["label"], "crash")))
    world = sharding.FsdpWorld(tr.fsdp, mesh)
    back = tr.restore(FAMILY_CRASH_AT, None)
    out = {"restored_step": np.int64(back["step"]),
           "restored_sizes": np.array(_part_sizes(tr.fsdp, back["params"]))}
    for k, parts in (("params", back["params"]), ("m", back["opt"]["m"]),
                     ("v", back["opt"]["v"])):
        whole = world.gather_all(parts)
        out.update({f"restored/{k}/{i}": _np(v) for i, v in enumerate(tree_flatten(whole)[0])})
    del back
    # the crash directory's newest step is the resumed run's step 3: the
    # 2-row trainer resumes from a copy of step 2 in a directory of its own
    src = os.path.join(ckpt_root, case["label"], "crash")
    dst = os.path.join(ckpt_root, case["label"], "elastic")
    if mesh.row == 0:
        os.makedirs(dst, exist_ok=True)
        shutil.copytree(os.path.join(src, f"step_{FAMILY_CRASH_AT:08d}"),
                        os.path.join(dst, f"step_{FAMILY_CRASH_AT:08d}"), dirs_exist_ok=True)
    mesh.barrier()
    tr.cfg.ckpt_dir = dst
    state = tr.run({"params": params, "opt": init_opt_state(adamw, params), "step": 0})
    tr.close()
    out["resumed"] = np.int64(tr.resumed["step"])
    out["loss"] = np.array([r["loss"] for r in tr.metrics_log])
    out["step"] = np.int64(state["step"])
    return out
