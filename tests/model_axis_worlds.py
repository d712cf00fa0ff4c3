"""World functions of tests/test_torch_model_axis.py and
tests/test_torch_model_axis_families.py: each runs in every rank
of a `repro_torch.launch.mesh.spawn` world of (data, model) ranks on the
CPU and returns numpy results. This module imports no JAX (the ranks load
only the port); the test file holds the results against the JAX package.

Every case starts from the reference's initial parameters, which each rank
takes as its column's slices (`utils.convert.params_from_numpy(tp=mesh)`,
or unit by unit into its FSDP parts). Per step mode: one SGD step (lr 1)
through `make_step`, its new parameters gathered whole over both axes,
and a 3-step AdamW `Trainer` run's losses (the run checkpoints at steps 2
and 3). The clip cases take the SGD step with ``grad_clip`` small enough
to bind. An MoE case's decoupled step streams its gradient in
wire chunks, and its SGD step counts the calls of `chunk_accumulate`'s
wrapper on each rank (so does a ``count_folds`` case's), the fold forced to the kernel's route (the card's
default; the CPU's is a scan) so that the wrapper's plain version stands
in for the kernel. A ``replicate_ssm`` case builds its model so
(`models.model_zoo.build`). After the cases, the
ragged-tail layers (`ragged_tail`): one MoE layer's forward and backward
over a global batch with a ragged tail, routed over the world's rows. A
second function restores (2, 2) runs' step-2 files onto another world and
resumes them.
"""
import contextlib
import dataclasses
import os
import shutil

import numpy as np
import torch

from torch_worlds import ADAMW_LR, FAMILY_ALPHA, FAMILY_STEPS, _np, family_batch, \
    family_pipeline, unflatten_params

DATA, MODEL = 2, 2
MODES = ("conventional", "decoupled", "overlap")
CKPT_EVERY = 2  # every AdamW run saves at step 2 and at its last, step 3
CLIP = 0.05  # the clip cases' max norm: far under the smoke gradients' norms
# an MoE case's decoupled step streams its gradient in wire chunks of this
# many bytes, the schedule whose f32 fold is `chunk_accumulate`'s
FOLD_CHUNK_BYTES = 1 << 16


def case_config(case: dict):
    from repro_torch.configs import get_smoke

    cfg = dataclasses.replace(get_smoke(case["name"]), dtype=torch.float32)
    if case.get("n_kv_heads"):
        cfg = dataclasses.replace(cfg, n_kv_heads=case["n_kv_heads"])
    if case.get("n_experts"):
        cfg = dataclasses.replace(cfg, n_experts=case["n_experts"])
    return cfg


def sgd_config(clip: float = 0.0):
    from repro_torch.train.optimizer import OptConfig

    return OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=clip,
                     weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)


def adamw_config():
    from repro_torch.train.optimizer import OptConfig

    return OptConfig(lr=ADAMW_LR, warmup_steps=0, total_steps=FAMILY_STEPS)


def run_tag(case: dict, fsdp: bool, mode: str) -> str:
    return f"{case['label']}/{'fsdp' if fsdp else 'whole'}/{mode}"


def trains_adamw(case: dict, fsdp: bool) -> bool:
    """Whether a run takes the 3-step AdamW trainer: every run of an
    ``adamw`` case, but an MoE or ``adamw_whole`` case's without FSDP alone
    (FSDP's AdamW path for the MoE is held on data rows by
    tests/test_torch_fsdp.py)."""
    return bool(case.get("adamw")) and not (fsdp and (case.get("moe")
                                                      or case.get("adamw_whole")))


def case_model(case: dict, mesh):
    """The port's model of a case on this rank's column."""
    from repro_torch.models.model_zoo import build

    return build(case_config(case), device="cpu", tp=mesh,
                 replicate_ssm=bool(case.get("replicate_ssm")))


# the ragged-tail layers: (label, arch, experts), a global batch of TAIL_BATCH
# sequences of TAIL_SEQ tokens (one a row): one routing group of 1,024
# tokens, then a tail of 176 on row 1
TAIL_LAYERS = (("experts", "mixtral-8x7b", 4), ("ff", "mixtral-8x7b", 3),
               ("shared", "llama4-scout-17b-a16e", 4))
TAIL_BATCH, TAIL_SEQ = 2, 600
TAIL_AUX = 3.0  # the loss: sum(y * r) + TAIL_AUX * aux_loss


def tail_layer(arch: str, n_experts: int, seed: int = 0):
    """(config, whole f32 MoE layer parameters, x, r) of a ragged-tail
    layer, drawn from ``seed``."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32, n_experts=n_experts)
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_moe(gen, cfg, dtype=torch.float32, device="cpu")
    x = torch.randn(TAIL_BATCH, TAIL_SEQ, cfg.d_model, generator=gen)
    r = torch.randn(TAIL_BATCH, TAIL_SEQ, cfg.d_model, generator=gen)
    return cfg, p, x, r


def ragged_tail(mesh, arch: str, n_experts: int) -> dict:
    """This rank's forward and backward of a ragged-tail layer on its
    column's slices (`train.sharding.spec_list`) and its row's sequence,
    routed over the world's rows: its output, its input gradient, and the
    parameter gradients gathered whole over the row and summed over the
    column's rows (every rank then holds the world's gradient)."""
    from repro_torch.models import moe
    from repro_torch.train import sharding
    from repro_torch.utils.treeutil import tree_flatten, tree_unflatten

    cfg, p, x, r = tail_layer(arch, n_experts)
    tree = {"layers": [{"moe": p}]}
    specs = sharding.spec_list(tree, mesh.model_size)
    local = sharding.shard_model(tree, specs, mesh.model_size, mesh.col)
    leaves, treedef = tree_flatten(local)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    local = tree_unflatten(treedef, leaves)
    b = TAIL_BATCH // mesh.n_rows
    x = x[mesh.row * b:(mesh.row + 1) * b].clone().requires_grad_(True)
    r = r[mesh.row * b:(mesh.row + 1) * b]
    world = moe.RouteWorld(mesh)
    world.start()
    moe_p = local["layers"][0]["moe"]
    y, aux = moe.apply_moe(moe_p, x, cfg, torch.float32, world=world.at(0), tp=mesh)
    ((y * r).sum() + TAIL_AUX * aux["aux_share"]).backward()
    grads = tree_unflatten(treedef, [t.grad for t in leaves])
    whole = sharding.gather_model(grads, specs, mesh)
    return {"split": np.str_(moe.expert_split(moe_p, cfg, mesh)), "y": _np(y), "gx": _np(x.grad),
            "aux_loss": np.float64(aux["aux_loss"]),
            **{f"g/{i}": _np(mesh.all_reduce(g)) for i, g in enumerate(tree_flatten(whole)[0])}}


def _counted_folds():
    """Force the stream's f32 fold onto `chunk_accumulate`'s wrapper (the
    kernel's route) and count its calls: -> (the counter, undo)."""
    import functools

    from repro_torch.core import channel

    calls = {"n": 0}
    fold_tree, accumulate = channel.StreamChannel.stream_fold_tree, channel.reduce_ops.accumulate

    def counted(*a, **kw):
        calls["n"] += 1
        return accumulate(*a, **kw)

    channel.StreamChannel.stream_fold_tree = functools.partialmethod(fold_tree,
                                                                     wave_fold="kernel")
    channel.reduce_ops.accumulate = counted

    def undo():
        channel.StreamChannel.stream_fold_tree = fold_tree
        channel.reduce_ops.accumulate = accumulate

    return calls, undo


def _whole(mesh, model, params, plan) -> list:
    """The whole parameters of this rank's state as numpy leaves
    (collective): FSDP parts gathered over the column, slices over the row."""
    from repro_torch.train import sharding
    from repro_torch.train.train_step import param_shapes
    from repro_torch.utils.treeutil import tree_flatten

    if plan is not None:
        params = sharding.FsdpWorld(plan, mesh).gather_all(params)
    if model.tp is not None:
        params = sharding.gather_model(params, model.specs(param_shapes(model, whole=True)),
                                       mesh)
    return [_np(x) for x in tree_flatten(params)[0]]


def _start(mesh, model, tree, cfg, plan, opt_cfg):
    """This rank's parameters and optimizer state from the reference's
    tree: its column's slices, or its FSDP parts of them unit by unit; in
    overlap mode without FSDP, ZeRO-1's moment parts."""
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.utils.convert import params_from_numpy, unit_from_numpy

    kw = dict(param_dtype=torch.float32, tp=mesh, replicate_ssm=model.replicate_ssm)
    if plan is not None:
        params = plan.shard_units(lambda u: unit_from_numpy(tree, cfg, u, "cpu", **kw))
    else:
        params = params_from_numpy(tree, cfg, "cpu", **kw)
    return params, init_opt_state(opt_cfg, params)


@contextlib.contextmanager
def whole_leaves(key: str):
    """Within it, the model axis keeps every leaf under ``key`` (``moe``:
    an MoE layer's; ``mamba``: a Mamba block's) whole on every column
    (`train.sharding.spec_for_leaf` patched): each column then computes
    that block whole, with no split of its own (the cases' ``moe_whole``,
    against which the experts' split is held; tests/model_axis_floor.py's
    readings)."""
    from repro_torch.train import sharding

    spec_for_leaf = sharding.spec_for_leaf

    def whole(names, shape, model_size, **kw):
        spec = spec_for_leaf(names, shape, model_size, **kw)
        return (None,) * len(spec) if key in names else spec

    sharding.spec_for_leaf = whole
    try:
        yield
    finally:
        sharding.spec_for_leaf = spec_for_leaf


def model_axis_cases(mesh, inputs_path: str, ckpt_root: str, cases: list,
                     tails: tuple = ()) -> dict:
    """For each case, its ``modes`` with FSDP off and, with ``fsdp``, on:
    the SGD step (``clip``: with ``grad_clip`` `CLIP`; an MoE or
    ``count_folds`` case's decoupled step with its folds counted), the
    AdamW trainer (``adamw``) and this rank's stored leaves at step 0,
    within `whole_leaves` where the case says ``moe_whole`` (the MoE) or
    names a ``whole`` block; then each of ``tails`` (`TAIL_LAYERS`'
    entries): `ragged_tail`. Torch on one thread a rank."""
    torch.set_num_threads(1)
    inp = dict(np.load(inputs_path))
    out = {"rank": np.int64(mesh.rank), "row": np.int64(mesh.row), "col": np.int64(mesh.col)}
    for case in cases:
        whole = "moe" if case.get("moe_whole") else case.get("whole")
        with whole_leaves(whole) if whole else contextlib.nullcontext():
            _model_axis_case(mesh, inp, ckpt_root, case, out)
    for label, arch, n_experts in tails:
        out.update({f"tail/{label}/{k}": v
                    for k, v in ragged_tail(mesh, arch, n_experts).items()})
    return out


def _model_axis_case(mesh, inp: dict, ckpt_root: str, case: dict, out: dict) -> None:
    """One case of `model_axis_cases`, its results into ``out``."""
    from repro_torch.data.pipeline import row_shard
    from repro_torch.train import sharding
    from repro_torch.train.train_step import TrainStepConfig, make_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.utils.treeutil import tree_flatten

    n = mesh.n_rows
    label = case["label"]
    cfg = case_config(case)
    model = case_model(case, mesh)
    tree = unflatten_params(inp, f"{label}/p0/")
    # the stored leaves at step 0: converted, and drawn by the trainer
    stored = _start(mesh, model, tree, cfg, None, sgd_config())[0]
    out.update({f"{label}/stored/{i}": _np(x) for i, x in enumerate(tree_flatten(stored)[0])})
    for fsdp in (False, True) if case.get("fsdp") else (False,):
        for mode in case["modes"]:
            tag = run_tag(case, fsdp, mode)
            pipe = family_pipeline(cfg, case)
            counted = bool(cfg.n_experts or case.get("count_folds")) and mode == "decoupled"
            ts = TrainStepConfig(mode=mode, reduce_alpha=FAMILY_ALPHA, fsdp=fsdp,
                                 wire_chunk_bytes=FOLD_CHUNK_BYTES if counted else None)
            runs = [("sgd", sgd_config())]
            if case.get("clip"):
                runs.append(("clip", sgd_config(CLIP)))
            for name, opt_cfg in runs:
                step = make_step(model, mesh, opt_cfg, ts)
                params, opt = _start(mesh, model, tree, cfg, step.fsdp, opt_cfg)
                if mode == "overlap" and step.fsdp is None:
                    opt = sharding.shard_opt_state(sharding.zero1_plan(params, n, mesh.row), opt)
                if fsdp and name == "sgd":
                    out[f"{tag}/parts"] = np.concatenate([_np(p) for p in params])
                batch = row_shard(family_batch(pipe, mode, 0, n), mesh.row, n)
                if counted:
                    folds, undo = _counted_folds()
                try:
                    new, _, metrics = step(params, opt, batch)
                finally:
                    if counted:
                        undo()
                        out[f"{tag}/{name}/accumulate_calls"] = np.int64(folds["n"])
                out[f"{tag}/{name}/fsdp_on"] = np.bool_(step.fsdp is not None)
                out[f"{tag}/{name}/loss"] = np.float64(metrics["loss"])
                out.update({f"{tag}/{name}/new/{i}": x
                            for i, x in enumerate(_whole(mesh, model, new, step.fsdp))})
                out[f"{tag}/{name}/model_collectives"] = np.int64(mesh.stats.model_collectives)
            if not trains_adamw(case, fsdp):
                continue
            tr = Trainer(model, mesh, pipe, adamw_config(), ts,
                         TrainerConfig(total_steps=FAMILY_STEPS, log_every=1,
                                       ckpt_every=CKPT_EVERY, keep=FAMILY_STEPS,
                                       ckpt_dir=os.path.join(ckpt_root, tag)))
            if not fsdp and mode == MODES[0]:  # the trainer's own draw from seed 0
                out.update({f"{label}/init/{i}": _np(x) for i, x in
                            enumerate(tree_flatten(tr.init_state(0)["params"])[0])})
            params, opt = _start(mesh, model, tree, cfg, tr.fsdp, adamw_config())
            state = tr.run({"params": params, "opt": opt, "step": 0}, resume=False)
            tr.close()
            out[f"{tag}/adamw/loss"] = np.array([r["loss"] for r in tr.metrics_log])
            out.update({f"{tag}/adamw/params/{i}": x for i, x in
                        enumerate(_whole(mesh, model, state["params"], tr.fsdp))})


def restore_case(mesh, inputs_path: str, ckpt_root: str, restores: list,
                 sgd_cases: list) -> dict:
    """On this world: the SGD steps of ``sgd_cases`` (for the (2, 2) steps
    to be held against), then for each (case, run tag) of ``restores`` the
    (2, 2) run's step-2 files restored (gathered whole, against the files)
    and resumed to step 3 in conventional mode, its keys under the case's
    label."""
    from repro_torch.data.pipeline import row_shard
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    inp = dict(np.load(inputs_path))
    n = mesh.n_rows
    out = {}
    for c in sgd_cases:
        cfg = case_config(c)
        model = case_model(c, mesh)
        tree = unflatten_params(inp, f"{c['label']}/p0/")
        for mode in c["modes"]:
            pipe = family_pipeline(cfg, c)
            ts = TrainStepConfig(mode=mode, reduce_alpha=FAMILY_ALPHA, fsdp=False)
            step = make_step(model, mesh, sgd_config(), ts)
            params, opt = _start(mesh, model, tree, cfg, None, sgd_config())
            if mode == "overlap":
                from repro_torch.train import sharding

                opt = sharding.shard_opt_state(sharding.zero1_plan(params, n, mesh.row), opt)
            batch = row_shard(family_batch(pipe, mode, 0, n), mesh.row, n)
            new, _, _ = step(params, opt, batch)
            out.update({f"{run_tag(c, False, mode)}/sgd/new/{i}": x
                        for i, x in enumerate(_whole(mesh, model, new, None))})

    for case, src_tag in restores:
        label = case["label"]
        cfg = case_config(case)
        model = case_model(case, mesh)
        pipe = family_pipeline(cfg, case)
        src = os.path.join(ckpt_root, src_tag)
        dst = os.path.join(ckpt_root, f"restored_{label}_{n}x{mesh.model_size}")
        if mesh.rank == 0:
            os.makedirs(dst, exist_ok=True)
            shutil.copytree(os.path.join(src, f"step_{CKPT_EVERY:08d}"),
                            os.path.join(dst, f"step_{CKPT_EVERY:08d}"), dirs_exist_ok=True)
        mesh.barrier()
        tr = Trainer(model, mesh, pipe, adamw_config(),
                     TrainStepConfig(mode="conventional", reduce_alpha=FAMILY_ALPHA),
                     TrainerConfig(total_steps=FAMILY_STEPS, log_every=1, ckpt_dir=dst))
        params = _start(mesh, model, unflatten_params(inp, f"{label}/p0/"), cfg, None,
                        adamw_config())[0]
        back = tr.restore(CKPT_EVERY, {"params": params})
        out[f"{label}/restored_step"] = np.int64(back["step"])
        for k, tree in (("params", back["params"]), ("m", back["opt"]["m"]),
                        ("v", back["opt"]["v"])):
            out.update({f"{label}/restored/{k}/{i}": x
                        for i, x in enumerate(_whole(mesh, model, tree, tr.fsdp))})
        del back
        state = tr.run({"params": params, "opt": init_opt_state(adamw_config(), params),
                        "step": 0})
        tr.close()
        out[f"{label}/resumed"] = np.int64(tr.resumed["step"])
        out[f"{label}/loss"] = np.array([r["loss"] for r in tr.metrics_log])
        out[f"{label}/step"] = np.int64(state["step"])
    return out
