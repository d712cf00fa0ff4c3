"""World functions of the port's multi-rank tests: each runs in every
rank of a `repro_torch.launch.mesh.spawn` world on the CPU and returns
numpy results. This module imports no JAX (the ranks load only the
port); the test files hold the results against the JAX package.

Inputs come from an ``.npz`` the test writes, so both packages fold the
same numbers.
"""
import dataclasses

import numpy as np
import torch

N_ROWS = 8
ALPHA = 0.25  # 6 compute rows, 2 reduce rows: 3 waves
# (name, chunk_bytes, codec, wave_fold, generic combine)
TREE_VARIANTS = [("whole", None, c, None, False) for c in ("identity", "bf16", "int8")] + [
    (f"chunked_{f}", 64, c, f, False) for f in ("kernel", "add", "scan")
    for c in ("identity", "bf16", "int8")] + [
    ("whole_max", None, "identity", None, True), ("chunked_max", 64, "identity", None, True)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def channel_cases(mesh, inputs_path: str) -> dict:
    from repro_torch.core.channel import make_channel
    from repro_torch.core.decouple import (
        conventional_allreduce,
        group_pmax,
        group_psum,
        stream_reduce,
        stream_reduce_and_return,
    )
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.utils.treeutil import tree_map

    inp = dict(np.load(inputs_path))
    r = mesh.row
    gm = GroupedMesh.build(mesh, services={"reduce": ALPHA})
    ch = make_channel(gm, "reduce")
    x = torch.from_numpy(inp["x"][r])
    out = {}

    def op(acc, elem, k):
        acc[k] += elem * (k + 1)
        return acc

    out["fold"] = ch.stream_fold(x, op, torch.zeros_like(x))
    out["fold_count"] = ch.stream_fold(x, op, torch.zeros_like(x),
                                       count=torch.tensor(int(inp["count"][r])))
    out["fold_int8"] = ch.stream_fold(x, op, torch.zeros_like(x), codec="int8")
    out["reduce"] = stream_reduce(x, ch)
    out["reduce_return"] = stream_reduce_and_return(x, ch, transform=lambda v: v * 2.0)
    out["psum_reduce"] = group_psum(x, gm, "reduce")
    out["pmax_compute"] = group_pmax(x, gm, "compute")
    out["allreduce"] = conventional_allreduce(x, gm)

    payload = {"a": torch.from_numpy(inp["a"][r]), "b": torch.from_numpy(inp["b"][r]),
               "c": torch.from_numpy(inp["c"][r]).to(torch.bfloat16)}

    def max_combine(acc, new, ok):
        return tree_map(torch.maximum, acc, new) if ok else acc

    for name, chunk_bytes, codec, wave_fold, generic in TREE_VARIANTS:
        got = ch.stream_fold_tree(payload, codec=codec, chunk_bytes=chunk_bytes,
                                  wave_fold=wave_fold,
                                  combine=max_combine if generic else None)
        for k, v in got.items():
            out[f"tree_{name}_{codec}_{k}"] = v
    return {k: _np(v) for k, v in out.items()}


def train_cases(mesh, inputs_path: str, ckpt_dir: str) -> dict:
    """The decoupled step (with and without the analytics chain, and with
    the int8 wire) on the reference's parameters, the port's conventional
    step on the global batch and on compute row 1's shard alone, and a
    3-step `Trainer` run; f32 tinyllama smoke config."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, Pipeline, row_shard
    from repro_torch.models.model_zoo import build
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (
        TrainStepConfig,
        build_conventional_step,
        make_step,
    )
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.treeutil import tree_flatten

    inp = dict(np.load(inputs_path))
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    model = build(cfg, device="cpu")
    params = params_from_numpy(unflatten_params(inp, "p0/"), cfg, "cpu",
                               param_dtype=torch.float32)
    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    batch = {k: torch.from_numpy(inp["batch/" + k]) for k in ("tokens", "labels", "mask")}
    out = {}

    def flat(tree, prefix):
        leaves, _ = tree_flatten(tree)
        out.update({f"{prefix}{i}": _np(v) for i, v in enumerate(leaves)})

    for name, analytics, compress in (("decoupled", 0.0, "none"), ("analytics", 0.125, "none"),
                                      ("int8", 0.0, "int8")):
        ts = TrainStepConfig(mode="decoupled", reduce_alpha=ALPHA, analytics_alpha=analytics,
                             compress=compress, wire_chunk_bytes=65536)
        step = make_step(model, mesh, sgd, ts)
        new, _, metrics = step(params, init_opt_state(sgd, params),
                               row_shard(batch, mesh.row, N_ROWS))
        flat(new, f"{name}/new/")
        for k in ("loss", "grad_norm", "grad_absmax"):
            if k in metrics:
                out[f"{name}/metric/{k}"] = np.float32(metrics[k])
        out[f"{name}/work_rows"] = metrics["work_rows"].numpy()
    conv = build_conventional_step(model, sgd)
    new, _, metrics = conv(params, init_opt_state(sgd, params), batch)
    flat(new, "conventional/new/")
    out["conventional/metric/loss"] = np.float32(metrics["loss"])
    # compute row 1's shard alone: its share of the gradient, the fault
    # the int8-wire test must tell from quantisation error
    shard = row_shard(batch, 1, N_ROWS)
    new, _, _ = conv(params, init_opt_state(sgd, params), shard)
    flat(new, "row1/new/")
    out["row1/share"] = np.float32(shard["mask"].sum() / batch["mask"].sum())

    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=6,
                               kind="zipf", skew=0.4))
    adamw = OptConfig(lr=1e-3, warmup_steps=10, total_steps=3)
    trainer = Trainer(model, mesh, pipe, adamw,
                      TrainStepConfig(mode="decoupled", reduce_alpha=ALPHA,
                                      wire_chunk_bytes=65536),
                      TrainerConfig(total_steps=3, log_every=1, ckpt_dir=ckpt_dir))
    state = {"params": params, "opt": init_opt_state(adamw, params), "step": 0}
    trainer.run(state)
    out["trainer/loss"] = np.array([row["loss"] for row in trainer.metrics_log], np.float64)
    return out


# -- the data-parallel and ZeRO-1 steps, checkpoints, crash and resume ------------------

# the crash-resume sequence of the reference's
# test_trainer_crash_resume_and_elastic: decoupled on 8 rows, a crash at
# step 5 (checkpoint every 3), then conventional on 4 rows to step 8
CRASH = dict(seq=16, global_batch=8, lr=1e-3, warmup=2, total=20, steps=8, ckpt_every=3,
             fail_at=5)
ADAMW_STEPS = 3
ADAMW_LR = 1e-3
# the reference's adaptive trainer drill (tests/test_dataflow.py), f32
ADAPT_TRAIN = dict(seq=16, global_batch=8, lr=1e-3, warmup=2, total=20, steps=6,
                   reduce_alpha=0.125, policy=dict(window=2, cooldown=1, speedup_threshold=1.05))
ADAPT_STEP_WALL = 0.025
MOMENT_STEPS = 2  # the checkpoint that crosses modes, then one more step


def _trainer_parts(inp: dict):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model_zoo import build
    from repro_torch.utils.convert import params_from_numpy

    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    model = build(cfg, device="cpu")
    params = params_from_numpy(unflatten_params(inp, "p0/"), cfg, "cpu",
                               param_dtype=torch.float32)
    return cfg, model, params


def _crash_trainer(model, mesh, mode: str, ckpt_dir: str, fail: bool):
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    c = CRASH
    pipe = Pipeline(DataConfig(vocab_size=model.cfg.vocab_size, seq_len=c["seq"],
                               global_batch=c["global_batch"]))
    opt = OptConfig(lr=c["lr"], warmup_steps=c["warmup"], total_steps=c["total"])
    ts = TrainStepConfig(mode=mode, reduce_alpha=ALPHA) if mode == "decoupled" else \
        TrainStepConfig(mode=mode)
    return Trainer(model, mesh, pipe, opt, ts,
                   TrainerConfig(total_steps=c["steps"], ckpt_every=c["ckpt_every"],
                                 ckpt_dir=ckpt_dir, log_every=1,
                                 fail_at_step=c["fail_at"] if fail else None))


def trainer_cases(mesh, inputs_path: str, ckpt_root: str) -> dict:
    """In an 8-row world: one SGD step (lr 1) of the conventional and
    overlap steps; three AdamW steps of each with the clip the inputs name
    (and conventional without it); the decoupled trainer's crash at step
    5; checkpoints that cross between overlap and conventional mode; and
    the adaptive decoupled trainer (`ADAPT_TRAIN`, a constant step wall)."""
    import os

    from repro_torch.data.pipeline import DataConfig, Pipeline, row_shard
    from repro_torch.io import checkpoint as ckpt
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_step
    from repro_torch.train.trainer import SimulatedFailure, Trainer, TrainerConfig
    from repro_torch.utils.treeutil import tree_flatten

    inp = dict(np.load(inputs_path))
    cfg, model, params = _trainer_parts(inp)
    out = {}

    def flat(tree, prefix):
        out.update({f"{prefix}{i}": _np(v) for i, v in enumerate(tree_flatten(tree)[0])})

    def run(mode, opt_cfg, batches):
        """``len(batches)`` steps of ``mode`` from the inputs' parameters:
        (params, whole optimizer state, losses, the step's timings)."""
        step = make_step(model, mesh, opt_cfg, TrainStepConfig(mode=mode))
        p, o = params, init_opt_state(opt_cfg, params)
        plan = sharding.zero1_plan(params, mesh.n_rows, mesh.row)
        if mode == "overlap":
            o = sharding.shard_opt_state(plan, o)
        losses = []
        for b in batches:
            p, o, m = step(p, o, row_shard(b, mesh.row, mesh.n_rows))
            losses.append(m["loss"])
        if mode == "overlap":
            out[f"{mode}/moment_elems"] = np.int64(o["m"].numel())
            o = sharding.gather_opt_state(plan, mesh, o)
        return p, o, np.asarray(losses, np.float64), step.timings

    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    batch = {k: torch.from_numpy(inp["batch/" + k]) for k in ("tokens", "labels", "mask")}
    for mode in ("conventional", "overlap"):
        new, _, losses, timings = run(mode, sgd, [batch])
        flat(new, f"sgd/{mode}/new/")
        out[f"sgd/{mode}/loss"] = losses
        out[f"sgd/{mode}/phases"] = np.array(sorted(timings[0]))

    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                               kind="zipf", skew=0.4))
    batches = [pipe.global_batch(s) for s in range(ADAMW_STEPS)]
    for name, clip in (("clip", float(inp["clip"])), ("noclip", 0.0)):
        adamw = OptConfig(lr=ADAMW_LR, warmup_steps=0, total_steps=ADAMW_STEPS,
                          grad_clip=clip)
        for mode in ("conventional", "overlap") if clip else ("conventional",):
            p, o, losses, _ = run(mode, adamw, batches)
            flat(p, f"adamw_{name}/{mode}/params/")
            flat(o["m"], f"adamw_{name}/{mode}/m/")
            flat(o["v"], f"adamw_{name}/{mode}/v/")
            out[f"adamw_{name}/{mode}/loss"] = losses

    # the reference's crash: decoupled on 8 rows, checkpoints at step 3
    crash_dir = os.path.join(ckpt_root, "crash")
    tr = _crash_trainer(model, mesh, "decoupled", crash_dir, fail=True)
    state = {"params": _clone(params), "opt": init_opt_state(tr.opt_cfg, params), "step": 0}
    try:
        tr.run(state)
        out["crash/raised"] = np.bool_(False)
    except SimulatedFailure:
        out["crash/raised"] = np.bool_(True)
    tr.close()
    out["crash/loss"] = np.array([r["loss"] for r in tr.metrics_log], np.float64)
    out["crash/latest"] = np.int64(ckpt.latest_step(crash_dir))

    # checkpoints across modes: MOMENT_STEPS steps in one mode, then the
    # other resumes from its checkpoint and takes one more step; against
    # conventional mode run straight through
    adamw = OptConfig(lr=ADAMW_LR, warmup_steps=0, total_steps=MOMENT_STEPS + 1)
    for name, legs in (("overlap_then_conventional", ("overlap", "conventional")),
                       ("conventional_then_overlap", ("conventional", "overlap")),
                       ("straight", ("conventional",))):
        d = os.path.join(ckpt_root, name)
        for i, mode in enumerate(legs):
            total = MOMENT_STEPS + 1 if i == len(legs) - 1 else MOMENT_STEPS
            tr = Trainer(model, mesh, pipe, adamw, TrainStepConfig(mode=mode),
                         TrainerConfig(total_steps=total, ckpt_every=MOMENT_STEPS,
                                       ckpt_dir=d, log_every=1))
            state = tr.run({"params": _clone(params), "opt": init_opt_state(adamw, params),
                            "step": 0})
            tr.close()
            key = f"cross/{name}/{i}"
            for part, tree in (("params", state["params"]), ("m", state["opt"]["m"]),
                               ("v", state["opt"]["v"])):
                flat(tree, f"{key}/{part}/")
            out[f"{key}/steps"] = np.array([r["step"] for r in tr.metrics_log])
            out[f"{key}/moment_bytes"] = np.int64(tr.moment_bytes)
            if total == MOMENT_STEPS:  # what the files hold, read back
                saved = tr.restore(MOMENT_STEPS, state)
                flat(saved["opt"]["m"], f"{key}/saved_m/")
                flat(saved["opt"]["v"], f"{key}/saved_v/")

    # the adaptive decoupled trainer on the reference's qwen2.5-3b smoke
    # parameters, every step's wall a constant
    import time
    import types

    import repro_torch.train.trainer as trmod
    from repro_torch.configs import get_smoke
    from repro_torch.core.adapt import AdaptPolicy
    from repro_torch.models.model_zoo import build
    from repro_torch.utils.convert import params_from_numpy

    a = ADAPT_TRAIN
    qcfg = dataclasses.replace(get_smoke("qwen2.5-3b"), dtype=torch.float32)
    qmodel = build(qcfg, device="cpu")
    qparams = params_from_numpy(unflatten_params(inp, "q0/"), qcfg, "cpu",
                                param_dtype=torch.float32)
    clock = {"t": 0.0}

    def tick():
        clock["t"] += ADAPT_STEP_WALL
        return clock["t"]

    qopt = OptConfig(lr=a["lr"], warmup_steps=a["warmup"], total_steps=a["total"])
    tr = Trainer(qmodel, mesh,
                 Pipeline(DataConfig(vocab_size=qcfg.vocab_size, seq_len=a["seq"],
                                     global_batch=a["global_batch"])),
                 qopt, TrainStepConfig(mode="decoupled", reduce_alpha=a["reduce_alpha"]),
                 TrainerConfig(total_steps=a["steps"], ckpt_every=100, log_every=1,
                               ckpt_dir=os.path.join(ckpt_root, "adapt"),
                               adapt=AdaptPolicy(**a["policy"])))
    trmod.time = types.SimpleNamespace(perf_counter=tick, time=time.time)
    try:
        tr.run({"params": qparams, "opt": init_opt_state(qopt, qparams), "step": 0},
               resume=False)
    finally:
        trmod.time = time
        tr.close()
    out["adapt/loss"] = np.array([r["loss"] for r in tr.metrics_log], np.float64)
    out["adapt/steps"] = np.array([r["step"] for r in tr.metrics_log])
    out["adapt/log"] = np.array([[e["step"], e["regroup"]["reduce"], e["predicted_speedup"]]
                                 for e in tr.adapt_log], np.float64).reshape(-1, 3)
    out["adapt/reduce_rows"] = np.int64(round(tr.ts_cfg.reduce_alpha * mesh.n_rows))
    return out


def _clone(tree):
    from repro_torch.utils.treeutil import tree_map

    return tree_map(torch.clone, tree)


def elastic_case(mesh, inputs_path: str, ckpt_root: str) -> dict:
    """The crash's checkpoint resumed in conventional mode on 4 rows, to
    step 8."""
    import os

    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.utils.treeutil import tree_flatten

    inp = dict(np.load(inputs_path))
    _, model, params = _trainer_parts(inp)
    tr = _crash_trainer(model, mesh, "conventional", os.path.join(ckpt_root, "crash"),
                        fail=False)
    state = tr.run({"params": params, "opt": init_opt_state(tr.opt_cfg, params), "step": 0})
    tr.close()
    out = {f"final/{i}": _np(v) for i, v in enumerate(tree_flatten(state["params"])[0])}
    out["loss"] = np.array([r["loss"] for r in tr.metrics_log], np.float64)
    out["steps"] = np.array([r["step"] for r in tr.metrics_log])
    out["resumed"] = np.int64(tr.resumed["step"])
    out["step"] = np.int64(state["step"])
    return out


def unflatten_params(inp: dict, prefix: str) -> dict:
    """The reference's parameter tree from ``prefix``-keyed npz entries
    ("p0/layers/attn/wq/w" -> nested dicts)."""
    tree: dict = {}
    for key, v in inp.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def cuda_fold_case(mesh) -> dict:
    """A two-row world on the card: row 0 streams a ragged f32 payload to
    row 1 in wire chunks, which folds the wave with the chunk_accumulate
    kernel (the CUDA default) and with the in-scan add."""
    from repro_torch.core.channel import make_channel
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.kernels.stream_reduce import chunk_accumulate_kernel

    gm = GroupedMesh.build(mesh, services={"reduce": 0.5})
    ch = make_channel(gm, "reduce", chunk_bytes=1 << 20)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    payload = {"w": torch.randn((1000, 777), generator=gen, device=mesh.device),
               "b": torch.randn((333,), generator=gen, device=mesh.device)}
    before = chunk_accumulate_kernel.launches
    kernel = ch.stream_fold_tree(payload)
    launches = chunk_accumulate_kernel.launches - before
    scan = ch.stream_fold_tree(payload, wave_fold="scan")
    torch.cuda.synchronize()
    return {"launches": launches, "kernel": {k: v.cpu().numpy() for k, v in kernel.items()},
            "scan": {k: v.cpu().numpy() for k, v in scan.items()},
            "payload": {k: v.cpu().numpy() for k, v in payload.items()},
            "stats": mesh.stats.as_dict()}


def data_parallel_case(mesh) -> dict:
    """One SGD step (lr 1) of the conventional and the overlap step on
    the f32 tinyllama smoke config, from the same parameters and batch on
    any device (drawn on the CPU, then moved): the new parameters."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, Pipeline, row_shard
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_step
    from repro_torch.utils.treeutil import tree_flatten, tree_map

    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    params = tree_map(lambda t: t.to(mesh.device),
                      build(cfg, device="cpu").init(0, param_dtype=torch.float32))
    model = build(cfg, device=mesh.device)
    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    batch = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                                kind="zipf", skew=0.4)).global_batch(0)
    out = {}
    for mode in ("conventional", "overlap"):
        opt = init_opt_state(sgd, params)
        if mode == "overlap":
            opt = sharding.shard_opt_state(sharding.zero1_plan(params, mesh.n_rows, mesh.row),
                                           opt)
        new, _, metrics = make_step(model, mesh, sgd, TrainStepConfig(mode=mode))(
            params, opt, row_shard(batch, mesh.row, mesh.n_rows, mesh.device))
        out[mode] = [t.cpu().numpy() for t in tree_flatten(new)[0]]
        out[mode + "/loss"] = metrics["loss"]
    out["p0"] = [t.cpu().numpy() for t in tree_flatten(params)[0]]
    out["device"] = str(mesh.device)
    return out



def moe_two_row_case(mesh, seq: int = 48) -> dict:
    """One SGD step of the f32 mixtral smoke config in a two-row world, in
    the two layouts of the chip smoke's phase 8b (a): decoupled with one
    compute row holding the whole global batch of 2 sequences (the other
    row reduces), and overlap with one sequence a row, the one routing
    group of the 2 x ``seq`` tokens straddling both rows. The step's loss,
    aux_loss and router_entropy of each, on any device."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, Pipeline, row_shard
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_step
    from repro_torch.utils.treeutil import tree_map

    cfg = dataclasses.replace(get_smoke("mixtral-8x7b"), dtype=torch.float32)
    params = tree_map(lambda t: t.to(mesh.device),
                      build(cfg, device="cpu").init(0, param_dtype=torch.float32))
    model = build(cfg, device=mesh.device)
    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=2,
                               kind="zipf", skew=0.4))
    out = {"device": str(mesh.device)}
    for mode, batch in (("decoupled", pipe.padded_for_groups(0, 1, mesh.n_rows)),
                        ("overlap", pipe.global_batch(0))):
        opt = init_opt_state(sgd, params)
        if mode == "overlap":
            opt = sharding.shard_opt_state(sharding.zero1_plan(params, mesh.n_rows, mesh.row),
                                           opt)
        step = make_step(model, mesh, sgd, TrainStepConfig(mode=mode, reduce_alpha=0.5))
        _, _, metrics = step(params, opt, row_shard(batch, mesh.row, mesh.n_rows, mesh.device))
        out[mode] = {k: float(metrics[k]) for k in ("loss", "aux_loss", "router_entropy")}
    return out

# -- the dataflow runtime and the MapReduce app -----------------------------------------

WC_CFG = dict(n_docs_per_row=4, words_per_doc=256, vocab=500, skew=0.7)
# (name, mode, keyword arguments of run_wordcount)
WC_VARIANTS = [("reference", "reference", {}), ("decoupled", "decoupled", {}),
               ("pipelined", "pipelined", {}),
               ("deep", "pipelined", {"chain_alphas": {"relay": 0.125, "io": 0.125}}),
               ("decoupled_s7", "decoupled", {"granularity_words": 7})]
FEEDBACK_STEPS = 60
# the phases `run_wordcount(..., phases=)` times, by mode
PHASES = {"reference": ("map_s", "group_sum_s"),
          "decoupled": ("map_s", "stream_s", "group_sum_s", "broadcast_s"),
          "pipelined": ("map_s", "stream_s", "group_sum_s", "broadcast_s")}


def dataflow_cases(mesh, inputs_path: str) -> dict:
    """`ServiceGraph.run`/`run_chain` (a three-stage chain with and without
    a producer count, two chains in one run), `with_work_probe`,
    `regroup`, a bidirectional edge, `scatter_back`, the group collectives,
    `select_by_role`, error feedback over an int8 wire, the word count in
    every mode, its measured variant and the quickstart's statistics."""
    from repro_torch.apps.mapreduce import (
        CorpusCfg,
        decoupled_wordcount_measured,
        make_corpus,
        row_docs,
        run_wordcount,
        wordcount_graph,
    )
    from repro_torch.core.dataflow import (
        ServiceGraph,
        Stage,
        delta_emitter,
        sink_sum_stage,
        with_work_probe,
    )
    from repro_torch.core.decouple import (
        group_all_gather,
        group_psum,
        group_psum_scatter,
        role_index,
        select_by_role,
    )
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.core.wire import WireSpec, compress_with_feedback
    from repro_torch.examples.quickstart import workload_stats

    inp = dict(np.load(inputs_path))
    r = mesh.row
    x = torch.from_numpy(inp["x"][r])  # (4, 16) integer-valued f32
    out = {}

    def head_op(acc, e, k):
        return acc.add_(e * (k + 1))

    def chain3(count=None):
        zero = torch.zeros(16)
        head = Stage("compute", "reduce", head_op, zero, elements=x, count=count,
                     emit=delta_emitter(zero))
        relay = sink_sum_stage("reduce", "relay", 16, device="cpu")
        relay = dataclasses.replace(relay, emit=delta_emitter(relay.init))
        return g3.run_chain([head, relay, sink_sum_stage("relay", "io", 16, device="cpu")])

    g3 = ServiceGraph.build(mesh, stages={"reduce": 0.25, "relay": 0.125, "io": 0.125},
                            edges=[("compute", "reduce"), ("reduce", "relay"), ("relay", "io")])
    for i, acc in enumerate(chain3()):
        out[f"chain3/{i}"] = acc
    for i, acc in enumerate(chain3(torch.tensor(int(inp["count"][r])))):
        out[f"chain3_count/{i}"] = acc

    g2 = ServiceGraph.build(mesh, stages={"reduce": 0.25, "io": 0.125},
                            edges=[("compute", "reduce"), ("compute", "io")])
    zero = torch.zeros(16)
    (a,), (b,) = g2.run([[Stage("compute", "reduce", head_op, zero, elements=x)],
                         [Stage("compute", "io", lambda acc, e, k: acc.add_(e * e), zero,
                                elements=x)]])
    out["two_chains/a"], out["two_chains/b"] = a, b

    g = ServiceGraph.build(mesh, stages={"reduce": 0.25}, edges=[("compute", "reduce")])
    plain = Stage("compute", "reduce", lambda acc, e, k: acc.add_(e), torch.zeros(16),
                  elements=x)
    probed = with_work_probe(plain, work_of=lambda e: (e.abs() >= 0).sum())
    acc, count = g.run_chain([probed])[0]
    out["probe/acc"], out["probe/bare"] = acc, g.run_chain([plain])[0]
    out["probe/total"] = group_psum(count, g.gmesh, "reduce")

    g_re = g.regroup({"reduce": 3})
    out["regroup/rows"] = torch.tensor([[s.start, s.stop] for s in g_re.gmesh.groups])
    out["regroup/acc"] = g_re.run_chain([Stage("compute", "reduce", head_op, torch.zeros(16),
                                               elements=x)])[0]

    def chunk_op(acc, elem, k):
        acc[k] += elem * (k + 1)
        return acc

    gb = ServiceGraph.build(mesh, stages={"reduce": 0.25}, bidirectional=[("compute", "reduce")])
    fwd = gb.channel("compute", "reduce").stream_fold(x, chunk_op, torch.zeros_like(x))
    out["bidir/fwd"] = fwd
    out["bidir/back"] = gb.reverse_channel("compute", "reduce").stream_fold(
        fwd, chunk_op, torch.zeros_like(x))

    ch = g.channel("compute", "reduce")
    for w in range(ch.n_waves):
        out[f"scatter/{w}"] = ch.scatter_back(x + 100 * r, wave_of_target=w)

    y = x.reshape(-1)
    gt = GroupedMesh.trivial(mesh)
    g1 = GroupedMesh.build(mesh, services={"reduce": 1 / 8})
    out["psum_scatter/all"] = group_psum_scatter(y, gt, "compute")
    out["all_gather/all"] = group_all_gather(y, gt, "compute")
    out["psum_scatter/one"] = group_psum_scatter(y, g1, "reduce")
    out["all_gather/one"] = group_all_gather(y, g1, "reduce")

    out["role"] = torch.tensor(role_index(g.gmesh))
    out["select"] = select_by_role(g.gmesh, {"compute": lambda: x * 2,
                                             "reduce": lambda: x + 100})
    out["select3"] = select_by_role(g3.gmesh, {"reduce": lambda: x - 1, "io": lambda: x * 3})
    try:
        select_by_role(g.gmesh, {"compute": lambda: x, "reduce": lambda: x[:2]})
        out["select_mismatch_raised"] = torch.tensor(False)
    except ValueError:
        out["select_mismatch_raised"] = torch.tensor(True)

    # error feedback: SGD over compute -> reduce with an int8 wire
    gf = ServiceGraph.build(mesh, stages={"reduce": 0.25}, edges=[("compute", "reduce")],
                            wire={("compute", "reduce"): WireSpec(codec="int8",
                                                                  chunk_bytes=256)})
    fch = gf.channel("compute", "reduce")
    target = torch.from_numpy(inp["target"][r])
    params = torch.zeros(96)
    residual = torch.zeros(96)
    weight = 1.0 if gf.gmesh.is_member("compute") else 0.0
    for _ in range(FEEDBACK_STEPS):
        grads = (params - target) * weight
        corrected, residual = compress_with_feedback(grads, residual, "int8", chunk_bytes=256)
        acc = group_psum(fch.stream_fold_tree(corrected), gf.gmesh, "reduce")
        params = params - 0.1 * fch.broadcast_from_consumer(acc) / 6.0
    out["feedback/params"] = params

    cfg = CorpusCfg(**WC_CFG)
    corpus = make_corpus(cfg, cfg.n_docs_per_row * N_ROWS)
    for name, mode, kw in WC_VARIANTS:
        phases = {}
        out[f"wc/{name}"] = run_wordcount(mesh, mode, cfg, alpha=ALPHA, corpus=corpus,
                                          phases=phases, **kw)[0]
        out[f"wc_phases/{name}"] = torch.tensor([phases.get(p, 0.0) > 0 for p in PHASES[mode]])
    graph, gmesh, _ = wordcount_graph(mesh, "decoupled", ALPHA)
    t, m = row_docs(*corpus, r, gmesh.compute.size, N_ROWS)
    hist, work, stage = decoupled_wordcount_measured(torch.from_numpy(t), torch.from_numpy(m),
                                                     cfg.vocab, graph)
    out["measured/hist"], out["measured/work"], out["measured/stage"] = hist, work, stage

    qs = workload_stats(mesh, 0)
    out["quickstart/local"] = torch.tensor(qs["local"])
    if qs["stats"] is not None:
        out["quickstart/stats"] = torch.tensor([qs["stats"][k]
                                                for k in ("min", "max", "median", "count")])
    return {k: _np(v) for k, v in out.items()}


def cuda_wordcount_case(mesh, granularity_words: int) -> dict:
    """The word count in every mode on the card, with this rank's
    keyed-histogram launches per mode."""
    from repro_torch.apps.mapreduce import MODES, CorpusCfg, make_corpus, run_wordcount
    from repro_torch.kernels.stream_reduce import histogram_kernel

    cfg = CorpusCfg(**WC_CFG)
    corpus = make_corpus(cfg, cfg.n_docs_per_row * N_ROWS)
    out = {}
    for mode in MODES:
        before = histogram_kernel.launches
        hist, _ = run_wordcount(mesh, mode, cfg, alpha=ALPHA,
                                granularity_words=granularity_words, corpus=corpus)
        out[mode] = {"hist": hist.cpu().numpy(), "launches": histogram_kernel.launches - before,
                     "device": str(hist.device)}
    return out


IO_VOCAB = 64


def iogroup_cases(mesh, inputs_path: str, sink_dir: str) -> dict:
    """The decoupled I/O group: `io_sink_stage` as the tail of a chain
    (compute -> reduce -> io, the reference's test), `stream_to_io_group`
    draining to a `HostSink` (one io row; a ring that wraps; a bare
    `GroupedMesh`; two io rows, whose files must not collide)."""
    import os

    from repro_torch.core.dataflow import ServiceGraph, Stage, delta_emitter
    from repro_torch.core.decouple import group_psum
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.io.iogroup import HostSink, io_sink_stage, stream_to_io_group

    inp = dict(np.load(inputs_path))
    r = mesh.row
    out = {}

    graph = ServiceGraph.build(mesh, stages={"reduce": 1 / 4, "io": 1 / 8},
                               edges=[("compute", "reduce"), ("reduce", "io")])
    elems = torch.from_numpy(inp["tokens"][r]).float().reshape(4, -1)  # 4 chunks per row

    def hist_op(acc, elem, k):
        idx = elem.to(torch.int64).clamp(0, IO_VOCAB - 1)
        return acc.index_add_(0, idx, torch.ones_like(elem))

    zero = torch.zeros((IO_VOCAB,), dtype=torch.float32)
    head = Stage(src="compute", dst="reduce", operator=hist_op, init=zero, elements=elems,
                 emit=delta_emitter(zero))
    tail = io_sink_stage("reduce", granularity_elems=IO_VOCAB, capacity_chunks=16,
                         device=mesh.device)
    _, (buf, count) = graph.run_chain([head, tail])
    out["chain/total"] = group_psum(buf.sum(0), graph.gmesh, "io")
    out["chain/count"] = count

    x = {"x": torch.from_numpy(inp["x"][r])}
    io1 = ServiceGraph.build(mesh, stages={"io": 1 / 8}, edges=[("compute", "io")])
    for name, kw in (("drain", {}), ("wrap", {"capacity_chunks": 4})):
        sink = HostSink(os.path.join(sink_dir, name))
        out[f"{name}/count"] = stream_to_io_group(x, io1, sink, granularity_elems=16,
                                                  **{"capacity_chunks": 64, **kw})
    bare = GroupedMesh.build(mesh, services={"io": 1 / 8})
    out["bare/count"] = stream_to_io_group(x, bare, HostSink(os.path.join(sink_dir, "bare")),
                                           granularity_elems=16)
    io2 = ServiceGraph.build(mesh, stages={"io": 2 / 8}, edges=[("compute", "io")])
    out["two/count"] = stream_to_io_group(x, io2, HostSink(os.path.join(sink_dir, "two")),
                                          granularity_elems=16)
    return {k: _np(v) for k, v in out.items()}


# -- the adaptive control loop (core/adapt), its migration and apps ----------------------

# the reference drills' settings: the word count at 8 rows (skew 0, 6
# supersteps), PIC's drifting sheet (tests/test_dataflow.py), a constant
# wall in both packages so that the decisions depend on the counters alone
ADAPT_WC_CFG = dict(n_docs_per_row=2, words_per_doc=256, vocab=500, skew=0.0)
ADAPT_WC_STEPS = 6
ADAPT_PIC_CFG = dict(capacity=1024, n_particles_total=1024, n_steps=2, dt=0.1, skew=0.9,
                     sheet_center0=0.25, drift=0.12, attract=2.0)
ADAPT_PIC_STEPS = 4
ADAPT_POLICY = dict(window=2, cooldown=1, speedup_threshold=1.05)
CONST_WALL = 0.05
# row r's local clock advances ROW_TICK[0] + r * ROW_TICK[1] a call, and
# the planner's threshold sits between the word count's predicted speedups
# at the slowest and the fastest row's wall (1.69509 at 1e-4 s, 1.69551 at
# 0.049 s): on its own wall, row 0 would not regroup where row 7 would
ROW_TICK = (1e-4, 0.007)
WALL_THRESHOLD = 1.6953
RESHARD_SHAPE = (4, 3)


def _wc_report(report) -> list:
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in r.items()
             if k != "histogram"} for r in report]


def adapt_cases(mesh, inputs_path: str) -> dict:
    """Every case of tests/test_torch_adapt.py in one 8-row world: the
    adaptive word count at alpha0 0.125 and 0.25 (a constant wall; the
    keyed-histogram calls counted), the static decoupled run of each
    superstep's corpus, adaptive PIC (a constant wall), `reshard_state`
    (re-deal, pass-through, errors), the word count under row-dependent
    local clocks, and regroups back to an earlier partition."""
    import types

    import repro_torch.apps.mapreduce as mr
    import repro_torch.apps.pic as pic
    import repro_torch.core.adapt as adapt
    from repro_torch.core.adapt import AdaptiveGraph, AdaptPolicy, ReplanDecision
    from repro_torch.core.dataflow import ServiceGraph
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.kernels.stream_reduce import ops as reduce_ops
    from repro_torch.launch.elastic import reshard_state
    from repro_torch.launch.mesh import Mesh

    inp = dict(np.load(inputs_path))
    out: dict = {}
    calls = {"n": 0}
    keyed = reduce_ops.keyed_histogram

    def counted(*a, **kw):
        calls["n"] += 1
        return keyed(*a, **kw)

    reduce_ops.keyed_histogram = counted
    const = lambda fn, *a, mesh=None: (fn(*a), CONST_WALL)  # noqa: E731
    mr.timed_call = pic.timed_call = const
    cfg = mr.CorpusCfg(**ADAPT_WC_CFG)
    for name, alpha0 in (("wc_0125", 0.125), ("wc_025", 0.25)):
        calls["n"] = 0
        report, ag = mr.run_wordcount_adaptive(mesh, cfg, supersteps=ADAPT_WC_STEPS,
                                               alpha0=alpha0)
        out[name] = {"report": _wc_report(report), "rows": ag.rows, "calls": calls["n"],
                     "hist": np.stack([r["histogram"] for r in report]),
                     "speedups": [d.predicted_speedup for d in ag.history],
                     "expected_calls": mr.adaptive_histogram_launches(report, cfg, mesh.n_rows)}
    out["wc_static"] = np.stack([
        mr.run_wordcount(mesh, "decoupled", dataclasses.replace(cfg, seed=cfg.seed + t),
                         alpha=0.25)[0].numpy() for t in range(ADAPT_WC_STEPS)])

    pcfg = pic.PICCfg(**ADAPT_PIC_CFG)
    stats: dict = {}
    report, ag, state = pic.run_pic_adaptive(mesh, pcfg, alpha0=0.25, supersteps=ADAPT_PIC_STEPS,
                                             policy=AdaptPolicy(**ADAPT_POLICY), stats=stats)
    out["pic"] = {"report": report, "rows": ag.rows, "stats": stats,
                  "speedups": [d.predicted_speedup for d in ag.history],
                  "state": {k: t.numpy() for k, t in state.items()}}

    # reshard_state: the default re-deal from 2 reduce rows to 3, a
    # Python value passing through
    old = GroupedMesh.build_rows(mesh, rows={"reduce": 2})
    new = GroupedMesh.build_rows(mesh, rows={"reduce": 3})
    buf = torch.from_numpy(inp["buf"][mesh.row])
    got = reshard_state({"buf": buf, "scalar": 3.0}, old, new)
    out["reshard"] = {"buf": got["buf"].numpy(), "scalar": got["scalar"]}
    errors = {}
    for case, call in (
            ("bad_rows", lambda: reshard_state({"buf": buf}, old, new,
                                               repartition=lambda t, o, n: {
                                                   "buf": np.zeros((3,) + RESHARD_SHAPE)})),
            ("rank1", lambda: reshard_state({"s": torch.tensor(1.0)}, old, new)),
            ("axis_size", lambda: reshard_state(
                {"buf": buf}, old, GroupedMesh.build_rows(Mesh(n_rows=4, device="cpu"),
                                                          rows={"reduce": 1})))):
        try:
            call()
            errors[case] = None
        except Exception as e:  # noqa: BLE001 - the test holds the type and message
            errors[case] = (type(e).__name__, str(e))
    out["reshard_errors"] = errors

    # row-dependent local clocks, the real timed_call: the agreed wall
    mr.timed_call = adapt.timed_call
    clock = {"t": 0.0}

    def tick():
        clock["t"] += ROW_TICK[0] + ROW_TICK[1] * mesh.row
        return clock["t"]

    samples = []
    plain_step = AdaptiveGraph.step

    def recorded(self, wall, work, stage_items=None):
        samples.append((wall, np.asarray(work).tolist(), dict(stage_items)))
        return plain_step(self, wall, work, stage_items)

    adapt.time = types.SimpleNamespace(perf_counter=tick)
    AdaptiveGraph.step = recorded
    try:
        report, ag = mr.run_wordcount_adaptive(
            mesh, cfg, supersteps=ADAPT_WC_STEPS, alpha0=0.125,
            policy=AdaptPolicy(window=2, cooldown=1, speedup_threshold=WALL_THRESHOLD))
    finally:
        adapt.time = __import__("time")
        AdaptiveGraph.step = plain_step
    out["walls"] = {"report": _wc_report(report), "rows": ag.rows, "samples": samples,
                    "local": ROW_TICK[0] + ROW_TICK[1] * mesh.row}

    # back and forth between two partitions: each graph's word count exact
    g = ServiceGraph.build(mesh, stages={"reduce": 1 / 8}, edges=[("compute", "reduce")])
    ag = AdaptiveGraph(g, traits=mr.wordcount_traits(), policy=AdaptPolicy(**ADAPT_POLICY))
    corpus = mr.make_corpus(cfg, cfg.n_docs_per_row * mesh.n_rows)
    back = []
    for rows in (3, 1, 3, 2):
        graph = ag.apply(ReplanDecision(True, {"reduce": rows}, 1.0, "replan"))
        t, m = mr.row_docs(*corpus, mesh.row, graph.gmesh.compute.size, mesh.n_rows)
        hist = mr.decoupled_wordcount(torch.from_numpy(t), torch.from_numpy(m), cfg.vocab, graph)
        back.append((graph.gmesh.compute.size, hist.numpy()))
    out["back"] = back
    reduce_ops.keyed_histogram = keyed
    return out


def cuda_adaptive_wordcount_case(mesh) -> dict:
    """The adaptive word count on the card (alpha0 1/8, a constant wall, so
    it regroups as on the CPU), with this rank's keyed-histogram launches
    over the whole run, warmups included."""
    import repro_torch.apps.mapreduce as mr
    from repro_torch.kernels.stream_reduce import histogram_kernel

    mr.timed_call = lambda fn, *a, mesh=None: (fn(*a), CONST_WALL)
    cfg = mr.CorpusCfg(**ADAPT_WC_CFG)
    before = histogram_kernel.launches
    report, ag = mr.run_wordcount_adaptive(mesh, cfg, supersteps=4, alpha0=0.125)
    return {"launches": histogram_kernel.launches - before, "report": _wc_report(report),
            "hist": np.stack([r["histogram"] for r in report]),
            "expected": mr.adaptive_histogram_launches(report, cfg, mesh.n_rows)}


def cuda_reshard_case(mesh) -> dict:
    """`reshard_state` of a PIC state on the card, from 2 comm rows to 4 with
    the particle re-binning: this rank's old and new rows, and where the new
    one lies."""
    from repro_torch.apps.pic import _particle_repartition
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.launch.elastic import reshard_state

    cap = 4096
    rng = np.random.default_rng(11 + mesh.row)
    m = (rng.uniform(size=cap) < (0.3 if mesh.row < 6 else 0.0)).astype(np.float32)
    state = {"x": torch.from_numpy((rng.uniform(size=cap) * m).astype(np.float32)),
             "v": torch.from_numpy(rng.normal(size=cap).astype(np.float32)),
             "m": torch.from_numpy(m)}
    state = {k: t.to(mesh.device) for k, t in state.items()}
    old = GroupedMesh.build_rows(mesh, rows={"comm": 2})
    new = GroupedMesh.build_rows(mesh, rows={"comm": 4})
    got = reshard_state(state, old, new, repartition=_particle_repartition(cap, 1.0))
    return {"old": {k: t.cpu().numpy() for k, t in state.items()},
            "new": {k: t.cpu().numpy() for k, t in got.items()},
            "device": str(got["x"].device)}


# -- the disaggregated SPMD serving step and the serving reshard -------------------------

DISAGG_ROWS = 4
DISAGG = dict(slots_per_row=2, max_prompt=16, max_len=32, chunk_elems=512, decode_steps=2)
DISAGG_TICKS = 3
# 2 prefill rows + 2 decode rows (one wave); 3 + 1 (three waves)
DISAGG_ALPHAS = (0.5, 0.75)


def disagg_cases(mesh, inputs_path: str) -> dict:
    """Every world case of tests/test_torch_disagg.py in one 4-row world:
    `build_disagg_spmd_step` for `DISAGG_TICKS` ticks at each alpha (this
    rank's row of the outputs, stats, cache and tokens, and the wire's
    bytes), then `reshard_serving_state` inside the world (2 + 2 -> 1 + 3
    rows, all slots and with decode row 1 dead) and its refusal of a mesh
    of another size."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.groups import GroupedMesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model_zoo import build
    from repro_torch.serve.disagg import (
        PREFILL,
        build_disagg_spmd_step,
        disagg_row_state,
        init_disagg_state,
        serving_mesh,
    )
    from repro_torch.serve.fleet import reshard_serving_state
    from repro_torch.utils.convert import params_from_numpy

    inp = dict(np.load(inputs_path))
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    model = build(cfg, device="cpu")
    params = params_from_numpy(unflatten_params(inp, "p0/"), cfg, "cpu")
    spr = DISAGG["slots_per_row"]
    r = mesh.row
    out: dict = {}
    kept = None
    for alpha in DISAGG_ALPHAS:
        tag = f"a{alpha}"
        gmesh = serving_mesh(mesh, alpha)
        step, plan = build_disagg_spmd_step(model, gmesh, **DISAGG)
        cache, tokens = init_disagg_state(model, gmesh, slots_per_row=spr,
                                          max_len=DISAGG["max_len"])
        rc, rt = disagg_row_state(cache, tokens, gmesh, slots_per_row=spr)
        sent = mesh.stats.sent_bytes
        for t in range(DISAGG_TICKS):
            prompts = torch.from_numpy(inp[f"{tag}/prompts"][t, r:r + 1].astype(np.int64))
            plen = torch.from_numpy(inp[f"{tag}/plen"][t, r:r + 1])
            dst = torch.from_numpy(inp[f"{tag}/dst"][t, r:r + 1])
            rc, rt, outs, stats = step(params, prompts, plen, dst, rc, rt)
            out[f"{tag}/outs{t}"] = outs.numpy()
            out[f"{tag}/stats{t}"] = stats.numpy()
        out[f"{tag}/sent_bytes"] = np.int64(mesh.stats.sent_bytes - sent)
        out[f"{tag}/n_chunks"] = np.int64(plan.n_chunks)
        for k in ("k", "v"):
            out[f"{tag}/{k}"] = _np(rc[k])
        out[f"{tag}/pos"] = rc["pos"].numpy()
        out[f"{tag}/tokens"] = rt.numpy()
        if kept is None:
            kept = (gmesh, rc, rt)
    old, rc, rt = kept
    new = GroupedMesh.build_rows(mesh, rows={PREFILL: 1})
    for name, kw in (("all", {}), ("dead1", {"dead_rows": [1]})):
        nc, nt = reshard_serving_state(rc, rt, old, new, slots_per_row=spr, **kw)
        for k in ("k", "v"):
            out[f"reshard_{name}/{k}"] = _np(nc[k])
        out[f"reshard_{name}/pos"] = nc["pos"].numpy()
        out[f"reshard_{name}/tokens"] = nt.numpy()
    other = GroupedMesh.build_rows(Mesh(n_rows=3, device="cpu"), rows={PREFILL: 1})
    try:
        reshard_serving_state(rc, rt, old, other, slots_per_row=spr)
        out["reshard_other_size"] = np.asarray("")
    except ValueError as e:
        out["reshard_other_size"] = np.asarray(str(e))
    return out


# -- every family through the train step (tests/test_torch_train_*.py) ----------

FAMILY_ALPHA = ALPHA  # 6 compute rows, 2 reduce rows
FAMILY_STEPS = 3
FAMILY_CRASH_AT = 2  # the crash run saves at step 2 and fails before step 3


def family_pipeline(cfg, case: dict):
    """The reference's data of a case: Zipf tokens, skewed document
    lengths, the frontend's embeddings."""
    from repro_torch.data.pipeline import DataConfig, Pipeline

    return Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=case["seq"],
                               global_batch=case["batch"], seed=1, kind="zipf", skew=0.4,
                               frontend=cfg.frontend, n_frontend_tokens=cfg.n_frontend_tokens,
                               d_model=cfg.d_model))


def family_batch(pipe, mode: str, step: int, n_rows: int) -> dict:
    """The global batch of ``step`` as the mode's rows take it."""
    if mode == "decoupled":
        reduce_rows = max(1, int(round(FAMILY_ALPHA * n_rows)))
        return pipe.padded_for_groups(step, n_rows - reduce_rows, n_rows)
    return pipe.global_batch(step)


def family_train_cases(mesh, inputs_path: str, ckpt_root: str, cases: list) -> dict:
    """For each case (an f32 smoke config at a shape), from the reference's
    parameters: one SGD step (lr 1) of each of its ``sgd`` modes and a
    3-step AdamW `Trainer` run of each of its ``adamw`` modes; with
    ``per_row``, the conventional SGD update as per-row routing would give
    it (each row's MoE routing its own shard, its own aux_loss: what the
    reference's global batch does not do); with ``runtime_skip``, the
    decoupled SGD step with ``runtime_skip=False``; with ``zero1``, the
    AdamW run in overlap mode with ``zero1=False``; with ``crash``, a
    conventional AdamW run that saves at step 2 and fails, a fresh
    trainer resuming it to step 3, and (row 0) the step-2 files restored
    onto a one-row mesh and stepped once in one process. Torch on one
    thread a rank."""
    import os

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import row_shard
    from repro_torch.launch.elastic import restore_for_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model_zoo import build
    from repro_torch.train import sharding
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (
        TrainStepConfig,
        build_conventional_step,
        make_step,
        value_and_grad,
    )
    from repro_torch.train.trainer import SimulatedFailure, Trainer, TrainerConfig
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.treeutil import flatten, spec_of, tree_flatten, unflatten

    torch.set_num_threads(1)
    inp = dict(np.load(inputs_path))
    n = mesh.n_rows
    sgd = OptConfig(kind="sgdm", lr=1.0, beta1=0.0, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0, min_lr_ratio=1.0, total_steps=1)
    adamw = OptConfig(lr=ADAMW_LR, warmup_steps=0, total_steps=FAMILY_STEPS)
    out = {}

    def flat(tree, prefix):
        out.update({f"{prefix}{i}": _np(v) for i, v in enumerate(tree_flatten(tree)[0])})

    for case in cases:
        label = case["label"]
        cfg = dataclasses.replace(get_smoke(case["name"]), dtype=torch.float32)
        model = build(cfg, device="cpu")
        params = params_from_numpy(unflatten_params(inp, f"{label}/p0/"), cfg, "cpu",
                                   param_dtype=torch.float32)
        pipe = family_pipeline(cfg, case)

        def sgd_step(ts):
            opt = init_opt_state(sgd, params)
            if ts.mode == "overlap":
                opt = sharding.shard_opt_state(sharding.zero1_plan(params, n, mesh.row), opt)
            batch = row_shard(family_batch(pipe, ts.mode, 0, n), mesh.row, n)
            new, _, metrics = make_step(model, mesh, sgd, ts)(params, opt, batch)
            return new, metrics

        def trainer(ts, name, **kw):
            return Trainer(model, mesh, pipe, adamw, ts,
                           TrainerConfig(total_steps=FAMILY_STEPS, log_every=1,
                                         ckpt_dir=os.path.join(ckpt_root, label, name), **kw))

        def fresh():
            return {"params": _clone(params), "opt": init_opt_state(adamw, params), "step": 0}

        for mode in case["sgd"]:
            new, metrics = sgd_step(TrainStepConfig(mode=mode, reduce_alpha=FAMILY_ALPHA))
            flat(new, f"{label}/sgd/{mode}/new/")
            for k in ("loss", "aux_loss", "router_entropy"):
                if k in metrics:
                    out[f"{label}/sgd/{mode}/{k}"] = np.float64(metrics[k])
        for mode in case["adamw"]:
            tr = trainer(TrainStepConfig(mode=mode, reduce_alpha=FAMILY_ALPHA), mode)
            state = tr.run(fresh(), resume=False)
            tr.close()
            out[f"{label}/adamw/{mode}/loss"] = np.array([r["loss"] for r in tr.metrics_log])
            out[f"{label}/adamw/{mode}/moment_bytes"] = np.int64(tr.moment_bytes)
            flat(state["params"], f"{label}/adamw/{mode}/params/")
        if case.get("per_row"):
            # the data-parallel step as it was before the world routing: each
            # row's own loss sum (its shard routed alone), summed and divided
            shard = row_shard(family_batch(pipe, "conventional", 0, n), mesh.row, n)
            _, _, grads = value_and_grad(model.loss, params, shard)
            cnt = shard["mask"].sum()
            total = mesh.all_reduce(cnt.reshape(1))[0]
            g = mesh.all_reduce(flatten(grads) * cnt) / total
            flat(unflatten(spec_of(params), flatten(params) - g), f"{label}/per_row/new/")
        if case.get("runtime_skip"):
            new, metrics = sgd_step(TrainStepConfig(mode="decoupled", reduce_alpha=FAMILY_ALPHA,
                                                    runtime_skip=False))
            flat(new, f"{label}/sgd/decoupled_noskip/new/")
            out[f"{label}/sgd/decoupled_noskip/loss"] = np.float64(metrics["loss"])
        if case.get("zero1"):
            tr = trainer(TrainStepConfig(mode="overlap", zero1=False), "overlap_whole")
            state = tr.run(fresh(), resume=False)
            tr.close()
            out[f"{label}/adamw/overlap_whole/loss"] = np.array([r["loss"] for r in
                                                                 tr.metrics_log])
            out[f"{label}/adamw/overlap_whole/moment_bytes"] = np.int64(tr.moment_bytes)
            flat(state["params"], f"{label}/adamw/overlap_whole/params/")
        if case.get("crash"):
            ts = TrainStepConfig(mode="conventional")
            tr = trainer(ts, "crash", ckpt_every=FAMILY_CRASH_AT, fail_at_step=FAMILY_CRASH_AT)
            try:
                tr.run(fresh(), resume=False)
                out[f"{label}/crash/raised"] = np.bool_(False)
            except SimulatedFailure:
                out[f"{label}/crash/raised"] = np.bool_(True)
            tr.close()
            out[f"{label}/crash/loss"] = np.array([r["loss"] for r in tr.metrics_log])
            tr = trainer(ts, "crash")  # the same directory: resumes from step 2
            state = tr.run(fresh())
            tr.close()
            out[f"{label}/crash/resumed"] = np.int64(tr.resumed["step"])
            out[f"{label}/crash/resumed_loss"] = np.array([r["loss"] for r in tr.metrics_log])
            flat(state["params"], f"{label}/crash/params/")
            out[f"{label}/crash/dir"] = np.asarray(os.path.join(ckpt_root, label, "crash"))
            mesh.barrier()
            if mesh.row == 0:  # elastic: the step-2 files onto one row, one process
                one = Mesh(n_rows=1, device="cpu")
                like = {"params": params, "opt": init_opt_state(adamw, params), "step": 0}
                back = restore_for_mesh(os.path.join(ckpt_root, label, "crash"),
                                        FAMILY_CRASH_AT, like, one)
                new, _, metrics = build_conventional_step(model, adamw)(
                    back["params"], back["opt"], family_batch(pipe, "conventional",
                                                              FAMILY_CRASH_AT, n))
                out[f"{label}/elastic/loss"] = np.float64(metrics["loss"])
                out[f"{label}/elastic/step"] = np.int64(back["step"])
                flat(new, f"{label}/elastic/params/")
            mesh.barrier()
    return out
