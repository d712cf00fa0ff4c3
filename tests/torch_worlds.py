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
    5; and checkpoints that cross between overlap and conventional mode."""
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
