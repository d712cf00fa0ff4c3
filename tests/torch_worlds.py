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


def train_cases(mesh, inputs_path: str) -> dict:
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
                      TrainerConfig(total_steps=3, log_every=1))
    state = {"params": params, "opt": init_opt_state(adamw, params), "step": 0}
    trainer.run(state)
    out["trainer/loss"] = np.array([row["loss"] for row in trainer.metrics_log], np.float64)
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
