"""Train-step builders: the paper's technique as a training feature (a
port of the reference's `train/train_step.py`).

  conventional  every row computes its shard's gradient, and the rows
                all-reduce one flat gradient buffer (every operation on
                every process, Fig. 3a); with one row, one process
                computes the whole global batch's gradient.

  decoupled     the gradient reduction runs on a reducer service group
                (``reduce_alpha`` of the world's rows, Fig. 3c). Compute
                rows stream their raw gradients over the compute->reduce
                channel (the wire declared on that edge: codec and chunk
                size); the reducer folds them as they arrive, completes
                the small intra-group sum and broadcasts the reduced
                gradient back; every row applies the same update. Service
                rows skip forward and backward (the reference's default,
                ``runtime_skip``, is the only form here). With
                ``analytics_alpha > 0`` the reducer streams the reduced
                gradient on to an analytics group, which computes its
                norm and abs-max off the update's path.

  overlap       ZeRO-1 (`train.sharding`): the rows reduce-scatter the
                flat gradient, clip with the global norm, update their own
                part of the parameters and moments, and all-gather the
                parameters. The reference gets the same collectives from
                GSPMD sharding constraints.

Each rank runs the step on its own row's shard of the batch
(`data.pipeline.row_shard`). Every mode sums the rows' local loss sums
and token counts and divides once by the global count, so a row whose
shard is wholly masked adds nothing (never a mean of means). Not ported:
the reference's ``runtime_skip=False``, ``zero1=False`` and FSDP
(``fsdp``, ``fsdp_threshold``; ROADMAP A8).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.dataflow import COMPUTE, ServiceGraph, work_vector
from repro_torch.core.decouple import group_psum
from repro_torch.core.wire import WireSpec
from repro_torch.train import sharding
from repro_torch.train.optimizer import OptConfig, apply_updates
from repro_torch.utils.treeutil import (
    flatten,
    spec_of,
    tree_flatten,
    tree_leaves,
    tree_meta,
    tree_unflatten,
    unflatten,
)

REDUCE = "reduce"
ANALYTICS = "analytics"


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    mode: str = "conventional"  # conventional | decoupled | overlap
    reduce_alpha: float = 1 / 16
    analytics_alpha: float = 0.0
    # wire codec of the decoupled gradient stream: none | int8 | bf16
    compress: str = "none"
    # wire granularity of the gradient stream in bytes; None keeps the
    # whole-payload fold per wave
    wire_chunk_bytes: int | None = None


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``; grads have the params' structure (zeros where unused)."""
    leaves, treedef = tree_flatten(params)
    tracked = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_fn(tree_unflatten(treedef, tracked), batch)
    grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tracked, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_unflatten(treedef, grads)


def build_conventional_step(model, opt_cfg: OptConfig, *, inplace: bool = False):
    """The step of one process on the whole global batch."""

    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model.loss, params, batch)
        new_params, new_state = apply_updates(opt_cfg, params, grads, opt_state,
                                              inplace=inplace)
        return new_params, new_state, {**metrics, "loss": loss}

    return step


def _loss_sum(model):
    """``model.loss`` as a local sum (mean x token count), so that the
    rows' sums combine into the global mean."""

    def loss_sum(params, batch):
        loss_mean, metrics = model.loss(params, batch)
        return loss_mean * batch["mask"].sum(), metrics

    return loss_sum


class _Laps:
    """One step call's phase times, each phase ended by a device
    synchronise, and the call's `WireStats` deltas (``wire_*``)."""

    def __init__(self, mesh):
        self.mesh, self.t = mesh, {}
        self.stats0 = mesh.stats.as_dict()
        self.clock = time.perf_counter()

    def __call__(self, name: str) -> None:
        self.mesh.sync()
        now = time.perf_counter()
        self.t[name + "_s"] = now - self.clock
        self.clock = now

    def done(self) -> dict:
        stats1 = self.mesh.stats.as_dict()
        self.t.update({"wire_" + k: stats1[k] - self.stats0[k] for k in stats1})
        return self.t


def _row_gradient(model, params, batch):
    """This row's gradient of its local loss sum, and the row's [loss sum,
    token count, token-weighted metrics] for one world sum
    (`_world_means`)."""
    loss_tot, metrics, grads = value_and_grad(_loss_sum(model), params, batch)
    cnt = batch["mask"].sum().float()
    names = sorted(metrics)
    vec = torch.stack([loss_tot.float(), cnt] + [metrics[k].float() * cnt for k in names])
    return grads, names, vec.cpu()


def _world_means(mesh, names, vec) -> tuple[float, dict]:
    """The global token count (at least 1), and the loss and metrics as
    means over every row's tokens."""
    sums = mesh.all_reduce(vec)
    total = max(float(sums[1]), 1.0)
    out = {"loss": float(sums[0]) / total}
    out.update({k: float(sums[2 + i]) / total for i, k in enumerate(names)})
    return total, out


def build_data_parallel_step(model, opt_cfg: OptConfig, mesh, *, inplace: bool = False):
    """The conventional step over the rows of a world: each row's
    gradient, one all-reduce of the flattened gradient, the same update on
    every row. ``step.timings`` gets one dict per call: seconds in forward
    and backward, in the all-reduces (the gradient's and the scalars') and
    in the update, and the call's `WireStats` deltas."""
    timings: list[dict] = []

    def step(params, opt_state, batch):
        laps = _Laps(mesh)
        grads, names, vec = _row_gradient(model, params, batch)
        spec = spec_of(grads)
        flat = flatten(grads)
        del grads
        laps("fwd_bwd")
        total, out = _world_means(mesh, names, vec)
        flat = mesh.all_reduce(flat).div_(total)
        laps("all_reduce")
        new_params, new_state = apply_updates(opt_cfg, params, unflatten(spec, flat),
                                              opt_state, inplace=inplace)
        del flat
        laps("update")
        timings.append(laps.done())
        return new_params, new_state, out

    step.timings = timings
    return step


def build_overlap_step(model, opt_cfg: OptConfig, mesh, *, inplace: bool = False):
    """ZeRO-1 over the rows of a world (`train.sharding`): the step takes
    and returns the optimizer state as this row's parts of the moments
    (`sharding.shard_opt_state`). Each row's gradient is reduce-scattered
    into the rows' parts; the clip takes the global norm from an
    all-reduce of every part's sum of squares; each row updates its part
    of the parameters and moments; the rows all-gather the parameters.
    ``step.timings`` gets seconds in forward and backward, the
    reduce-scatter (and the scalars' all-reduce), the sharded update (the
    norm's all-reduce included) and the all-gather, and the call's
    `WireStats` deltas."""
    timings: list[dict] = []

    def step(params, opt_state, batch):
        laps = _Laps(mesh)
        plan = sharding.zero1_plan(params, mesh.n_rows, mesh.row)
        grads, names, vec = _row_gradient(model, params, batch)
        flat = sharding.flat_padded(plan, grads)
        del grads
        laps("fwd_bwd")
        total, out = _world_means(mesh, names, vec)
        g = mesh.reduce_scatter(flat).div_(total)
        del flat
        laps("reduce_scatter")
        norm = None
        if opt_cfg.grad_clip > 0:
            norm = torch.sqrt(mesh.all_reduce(torch.sum(g * g).reshape(1))[0])
        part, new_state = apply_updates(opt_cfg, sharding.shard_of(plan, params), g,
                                        opt_state, inplace=inplace, grad_norm=norm)
        del g
        laps("update")
        full = sharding.gather(plan, mesh, part)
        if inplace:
            for p, new in zip(tree_leaves(params), tree_leaves(full)):
                p.copy_(new)
            full = params
        laps("all_gather")
        timings.append(laps.done())
        return full, new_state, out

    step.timings = timings
    return step


def train_service_graph(mesh, ts_cfg: TrainStepConfig, axis: str = "data") -> ServiceGraph:
    """compute -> reduce, chained on to analytics when ``analytics_alpha
    > 0``; the gradient stream's wire is declared on compute -> reduce."""
    stages = {REDUCE: ts_cfg.reduce_alpha}
    edges = [(COMPUTE, REDUCE)]
    codec = "identity" if ts_cfg.compress in ("none", "") else ts_cfg.compress
    wire = {(COMPUTE, REDUCE): WireSpec(codec=codec, chunk_bytes=ts_cfg.wire_chunk_bytes)}
    if ts_cfg.analytics_alpha > 0:
        stages[ANALYTICS] = ts_cfg.analytics_alpha
        edges.append((REDUCE, ANALYTICS))
    return ServiceGraph.build(mesh, stages=stages, edges=edges, axis=axis, wire=wire)


def build_decoupled_step(model, opt_cfg: OptConfig, graph: ServiceGraph,
                         ts_cfg: TrainStepConfig, *, inplace: bool = False):
    """This rank's decoupled step ``(params, opt_state, row_batch) ->
    (new_params, new_state, metrics)``. Every rank of the world calls it
    once per step. ``step.timings`` gets one dict per call: seconds in
    forward and backward, in the gradient stream (the consumer's folds
    included), in the analytics chain, in the broadcast back and in the
    update, each phase ended by a device synchronise, plus this call's
    `WireStats` deltas."""
    gmesh = graph.gmesh
    mesh = gmesh.mesh
    channel = graph.channel(COMPUTE, REDUCE)
    is_compute = gmesh.is_member(COMPUTE)
    is_reduce = gmesh.is_member(REDUCE)
    n_compute = gmesh.compute.size
    timings: list[dict] = []
    loss_sum = _loss_sum(model)

    def step(params, opt_state, batch):
        lap = _Laps(mesh)
        cnt = float(batch["mask"].sum())
        if is_compute:
            loss_tot, metrics, grads = value_and_grad(loss_sum, params, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            loss_tot = float(loss_tot)
        else:
            grads = tree_meta(params)  # this row sends nothing
            loss_tot, metrics, cnt = 0.0, {"ce": 0.0}, 0.0
        lap("fwd_bwd")

        # the decoupled reduce: raw gradients in, the folded sum out on the
        # reducer rows, then the master sum within the reducer group
        acc = channel.stream_fold_tree(grads)
        del grads
        acc = group_psum(acc, gmesh, REDUCE)
        if not is_reduce:
            acc = tree_meta(acc)  # only the reducer's values are read from here on
        lap("stream")

        grad_stats = None
        if graph.has_edge(REDUCE, ANALYTICS):
            # the chained stage: reducer rows hold identical sums, so the
            # analytics group overwrites rather than adds
            arrived = graph.channel(REDUCE, ANALYTICS).stream_fold_tree(
                acc, combine=lambda a, new, ok: new if ok else a)
            stats = torch.zeros(2, dtype=torch.float32, device=mesh.device)
            if gmesh.is_member(ANALYTICS):
                leaves = tree_leaves(arrived)
                gn2 = sum(torch.sum(torch.square(x.float())) for x in leaves)
                gmax = torch.stack([x.abs().max() for x in leaves]).max().float()
                stats = torch.stack([torch.sqrt(gn2), gmax])
            del arrived
            grad_stats = graph.broadcast_from(ANALYTICS, stats)
        lap("analytics")

        # one sum over the world for the scalars (loss, token count, the
        # compute rows' metrics); a second gathers each row's token count
        names = sorted(metrics)
        vec = torch.tensor([loss_tot, cnt] + [metrics[k] if is_compute else 0.0 for k in names],
                           dtype=torch.float32)
        sums = mesh.all_reduce(vec)
        work_rows = work_vector(gmesh, cnt)
        total_cnt = max(float(sums[1]), 1.0)

        reduced = channel.broadcast_from_consumer(acc)
        del acc
        for x in tree_leaves(reduced):
            x.div_(total_cnt)
        lap("broadcast")

        new_params, new_state = apply_updates(opt_cfg, params, reduced, opt_state,
                                              inplace=inplace)
        del reduced
        lap("update")

        out = {"loss": float(sums[0]) / total_cnt, "work_rows": work_rows}
        if grad_stats is not None:
            out["grad_norm"] = float(grad_stats[0]) / total_cnt
            out["grad_absmax"] = float(grad_stats[1]) / total_cnt
        for i, k in enumerate(names):
            out[k] = float(sums[2 + i]) / max(n_compute, 1)
        timings.append(lap.done())
        return new_params, new_state, out

    step.timings = timings
    return step


def make_step(model, mesh, opt_cfg: OptConfig, ts_cfg: TrainStepConfig, *,
              inplace: bool = False):
    """The step of ``ts_cfg.mode`` for this rank of ``mesh`` (the
    counterpart of the reference's `make_jitted_step`). ``inplace``: the
    update writes into the given params and moments. Every mode but a
    one-row conventional step runs in a world (`launch.mesh.spawn`); in
    overlap mode the optimizer state holds this row's parts of the
    moments (`train.sharding.shard_opt_state`)."""
    if ts_cfg.mode == "conventional":
        if mesh.n_rows == 1:
            return build_conventional_step(model, opt_cfg, inplace=inplace)
        return build_data_parallel_step(model, opt_cfg, mesh, inplace=inplace)
    if ts_cfg.mode == "overlap":
        return build_overlap_step(model, opt_cfg, mesh, inplace=inplace)
    if ts_cfg.mode == "decoupled":
        return build_decoupled_step(model, opt_cfg, train_service_graph(mesh, ts_cfg),
                                    ts_cfg, inplace=inplace)
    raise ValueError(ts_cfg.mode)


__all__ = ["ANALYTICS", "REDUCE", "TrainStepConfig", "build_conventional_step",
           "build_data_parallel_step", "build_decoupled_step", "build_overlap_step",
           "make_step", "train_service_graph", "value_and_grad"]
