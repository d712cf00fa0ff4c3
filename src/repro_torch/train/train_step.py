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
                rows skip forward and backward (``runtime_skip``, the
                reference's default); with ``runtime_skip=False`` they run
                both on their zero-masked shards and discard the gradient,
                as the reference's branch without ``lax.cond`` does. With
                ``analytics_alpha > 0`` the reducer streams the reduced
                gradient on to an analytics group, which computes its
                norm and abs-max off the update's path.

  overlap       ZeRO-1 (`train.sharding`): the rows reduce-scatter the
                flat gradient, clip with the global norm, update their own
                part of the parameters and moments, and all-gather the
                parameters. With ``zero1=False`` every row keeps whole
                moments (the reference's replicated moment specs): the
                reduced parts are all-gathered into the whole gradient and
                every row updates everything, with the same per-element
                arithmetic. The reference gets the same collectives from
                GSPMD sharding constraints.

FSDP (``fsdp``, by default ``"auto"``: on where the f32 parameters pass
``fsdp_threshold`` bytes, `use_fsdp`) keeps each row's part of every
unit's parameters and moments (`train.sharding.FsdpPlan`) in every mode.
In the conventional and overlap steps each layer is gathered just before
it runs and reduce-scattered in its backward (`build_fsdp_step`); in the
decoupled step every row gathers the whole parameters at the start, as
the reference's ``shard_map`` takes them whole, and updates its parts
from its slice of the broadcast gradient.

Each rank runs the step on its own row's shard of the batch
(`data.pipeline.row_shard`). Every mode sums the rows' local loss sums
and token counts and divides once by the global count, so a row whose
shard is wholly masked adds nothing (never a mean of means).

Every family trains. An MoE model's conventional and overlap steps are,
in the reference, one program over the global batch, so a routing group
may straddle two rows' shards and ``aux_loss`` is the global batch's:
there each row's forward routes over the world (`models.moe.RouteWorld`),
and its loss sum is its cross-entropy sum plus ``0.01 * aux_share *
N``, N the global token count, so that the rows' gradients sum to the
reference's; ``aux_loss`` and ``router_entropy`` are reported as the
world computed them. The decoupled step is per row in the reference too
(``shard_map``): each compute row routes its own shard.

The model axis (a world of more than one column, a model of any family
built with ``tp=mesh``): each rank holds its column's slices of the
parameters (`train.sharding.param_specs`, with the model's
``replicate_ssm``) and computes the tensor-parallel forward and backward
(`models.transformer.forward_lm`'s ``tp``, `models.encdec.encdec_loss`'s). Every mode runs
as above in each column over the column's data rows (`launch.mesh.Mesh`
takes data rows in the caller's column): the all-reduce, the
reduce-scatter and the gathers, ZeRO-1's and FSDP's parts of the
column's slices, and the decoupled step's stream, which carries each
column's gradient slices to that column's reducer row. Clipping and the
analytics statistics count every element of the gradient once: the
squares of sharded leaves are summed over the model axis too, those of
whole leaves over one column (`optimizer.model_axis_norm`). An MoE
model's experts split over the columns (`models.moe.apply_moe`), and
each column routes over its own rows (`models.moe.RouteWorld` on the
column's data rows).
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.core.adapt import StageTrait
from repro_torch.core.dataflow import COMPUTE, ServiceGraph, work_vector
from repro_torch.core.decouple import group_psum
from repro_torch.core.wire import WireSpec
from repro_torch.models import model_zoo, moe
from repro_torch.train import sharding
from repro_torch.train.optimizer import OptConfig, apply_updates, global_norm, model_axis_norm
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
    zero1: bool = True  # overlap mode: moments in parts (False: whole on every row)
    runtime_skip: bool = True  # decoupled mode: service rows skip forward and backward
    # FSDP: shard params over the data axes too (all-gathered per layer
    # inside the scan). "auto" switches on when fp32 params exceed
    # fsdp_threshold bytes per device under model-parallel sharding only.
    fsdp: bool | str = "auto"
    fsdp_threshold: float = 6e9


def param_shapes(model, *, whole: bool = False) -> dict:
    """The model's parameters as a training step holds them (f32), as
    ``meta`` tensors: shapes and dtypes, no storage. On a model axis,
    this column's slices, or with ``whole`` the whole parameters."""
    if whole and model.tp is not None:
        model = model_zoo.build(model.cfg, device="meta")
    return sharding.join_units(
        (u, model.init_unit(0, u, param_dtype=torch.float32, device="meta"))
        for u in model.units)


def use_fsdp(params_or_cfg, ts_cfg: TrainStepConfig, model_size: int = 1) -> bool:
    """The reference's rule (`make_jitted_step`): ``ts_cfg.fsdp`` itself
    unless it is ``"auto"``; then whether the whole parameters at 4 bytes
    an element, whatever their dtype, over ``model_size`` (the model
    axis's columns) pass ``fsdp_threshold``. ``params_or_cfg``: a whole
    parameter tree (of any tensors, ``meta`` included) or a config."""
    if ts_cfg.fsdp != "auto":
        return bool(ts_cfg.fsdp)
    params = params_or_cfg
    if not isinstance(params, dict):
        params = param_shapes(model_zoo.build(params_or_cfg, device="meta"))
    param_bytes = sum(leaf.numel() * 4 for leaf in tree_leaves(params))
    return param_bytes / model_size > ts_cfg.fsdp_threshold


def fsdp_plan_for(model, mesh, ts_cfg: TrainStepConfig) -> sharding.FsdpPlan | None:
    """This row's `FsdpPlan` (of this column's slices, on a model axis)
    where `use_fsdp` says so at the mesh's model axis and the world has
    more than one data row (on one row the parts are the whole, as the
    reference's one-way shard is), else None."""
    if mesh.n_rows < 2:
        return None
    if not use_fsdp(param_shapes(model, whole=True), ts_cfg, mesh.shape["model"]):
        return None
    return sharding.fsdp_plan(param_shapes(model), mesh.n_rows, mesh.row)


def sharded_leaves(model) -> list[bool] | None:
    """Which leaves of the parameters (in tree order) a model axis shards,
    or None without one."""
    if model.tp is None:
        return None
    return [sharding.model_dim(spec) is not None
            for spec in model.specs(param_shapes(model, whole=True))]


def _unit_flags(model) -> list[list[bool]]:
    """`sharded_leaves` unit by unit (`sharding.units_of`'s order)."""
    return [[sharding.model_dim(spec) is not None
             for spec in model.unit_specs(name, tree)]
            for name, tree in sharding.units_of(param_shapes(model, whole=True))]


def check_model_axis(model, mesh) -> None:
    """Raise unless ``model`` was built for ``mesh``'s model axis."""
    size = 1 if model.tp is None else model.tp.model_size
    if size != mesh.shape["model"]:
        raise ValueError(f"a model axis of {mesh.shape['model']} with a model built for "
                         f"{size} column(s): build it with tp=mesh")


def value_and_grad(loss_fn, params, batch, view=None):
    """(loss, metrics, grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``; grads have the params' structure (zeros where unused).
    ``view``: ``loss_fn`` takes ``view(params)`` (an FSDP step's tree of
    its parts, `sharding.FsdpWorld.tree`), and the gradient is still that
    of ``params``."""
    leaves, treedef = tree_flatten(params)
    tracked = [p.detach().requires_grad_(True) for p in leaves]
    tree = tree_unflatten(treedef, tracked)
    loss, metrics = loss_fn(tree if view is None else view(tree), batch)
    grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tracked, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_unflatten(treedef, grads)


def build_conventional_step(model, opt_cfg: OptConfig, *, inplace: bool = False):
    """The step of one process on the whole global batch (of one data row's
    columns, on a model axis)."""
    flags = sharded_leaves(model)

    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model.loss, params, batch)
        norm = None
        if opt_cfg.grad_clip > 0:
            norm = global_norm(grads, tp=model.tp, sharded=flags)
        new_params, new_state = apply_updates(opt_cfg, params, grads, opt_state,
                                              inplace=inplace, grad_norm=norm)
        return new_params, new_state, {**metrics, "loss": loss}

    return step


def _loss_sum(model, world=None, mask_total: float = 0.0):
    """``model.loss`` as a local sum (mean x token count), so that the
    rows' sums combine into the global mean. With a `moe.RouteWorld`, the
    row's cross-entropy sum plus ``0.01 * aux_share * mask_total`` (the
    global token count): the world's sum of those, over ``mask_total``,
    is the global loss ``ce + 0.01 * aux_loss``, gradient included."""

    def loss_sum(params, batch):
        if world is None:
            loss_mean, metrics = model.loss(params, batch)
            return loss_mean * batch["mask"].sum(), metrics
        _, metrics = model.loss(params, batch, route_world=world)
        share = metrics.pop("aux_share")
        return metrics["ce"] * batch["mask"].sum() + 0.01 * mask_total * share, metrics

    return loss_sum


class _Laps:
    """One step call's phase times, each phase ended by a device
    synchronise, and the call's `WireStats` deltas (``wire_*``) and, under
    FSDP, its `sharding.FsdpStats` deltas (``fsdp_*``)."""

    def __init__(self, mesh, world=None):
        self.mesh, self.world, self.t = mesh, world, {}
        self.stats0 = mesh.stats.as_dict()
        self.fsdp0 = None if world is None else world.stats.as_dict()
        self.clock = time.perf_counter()

    def __call__(self, name: str) -> None:
        self.mesh.sync()
        now = time.perf_counter()
        self.t[name + "_s"] = now - self.clock
        self.clock = now

    def done(self) -> dict:
        stats1 = self.mesh.stats.as_dict()
        self.t.update({"wire_" + k: stats1[k] - self.stats0[k] for k in stats1})
        if self.world is not None:
            fsdp1 = self.world.stats.as_dict()
            self.t.update({k: fsdp1[k] - self.fsdp0[k] for k in fsdp1})
        return self.t


def _row_gradient(model, params, batch, mesh, view=None):
    """This row's gradient of its local loss sum, the row's [loss sum,
    token count, token-weighted metrics] for one world sum
    (`_world_means`), and the metrics the world already computed (a model
    with `world_metrics` routes over ``mesh``: `_loss_sum`), each row
    holding the same value, reported as it is. ``view`` as in
    `value_and_grad`."""
    world, mask_total = None, 0.0
    if model.world_metrics:
        world = moe.RouteWorld(mesh)
        mask_total = float(mesh.all_reduce(batch["mask"].sum().reshape(1).float())[0])
    loss_tot, metrics, grads = value_and_grad(_loss_sum(model, world, mask_total), params,
                                              batch, view)
    cnt = batch["mask"].sum().float()
    fixed = {k: float(metrics.pop(k)) for k in model.world_metrics}
    names = sorted(metrics)
    vec = torch.stack([loss_tot.float(), cnt] + [metrics[k].float() * cnt for k in names])
    return grads, (names, fixed), vec.cpu()


def _world_means(mesh, keys, vec) -> tuple[float, dict]:
    """The global token count (at least 1), and the loss and metrics as
    means over every row's tokens; ``keys``: (the names of the metrics in
    ``vec``, the world's own metrics, taken as they are)."""
    names, fixed = keys
    sums = mesh.all_reduce(vec)
    total = max(float(sums[1]), 1.0)
    out = {"loss": float(sums[0]) / total, **fixed}
    out.update({k: float(sums[2 + i]) / total for i, k in enumerate(names)})
    return total, out


def build_data_parallel_step(model, opt_cfg: OptConfig, mesh, *, inplace: bool = False):
    """The conventional step over the rows of a world: each row's
    gradient, one all-reduce of the flattened gradient, the same update on
    every row. ``step.timings`` gets one dict per call: seconds in forward
    and backward, in the all-reduces (the gradient's and the scalars') and
    in the update, and the call's `WireStats` deltas."""
    timings: list[dict] = []
    flags = sharded_leaves(model)

    def step(params, opt_state, batch):
        laps = _Laps(mesh)
        grads, keys, vec = _row_gradient(model, params, batch, mesh)
        spec = spec_of(grads)
        flat = flatten(grads)
        del grads
        laps("fwd_bwd")
        total, out = _world_means(mesh, keys, vec)
        flat = mesh.all_reduce(flat).div_(total)
        laps("all_reduce")
        grads = unflatten(spec, flat)
        norm = None
        if opt_cfg.grad_clip > 0:
            norm = global_norm(grads, tp=model.tp, sharded=flags)
        new_params, new_state = apply_updates(opt_cfg, params, grads, opt_state,
                                              inplace=inplace, grad_norm=norm)
        del grads
        del flat
        laps("update")
        timings.append(laps.done())
        return new_params, new_state, out

    step.timings = timings
    return step


def build_overlap_step(model, opt_cfg: OptConfig, mesh, *, inplace: bool = False,
                       zero1: bool = True):
    """ZeRO-1 over the rows of a world (`train.sharding`): the step takes
    and returns the optimizer state as this row's parts of the moments
    (`sharding.shard_opt_state`). Each row's gradient is reduce-scattered
    into the rows' parts; the clip takes the global norm from an
    all-reduce of every part's sum of squares; each row updates its part
    of the parameters and moments; the rows all-gather the parameters.
    With ``zero1=False`` the state holds whole moments: the rows
    all-gather the reduced parts into the whole gradient instead, and
    every row updates all of the parameters and moments (the same
    per-element arithmetic, the same norm). ``step.timings`` gets seconds
    in forward and backward, the reduce-scatter (and the scalars'
    all-reduce), the update (the norm's all-reduce included) and the
    all-gather, and the call's `WireStats` deltas."""
    timings: list[dict] = []
    flags = sharded_leaves(model)

    def step(params, opt_state, batch):
        laps = _Laps(mesh)
        plan = sharding.zero1_plan(params, mesh.n_rows, mesh.row)
        grads, keys, vec = _row_gradient(model, params, batch, mesh)
        flat = sharding.flat_padded(plan, grads)
        del grads
        laps("fwd_bwd")
        total, out = _world_means(mesh, keys, vec)
        g = mesh.reduce_scatter(flat).div_(total)
        del flat
        laps("reduce_scatter")
        norm = None
        if opt_cfg.grad_clip > 0 and flags is None:
            norm = torch.sqrt(mesh.all_reduce(torch.sum(g * g).reshape(1))[0])
        elif opt_cfg.grad_clip > 0:
            norm = model_axis_norm(model.tp,
                                   mesh.all_reduce(sharding.square_sums(plan, g, flags)))
        if not zero1:
            whole = sharding.gather(plan, mesh, g)
            del g
            laps("all_gather")
            full, new_state = apply_updates(opt_cfg, params, whole, opt_state,
                                            inplace=inplace, grad_norm=norm)
            del whole
            laps("update")
            timings.append(laps.done())
            return full, new_state, out
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


def build_fsdp_step(model, opt_cfg: OptConfig, mesh, plan: sharding.FsdpPlan, *,
                    inplace: bool = False):
    """FSDP over the rows of a world: the step takes and returns this row's
    parts of the parameters and of the moments, one f32 tensor a unit
    (`sharding.FsdpPlan`). The forward runs on `sharding.FsdpWorld.tree`:
    the embedding and the rest are gathered at the start and kept, each
    layer is gathered where it begins, inside its checkpoint, and gathered
    again by its recompute; each unit's backward reduce-scatters its
    gradient, so the backward pass leaves this row's part of the rows'
    summed gradient. The clip takes the global norm from an all-reduce of
    the parts' sums of squares, and each row updates its parts. The
    reference's conventional and overlap steps are this one step under
    FSDP (its overlap mode's moment specs are the FSDP specs there; only
    its constraints' names differ), so ``zero1`` has no effect here.

    Every rank issues the same collectives in the same order: gloo blocks
    in each call until every rank has made it, so a rank whose order
    differed would hang the world until its timeout. The order is fixed by
    the model's structure alone: the same units in the same forward, the
    same recomputes and the same backward graph on every row; a row whose
    shard is wholly masked runs them all too (its loss is 0 times its
    tokens, with the whole graph). An MoE layer's routing exchanges
    (`moe.RouteWorld`) are stashed by the forward and replayed by the
    recompute; the unit gathers are not, which is what frees a layer
    between its forward and its backward. ``step.timings`` gets seconds in
    forward and backward (the gathers and reduce-scatters included; their
    own bytes and seconds are the ``fsdp_*`` keys), in the scalars'
    all-reduce and in the update, and the call's `WireStats` deltas."""
    world = sharding.FsdpWorld(plan, mesh)
    timings: list[dict] = []
    flags = sharded_leaves(model)
    unit_flags = None if flags is None else _unit_flags(model)

    def step(parts, opt_state, batch):
        laps = _Laps(mesh, world)
        grads, keys, vec = _row_gradient(model, parts, batch, mesh, view=world.tree)
        laps("fwd_bwd")
        total, out = _world_means(mesh, keys, vec)
        for g in grads:
            g.div_(total)
        laps("all_reduce")
        norm = None
        if opt_cfg.grad_clip > 0 and flags is None:
            sq = torch.stack([torch.sum(g * g) for g in grads]).sum()
            norm = torch.sqrt(mesh.all_reduce(sq.reshape(1))[0])
        elif opt_cfg.grad_clip > 0:
            sums = sum(sharding.square_sums(u, g, f)
                       for u, g, f in zip(plan.units, grads, unit_flags))
            norm = model_axis_norm(model.tp, mesh.all_reduce(sums))
        new_parts, new_state = apply_updates(opt_cfg, parts, grads, opt_state,
                                             inplace=inplace, grad_norm=norm)
        del grads
        laps("update")
        timings.append(laps.done())
        return new_parts, new_state, out

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


def train_stage_traits(ts_cfg: TrainStepConfig):
    """Calibration traits of the decoupled train chain (`core.adapt`):
    folding one token's gradient contribution costs a small fraction of
    its forward and backward, and the gradient stream's wire bytes
    amortise per token."""
    traits = [StageTrait(REDUCE, cost_ratio=0.2, bytes_per_item=64.0)]
    if ts_cfg.analytics_alpha > 0:
        traits.append(StageTrait(ANALYTICS, cost_ratio=0.05, bytes_per_item=64.0))
    return tuple(traits)


def build_decoupled_step(model, opt_cfg: OptConfig, graph: ServiceGraph,
                         ts_cfg: TrainStepConfig, *, inplace: bool = False,
                         fsdp: sharding.FsdpPlan | None = None):
    """This rank's decoupled step ``(params, opt_state, row_batch) ->
    (new_params, new_state, metrics)``. Every rank of the world calls it
    once per step. ``step.timings`` gets one dict per call: seconds in
    forward and backward, in the gradient stream (the consumer's folds
    included), in the analytics chain, in the broadcast back and in the
    update, each phase ended by a device synchronise, plus this call's
    `WireStats` deltas.

    ``fsdp``: the step takes and returns this row's parts of the
    parameters and moments. At the start every row, service rows included,
    gathers the whole parameters unit by unit (``gather_s``; the
    reference's ``shard_map`` takes them whole); the step runs as without
    FSDP and drops the whole parameters after its forward and backward;
    then each row updates its parts from its slice of the broadcast
    gradient, clipped by the whole gradient's norm (AdamW is elementwise,
    so the parts get the same numbers as the whole update)."""
    gmesh = graph.gmesh
    mesh = gmesh.mesh
    channel = graph.channel(COMPUTE, REDUCE)
    is_compute = gmesh.is_member(COMPUTE)
    is_reduce = gmesh.is_member(REDUCE)
    n_compute = gmesh.compute.size
    timings: list[dict] = []
    loss_sum = _loss_sum(model)
    world = None if fsdp is None else sharding.FsdpWorld(fsdp, mesh)
    flags = sharded_leaves(model)

    def step(params, opt_state, batch):
        lap = _Laps(mesh, world)
        parts = None
        if world is not None:
            parts, params = params, world.gather_all(params)
            lap("gather")
        cnt = float(batch["mask"].sum())
        if is_compute:
            loss_tot, metrics, grads = value_and_grad(loss_sum, params, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            loss_tot = float(loss_tot)
        elif ts_cfg.runtime_skip:
            grads = tree_meta(params)  # this row sends nothing
            # zeros for each metric a compute row's loss reports
            loss_tot, metrics, cnt = 0.0, dict.fromkeys(model.metrics, 0.0), 0.0
        else:
            # the reference without its cond: a service row runs forward and
            # backward on its (zero-masked) shard; its loss sum and count
            # enter the world's sums, its gradient and metrics are dropped
            loss_tot, _, grads = value_and_grad(loss_sum, params, batch)
            loss_tot, metrics = float(loss_tot), dict.fromkeys(model.metrics, 0.0)
            grads = tree_meta(params)  # this row sends nothing
        if parts is not None:
            params = None  # the rows drop the whole parameters
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
                gmax = torch.stack([x.abs().max() for x in tree_leaves(arrived)]).max().float()
                if flags is not None:
                    gmax = model.tp.model_all_reduce(gmax.reshape(1), dist.ReduceOp.MAX)[0]
                norm = global_norm(arrived, tp=model.tp, sharded=flags)
                stats = torch.stack([norm, gmax])
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

        norm = None
        if opt_cfg.grad_clip > 0:
            norm = global_norm(reduced, tp=model.tp, sharded=flags)
        if parts is None:
            new_params, new_state = apply_updates(opt_cfg, params, reduced, opt_state,
                                                  inplace=inplace, grad_norm=norm)
            del reduced
        else:
            grads = fsdp.shard(reduced)
            del reduced
            new_params, new_state = apply_updates(opt_cfg, parts, grads, opt_state,
                                                  inplace=inplace, grad_norm=norm)
            del grads
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
    one-row conventional step runs in a world (`launch.mesh.spawn`).
    ``step.fsdp`` is this row's `sharding.FsdpPlan` where FSDP is on
    (`fsdp_plan_for`), else None: the step then takes and returns this
    row's parts of the parameters and moments (`FsdpPlan.shard`,
    `FsdpPlan.shard_opt_state`). Without FSDP, in overlap mode with
    ``zero1`` (the default) the optimizer state holds this row's parts of
    the moments (`train.sharding.shard_opt_state`)."""
    if ts_cfg.mode not in ("conventional", "overlap", "decoupled"):
        raise ValueError(ts_cfg.mode)
    check_model_axis(model, mesh)
    plan = fsdp_plan_for(model, mesh, ts_cfg)
    if ts_cfg.mode == "decoupled":
        step = build_decoupled_step(model, opt_cfg, train_service_graph(mesh, ts_cfg), ts_cfg,
                                    inplace=inplace, fsdp=plan)
    elif plan is not None:
        step = build_fsdp_step(model, opt_cfg, mesh, plan, inplace=inplace)
    elif ts_cfg.mode == "overlap":
        step = build_overlap_step(model, opt_cfg, mesh, inplace=inplace, zero1=ts_cfg.zero1)
    elif mesh.n_rows == 1:
        step = build_conventional_step(model, opt_cfg, inplace=inplace)
    else:
        step = build_data_parallel_step(model, opt_cfg, mesh, inplace=inplace)
    step.fsdp = plan
    return step


__all__ = ["ANALYTICS", "REDUCE", "TrainStepConfig", "build_conventional_step",
           "build_data_parallel_step", "build_decoupled_step", "build_fsdp_step",
           "build_overlap_step", "check_model_axis", "fsdp_plan_for", "make_step",
           "param_shapes", "sharded_leaves",
           "train_service_graph", "train_stage_traits", "use_fsdp", "value_and_grad"]
