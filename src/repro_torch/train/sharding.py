"""ZeRO-1 and FSDP over the rank world (the port's counterpart of the
reference's `train/sharding.zero1_specs`, which its ``overlap`` mode puts
on the moments and its FSDP on the parameters and moments too).

The reference shards each moment leaf's largest free dimension over the
data axes and lets GSPMD turn the gradient all-reduce into a
reduce-scatter plus an all-gather of the parameters. Here each row owns
one contiguous ``1/n_rows`` part of the flattened f32 parameters (padded
with zeros to a multiple of ``n_rows``): the gradient is reduce-scattered
into those parts, each row updates its part of the parameters and keeps
only its part of the moments, and the rows all-gather the updated parts.
AdamW and SGD with momentum are elementwise with one weight decay for
every element, so any partition of the elements gives the reference's
numbers; only clipping needs the whole gradient's norm, which an
all-reduce of each part's sum of squares gives. A padded element has a
zero parameter and a zero gradient, and stays zero.

FSDP (`FsdpPlan`) applies the same partition to each unit of gathering
(`units_of`: the embedding, each layer, the rest) and keeps the
parameters in parts too: a row holds ``ceil(unit / n_rows)`` elements of
each unit's parameters and moments between steps. In the forward pass a
`LazyUnit` gathers a layer whole inside the function that
`torch.utils.checkpoint` wraps (`models.layers.unit_params`), so the
recompute gathers it again and no layer stays whole between its forward
and its backward; the backward reduce-scatters the unit's gradient into
this row's part (`_GatherUnit`). The layout is internal: checkpoints hold
whole trees (`gather_to_host`).

The model axis (`param_specs`, the reference's rule whole, every family):
each leaf's spec is a tuple of ``"model"`` / None a dimension, and a rank
of a (data, model) world holds its column's slice of every leaf whose
spec names ``"model"`` (`shard_model`; whole where the spec is all None).
The reference evaluates its rule on the stacked ``(L, ...)`` layer leaves
of its scanned tree, and the rule reads the dimension count, so the port,
which keeps layers as lists (`LAYER_LISTS`), evaluates it on the stacked
name and shape and drops the leading ``L`` (where the rule names ``L``
itself, llama4's shared expert, `spec_list`'s port rule shards its
``ff``). An MoE layer's experts shard over E where E divides the axis
(expert parallelism, the router's E columns with them), else over each
expert's ``ff``. ZeRO-1's and FSDP's plans
then partition the column's slices among the column's data rows, and
every data-axis collective of a step runs over the column. The
reference's ``REPRO_REPLICATE_SSM`` variable is the ``replicate_ssm``
keyword here (off by default, as with the variable unset).

The reference's other helpers place arrays on a GSPMD mesh:
`batch_specs`, `cache_specs`, `named` and `validate_divisibility` have
nothing to place here: each rank holds its own row's batch and caches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.utils.treeutil import (
    TreeSpec,
    flatten,
    pad_to_multiple,
    spec_of,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
    unflatten,
)

MOMENTS = ("m", "v")
EMBED, REST = "embed", "rest"
# the parameter lists whose entries are units of their own (and, in the
# reference, one scanned leaf a parameter, stacked on a leading L)
LAYER_LISTS = ("layers", "enc_layers", "dec_layers")
MODEL = "model"


# -- the model axis -------------------------------------------------------------------

def spec_for_leaf(names: Sequence[str], shape: tuple[int, ...], model_size: int, *,
                  replicate_ssm: bool = False) -> tuple:
    """The spec over the model axis of one parameter leaf of the
    reference's tree (its path names, its shape): the reference's
    `_spec_for_leaf`, as a tuple of ``"model"`` / None a dimension."""
    joined = ".".join(names)
    nd = len(shape)
    spec: list = [None] * nd
    if replicate_ssm and "mamba" in joined and any(
            k in joined for k in ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias")):
        return tuple(spec)

    def ok(dim: int) -> bool:
        return shape[dim] % model_size == 0 and shape[dim] >= model_size

    def at(dim: int) -> tuple:
        spec[dim] = MODEL
        return tuple(spec)

    # row-sharded projections (output side contracts into the residual)
    if any(k in joined for k in ("wo.w", "w_down.w", "out_proj.w")) and nd >= 2:
        dim = nd - 2
        if "w_down" in joined and "experts" not in joined and nd == 3:
            dim = 1  # stacked (L, ff, d)
        if ok(dim):
            return at(dim)
    # expert tensors (possibly stacked: (L, E, d, ff))
    if any(k in joined for k in ("w_gate", "w_up", "w_down")) and "moe" in joined and nd >= 3:
        if ok(nd - 3):
            return at(nd - 3)  # expert parallelism
        # tensor parallelism inside the experts: gate/up shard ff (last), down ff (-2)
        dim = nd - 2 if "w_down" in joined else nd - 1
        if ok(dim):
            return at(dim)
    # embedding / unembedding tables: shard the vocabulary
    if "table" in joined and nd == 2:
        return at(0) if ok(0) else tuple(spec)
    # biases: the last dim where it matches a column-sharded projection
    if names[-1] == "b" and nd >= 1:
        if any(k in joined for k in ("wq", "wk", "wv", "w_gate", "w_up")) and ok(nd - 1):
            return at(nd - 1)
        return tuple(spec)
    # default: column-shard the last dim of >= 2-D weights
    if names[-1] in ("w", "conv_w") or (nd >= 2 and names[-1] not in ("scale", "bias")):
        if nd >= 2 and ok(nd - 1):
            return at(nd - 1)
    return tuple(spec)


def _leaf_paths(tree: Any, names: tuple = (), depth: int | None = None) -> list:
    """(path names, stack depth or None) of every leaf, in `tree_flatten`'s
    order; an entry of a `LAYER_LISTS` list takes the list's name and its
    length as the depth of the reference's stacked leaf."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], names + (str(k),), depth)]
    if isinstance(tree, (list, tuple)):
        if depth is None and names and names[-1] in LAYER_LISTS:
            return [p for x in tree for p in _leaf_paths(x, names, len(tree))]
        return [p for i, x in enumerate(tree)
                for p in _leaf_paths(x, names + (str(i),), depth)]
    return [(names, depth)]


def spec_list(params: Any, model_size: int, *, replicate_ssm: bool = False) -> list[tuple]:
    """`param_specs` as a list in the leaves' `tree_flatten` order. A
    layer leaf's spec drops the stacked leaf's leading ``L`` entry.

    One port rule: the rule names ``L`` itself for one kind of stacked
    leaf, an MoE weight of three dimensions whose ``L`` divides the axis
    (llama4's shared expert ``w_gate``/``w_up``, ``(L, d, ff)``, whose
    expert dimension the rule takes to be ``L``), which would put whole
    layers on one column, and no per-layer spec can say that. Such a leaf
    takes the spec the rule gives where ``L`` does not divide the axis:
    its ``ff`` (last) dimension, the dense MLP's column split, beside the
    ``w_down`` rows the rule already shards over ``ff``
    (`models.layers.apply_mlp_tp` serves the pair). A rank holds as many
    elements as under the reference's split, the function is the same,
    and checkpoints hold whole trees."""
    out = []
    for (names, depth), leaf in zip(_leaf_paths(params), tree_leaves(params)):
        shape = tuple(leaf.shape)
        if depth is None:
            out.append(spec_for_leaf(names, shape, model_size, replicate_ssm=replicate_ssm))
            continue
        spec = spec_for_leaf(names, (depth,) + shape, model_size, replicate_ssm=replicate_ssm)
        if spec[0] == MODEL:  # the port rule: the spec of a stack of one layer
            spec = spec_for_leaf(names, (1,) + shape, model_size, replicate_ssm=replicate_ssm)
        out.append(spec[1:])
    return out


def param_specs(params: Any, model_size: int, *, replicate_ssm: bool = False) -> Any:
    """The tree of specs matching ``params`` (the port's tree of any
    tensors, ``meta`` included: shapes alone are read), each leaf's as the
    reference's `param_specs` gives it for the stacked leaf, without the
    stack's dimension."""
    return tree_unflatten(tree_flatten(params)[1],
                          spec_list(params, model_size, replicate_ssm=replicate_ssm))


def unit_specs(name: str, unit: Any, model_size: int, *,
               replicate_ssm: bool = False) -> list[tuple]:
    """The specs of one unit's leaves (`units_of`), in its own flattening
    order."""
    return spec_list(join_units([(name, unit)]), model_size, replicate_ssm=replicate_ssm)


def model_dim(spec: tuple) -> int | None:
    """The dimension a spec shards over the model axis, or None (whole)."""
    return spec.index(MODEL) if MODEL in spec else None


def model_shard(leaf, spec: tuple, model_size: int, col: int):
    """Column ``col``'s slice of a whole leaf (a tensor, ``meta`` included,
    or a numpy array, a memory map included), a copy of its own; the leaf
    itself where the spec keeps it whole."""
    d = model_dim(spec)
    if d is None or model_size == 1:
        return leaf
    n = leaf.shape[d] // model_size
    if isinstance(leaf, np.ndarray):
        index = [slice(None)] * leaf.ndim
        index[d] = slice(col * n, (col + 1) * n)
        return np.ascontiguousarray(leaf[tuple(index)])
    return leaf.narrow(d, col * n, n).clone(memory_format=torch.contiguous_format)


def shard_model(tree: Any, specs: list, model_size: int, col: int) -> Any:
    """Column ``col``'s slices of a whole tree (``specs``: `spec_list`)."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [model_shard(x, s, model_size, col)
                                    for x, s in zip(leaves, specs)])


def gather_model(tree: Any, specs: list, mesh) -> Any:
    """The whole leaves of this row's columns' slices (collective over
    the row's columns, one all-gather a sharded leaf)."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x if model_dim(s) is None
                                    else mesh.model_all_gather(x, model_dim(s))
                                    for x, s in zip(leaves, specs)])


def square_sums(plan: "Zero1Plan", part: torch.Tensor,
                sharded: Sequence[bool]) -> torch.Tensor:
    """[sum of squares over the elements of model-sharded leaves, over
    those of whole ones] of this row's part of a flat buffer in ``plan``'s
    layout (a whole tree is the part of a one-row plan). On a model axis
    the first sums over every rank and the second over one column, so
    that every element of the gradient counts once in its norm."""
    out = torch.zeros(2, dtype=torch.float32, device=part.device)
    span, off = plan.span, 0
    for size, sh in zip(plan.spec.sizes, sharded):
        lo, hi = max(off, span.start), min(off + size, span.stop)
        if lo < hi:
            seg = part[lo - span.start:hi - span.start].float()
            out[0 if sh else 1] += torch.sum(seg * seg)
        off += size
    return out



@dataclasses.dataclass(frozen=True)
class Zero1Plan:
    """Which part of the flattened parameters row ``row`` of ``n_rows`` owns."""

    spec: TreeSpec
    n_rows: int
    row: int

    @property
    def part(self) -> int:
        """Elements per row: the flat length rounded up to ``n_rows`` parts."""
        return -(-self.spec.total // self.n_rows)

    @property
    def span(self) -> slice:
        return slice(self.row * self.part, (self.row + 1) * self.part)


def zero1_plan(params: Any, n_rows: int, row: int) -> Zero1Plan:
    return Zero1Plan(spec_of(params), n_rows, row)


def flat_padded(plan: Zero1Plan, tree: Any) -> torch.Tensor:
    """``tree`` (the parameters' structure) as one f32 buffer of
    ``n_rows`` whole parts."""
    return pad_to_multiple(flatten(tree, torch.float32), plan.n_rows)


def shard_of(plan: Zero1Plan, tree: Any) -> torch.Tensor:
    """This row's part of ``tree``, a new f32 tensor (copied leaf by leaf,
    without the whole flat buffer)."""
    leaves = tree_leaves(tree)
    span = plan.span
    out = torch.zeros((plan.part,), dtype=torch.float32, device=leaves[0].device)
    off = 0
    for leaf, size in zip(leaves, plan.spec.sizes):
        lo, hi = max(off, span.start), min(off + size, span.stop)
        if lo < hi:
            out[lo - span.start:hi - span.start] = leaf.reshape(-1)[lo - off:hi - off]
        off += size
    return out


def gather(plan: Zero1Plan, mesh, part: torch.Tensor) -> Any:
    """Every row's ``part``, all-gathered and unflattened into the
    parameters' structure (leaves in their own dtypes)."""
    return unflatten(plan.spec, mesh.all_gather(part)[:plan.spec.total])


def shard_opt_state(plan: Zero1Plan, state: dict) -> dict:
    """An optimizer state of whole moment trees -> this row's parts."""
    return {k: shard_of(plan, v) if k in MOMENTS else v for k, v in state.items()}


def gather_opt_state(plan: Zero1Plan, mesh, state: dict) -> dict:
    """This row's moment parts -> whole moment trees (collective: every
    row calls it)."""
    return {k: gather(plan, mesh, v) if k in MOMENTS else v for k, v in state.items()}


# -- FSDP ---------------------------------------------------------------------------

def units_of(params: dict) -> list[tuple[str, Any]]:
    """The units of gathering of a parameter tree, in order: ``embed``,
    each entry of its layer lists (``layers.i``; an encoder-decoder's
    ``enc_layers.i``, then ``dec_layers.i``), and ``rest``, the other
    top-level entries (final norms, ``lm_head``). ``Model.units`` names
    the same units."""
    units = [(EMBED, params[EMBED])]
    for key in LAYER_LISTS:
        units += [(f"{key}.{i}", p) for i, p in enumerate(params.get(key, ()))]
    rest = {k: v for k, v in params.items() if k != EMBED and k not in LAYER_LISTS}
    return units + ([(REST, rest)] if rest else [])


def join_units(units) -> dict:
    """The parameter tree of ``(name, unit)`` pairs in `units_of`'s order."""
    params: dict = {}
    for name, tree in units:
        if name == REST:
            params.update(tree)
        elif name == EMBED:
            params[EMBED] = tree
        else:
            params.setdefault(name.rsplit(".", 1)[0], []).append(tree)
    return params


@dataclasses.dataclass(frozen=True)
class FsdpPlan:
    """A row's part of each unit: one `Zero1Plan` a unit, in `units_of`'s
    order, each naming the row."""

    names: tuple[str, ...]
    units: tuple[Zero1Plan, ...]

    @property
    def n_rows(self) -> int:
        return self.units[0].n_rows

    def shard(self, params: dict) -> list[torch.Tensor]:
        """This row's parts of a whole parameter tree (or of a tree of its
        structure: a gradient, a moment), one f32 tensor a unit."""
        return [shard_of(plan, tree) for plan, (_, tree) in zip(self.units, units_of(params))]

    def shard_units(self, unit: Callable[[str], Any]) -> list[torch.Tensor]:
        """This row's parts, taking each unit whole from ``unit(name)`` one
        at a time (a draw, a conversion, a read from the host): no more
        than one unit is whole at once."""
        return [shard_of(plan, unit(name)) for name, plan in zip(self.names, self.units)]

    def shard_opt_state(self, state: dict) -> dict:
        """An optimizer state of whole moment trees -> this row's parts."""
        return {k: self.shard(v) if k in MOMENTS else v for k, v in state.items()}


def fsdp_plan(params_like: dict, n_rows: int, row: int) -> FsdpPlan:
    """The plan of ``params_like``'s units (shapes and dtypes alone are
    read: a tree of ``meta`` tensors will do)."""
    named = units_of(params_like)
    return FsdpPlan(tuple(n for n, _ in named),
                    tuple(zero1_plan(tree, n_rows, row) for _, tree in named))


@dataclasses.dataclass
class FsdpStats:
    """Bytes and seconds of this rank's FSDP collectives: the all-gathers
    (their whole units) and the reduce-scatters (their padded gradients)."""

    gathers: int = 0
    gather_bytes: int = 0
    gather_s: float = 0.0
    reduce_scatters: int = 0
    reduce_scatter_bytes: int = 0
    reduce_scatter_s: float = 0.0

    def as_dict(self) -> dict:
        return {"fsdp_" + k: v for k, v in dataclasses.asdict(self).items()}


class FsdpWorld:
    """An `FsdpPlan` on this rank's `launch.mesh.Mesh`: the gathers and
    reduce-scatters of a step, counted in ``stats``."""

    def __init__(self, plan: FsdpPlan, mesh):
        self.plan, self.mesh, self.stats = plan, mesh, FsdpStats()

    def gather(self, i: int, part: torch.Tensor) -> Any:
        """Unit ``i`` whole (collective: every row calls it, in one order)."""
        t0 = time.perf_counter()
        plan = self.plan.units[i]
        tree = gather(plan, self.mesh, part)
        self.mesh.sync()
        self.stats.gathers += 1
        self.stats.gather_bytes += plan.spec.total * 4
        self.stats.gather_s += time.perf_counter() - t0
        return tree

    def reduce_scatter(self, i: int, grads: list) -> torch.Tensor:
        """This row's part of the world's sum of unit ``i``'s gradient
        leaves (collective)."""
        t0 = time.perf_counter()
        flat = flat_padded(self.plan.units[i], grads)
        out = self.mesh.reduce_scatter(flat)
        self.mesh.sync()
        self.stats.reduce_scatters += 1
        self.stats.reduce_scatter_bytes += flat.numel() * flat.element_size()
        self.stats.reduce_scatter_s += time.perf_counter() - t0
        return out

    def gather_all(self, parts: list) -> dict:
        """The whole parameter tree (collective), unit by unit, without autograd."""
        return join_units((name, self.gather(i, part))
                          for i, (name, part) in enumerate(zip(self.plan.names, parts)))

    def tree(self, parts: list) -> dict:
        """The tree ``model.loss`` takes for these parts (collective): the
        embedding and the rest gathered now, each layer a `LazyUnit`. The
        embedding is gathered once for both of its ends (a tied table is
        the input embedding and the output projection): autograd sums the
        two uses' gradients before its one reduce-scatter."""
        units = []
        for i, (name, part) in enumerate(zip(self.plan.names, parts)):
            lazy = LazyUnit(self, i, part)
            units.append((name, lazy() if name in (EMBED, REST) else lazy))
        return join_units(units)


class _GatherUnit(torch.autograd.Function):
    """Forward: unit ``i``'s part -> its whole leaves (an all-gather).
    Backward: the leaves' gradients -> this row's part of their world sum
    (a reduce-scatter). Nothing is saved for the backward pass."""

    @staticmethod
    def forward(ctx, part, world, i):
        ctx.world, ctx.i = world, i
        return tuple(tree_leaves(world.gather(i, part.detach())))

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.world.plan.units[ctx.i].spec
        grads = [torch.zeros(shape, dtype=torch.float32, device=ctx.world.mesh.device)
                 if g is None else g for g, shape in zip(grads, spec.shapes)]
        return ctx.world.reduce_scatter(ctx.i, grads), None, None


class LazyUnit:
    """A unit held as this row's ``part``; calling it gathers the whole
    unit through `_GatherUnit` (collective). The layer functions call it
    where the layer begins (`models.layers.unit_params`)."""

    def __init__(self, world: FsdpWorld, i: int, part: torch.Tensor):
        self.world, self.i, self.part = world, i, part

    @property
    def requires_grad(self) -> bool:
        return self.part.requires_grad

    def __call__(self) -> Any:
        leaves = _GatherUnit.apply(self.part, self.world, self.i)
        return tree_unflatten(self.world.plan.units[self.i].spec.treedef, list(leaves))


def _host(t: torch.Tensor) -> np.ndarray:
    a = t.detach().to("cpu", copy=True).numpy()
    a.setflags(write=False)  # the checkpoint writer keeps it without a copy
    return a


def gather_to_host(plan: FsdpPlan, mesh, parts: list, keep: bool,
                   specs: list | None = None) -> dict | None:
    """The whole tree of these parts as read-only host numpy arrays where
    ``keep`` (the rank writing a checkpoint), else None. Collective: each unit is
    gathered on every row, one at a time, and copied to the host where
    ``keep``; no row holds the whole tree on the device. ``specs`` (each
    unit's `unit_specs`, on a model axis): row 0's columns also gather each
    unit's sharded leaves over the model axis (collective over row 0), so
    that the copy is the whole unit."""
    units = []
    for i, (name, part) in enumerate(zip(plan.names, parts)):
        tree = gather(plan.units[i], mesh, part)
        if specs is not None and mesh.row == 0:
            tree = gather_model(tree, specs[i], mesh)
        if keep:
            units.append((name, tree_map(_host, tree)))
        del tree
    return join_units(units) if keep else None


def model_to_host(tree: Any, specs: list, mesh, keep: bool) -> Any:
    """The whole leaves of a column-sliced tree as read-only host numpy
    arrays where ``keep``, else None: one leaf at a time is gathered over
    this row's columns (collective over the row) and copied."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for x, s in zip(leaves, specs):
        whole = x if model_dim(s) is None else mesh.model_all_gather(x, model_dim(s))
        out.append(_host(whole) if keep else None)
        del whole
    return tree_unflatten(treedef, out) if keep else None


def host_unit(host: dict, name: str, device, model_size: int = 1, col: int = 0, *,
              replicate_ssm: bool = False) -> Any:
    """Unit ``name`` of a whole host tree (numpy leaves, memory maps
    included, in the port's structure) as tensors on ``device``, column
    ``col``'s slices of it on a model axis of ``model_size`` (with
    ``replicate_ssm``, as `spec_for_leaf`): one unit's copy is made, not
    the tree's."""
    tree = dict(units_of(host))[name]
    if model_size > 1:
        specs = unit_specs(name, tree, model_size, replicate_ssm=replicate_ssm)
        tree = shard_model(tree, specs, model_size, col)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


__all__ = ["EMBED", "LAYER_LISTS", "MODEL", "MOMENTS", "REST", "FsdpPlan", "FsdpStats",
           "FsdpWorld", "LazyUnit", "Zero1Plan", "flat_padded", "fsdp_plan", "gather",
           "gather_model", "gather_opt_state", "gather_to_host", "host_unit", "join_units",
           "model_dim", "model_shard", "model_to_host", "param_specs", "shard_model", "shard_of",
           "shard_opt_state", "spec_for_leaf", "spec_list", "square_sums", "unit_specs",
           "units_of", "zero1_plan"]
