"""ZeRO-1 over the rank world (the port's counterpart of the reference's
`train/sharding.zero1_specs` in ``overlap`` mode).

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

The reference's other helpers (`param_specs`, `batch_specs`,
`cache_specs`, `named`, `validate_divisibility`) place arrays on a GSPMD
mesh; the rank world has no such placement (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils.treeutil import (
    TreeSpec,
    flatten,
    pad_to_multiple,
    spec_of,
    tree_leaves,
    unflatten,
)

MOMENTS = ("m", "v")


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


__all__ = ["MOMENTS", "Zero1Plan", "flat_padded", "gather", "gather_opt_state",
           "shard_of", "shard_opt_state", "zero1_plan"]
