"""Decoupled collectives: group-restricted reductions and the
stream-reduce primitive of the decoupled train step (a port of the
reference's `core/decouple.py`).

* `group_psum` / `group_pmax` / `group_psum_scatter` /
  `group_all_gather`: collectives over one group's rows (the paper's
  reduced-complexity collective on a subset of processes, criterion 2 of
  Sec. II-E); the identity on rows outside the group and for a group of
  one row, as the reference's singleton groups are.
* `stream_reduce`: compute rows stream raw chunks to the reducer group,
  which folds partial sums as they arrive and then completes the small
  intra-group aggregation (the paper's reduce group + master, Sec. IV-B).
* `role_index` / `select_by_role`: MPMD divergence. The reference runs
  every branch under ``lax.switch`` on every row; a rank here runs only
  its own group's branch, and checks with the other ranks that every
  branch taken returned the same structure, shapes and dtypes (the
  reference's contract).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.channel import StreamChannel
from repro_torch.core.groups import GroupedMesh
from repro_torch.utils.treeutil import tree_flatten, tree_map


def _group_reduce(x: Any, gmesh: GroupedMesh, group: str, op) -> Any:
    pg = gmesh.pgroups.get(group)
    if pg is None or not gmesh.is_member(group):
        return x
    return tree_map(lambda leaf: gmesh.mesh.all_reduce(leaf, group=pg, op=op), x)


def group_psum(x: Any, gmesh: GroupedMesh, group: str) -> Any:
    """Sum over the rows of ``group``; rows outside it keep ``x``."""
    return _group_reduce(x, gmesh, group, dist.ReduceOp.SUM)


def group_pmax(x: Any, gmesh: GroupedMesh, group: str) -> Any:
    """Max over the rows of ``group``; rows outside it keep ``x``."""
    return _group_reduce(x, gmesh, group, dist.ReduceOp.MAX)


def group_psum_scatter(x: torch.Tensor, gmesh: GroupedMesh, group: str) -> torch.Tensor:
    """Reduce-scatter over ``group``'s rows along dim 0, tiled: the group's
    i-th row gets the i-th of ``group size`` equal slices of the group's
    sum (``x.shape[0]`` must divide). Rows outside the group keep ``x``."""
    pg = gmesh.pgroups.get(group)
    if pg is None or not gmesh.is_member(group):
        return x
    g = gmesh.group(group)
    if x.shape[0] % g.size:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over {g.size} rows")
    n = x.shape[0] // g.size
    i = gmesh.mesh.row - g.start
    return gmesh.mesh.all_reduce(x, group=pg)[i * n:(i + 1) * n]


def group_all_gather(x: torch.Tensor, gmesh: GroupedMesh, group: str) -> torch.Tensor:
    """The rows of ``group`` concatenate their ``x`` along dim 0 in row
    order (tiled all-gather); rows outside the group keep ``x``."""
    pg = gmesh.pgroups.get(group)
    if pg is None or not gmesh.is_member(group):
        return x
    return gmesh.mesh.all_gather(x, group=pg)


def role_index(gmesh: GroupedMesh) -> int:
    """This row's role: the position of its group in ``gmesh.groups``."""
    for i, g in enumerate(gmesh.groups):
        if gmesh.is_member(g.name):
            return i
    raise ValueError(f"row {gmesh.mesh.row} is in no group of {gmesh.describe()}")


def _structure(tree: Any) -> tuple:
    leaves, treedef = tree_flatten(tree)
    return treedef, tuple((tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor)
                          else type(x).__name__ for x in leaves)


def select_by_role(gmesh: GroupedMesh, branches: dict[str, Callable[[], Any]]) -> Any:
    """Run this row's group's branch (groups not listed run the first
    listed branch) and return its result. Every rank must call it: inside
    a world the ranks compare the structure, shapes and dtypes of what
    their branches returned, and raise if they differ."""
    default = next(iter(branches.values()))
    out = branches.get(gmesh.groups[role_index(gmesh)].name, default)()
    if gmesh.mesh.in_world:
        seen = [None] * gmesh.axis_size
        dist.all_gather_object(seen, _structure(out))
        if any(s != seen[0] for s in seen):
            raise ValueError(f"select_by_role: the branches return different structures: "
                             f"{sorted(set(map(repr, seen)))}")
    return out


def stream_reduce(elements: torch.Tensor, channel: StreamChannel, *,
                  aggregate: bool = True) -> torch.Tensor:
    """Stream (n_chunks, S) producer buffers to the consumer group and
    return the per-chunk sums over all producers (on consumer rows).

    Stage 1: consumer row j folds the chunks arriving from producers
    {wave * R + j}. Stage 2: a sum within the consumer group completes
    the reduction, at O(R) << O(P)."""

    def add_chunk(acc, elem, k):
        acc[k] += elem
        return acc

    partial = channel.stream_fold(elements, add_chunk, torch.zeros_like(elements))
    if aggregate and channel.n_consumers > 1:
        partial = group_psum(partial, channel.gmesh, channel.consumer)
    return partial


def stream_reduce_and_return(elements: torch.Tensor, channel: StreamChannel,
                             transform: Callable[[torch.Tensor], torch.Tensor] | None = None
                             ) -> torch.Tensor:
    """Stream-reduce on the service group, optionally transform the sum
    there, and broadcast the result back to every row."""
    reduced = stream_reduce(elements, channel)
    if transform is not None:
        reduced = transform(reduced)
    return channel.broadcast_from_consumer(reduced)


def conventional_allreduce(x: Any, gmesh: GroupedMesh) -> Any:
    """A sum over every row: the model in which every process performs
    every operation (the paper's Fig. 3a)."""
    return tree_map(lambda leaf: gmesh.mesh.all_reduce(leaf), x)


__all__ = ["conventional_allreduce", "group_all_gather", "group_pmax", "group_psum",
           "group_psum_scatter", "role_index", "select_by_role", "stream_reduce",
           "stream_reduce_and_return"]
