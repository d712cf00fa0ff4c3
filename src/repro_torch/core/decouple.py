"""Decoupled collectives: group-restricted reductions and the
stream-reduce primitive of the decoupled train step (a port of the
reference's `core/decouple.py`).

* `group_psum` / `group_pmax`: a reduction over one group's rows (the
  paper's reduced-complexity collective on a subset of processes,
  criterion 2 of Sec. II-E); the identity on rows outside the group and
  for a group of one row.
* `stream_reduce`: compute rows stream raw chunks to the reducer group,
  which folds partial sums as they arrive and then completes the small
  intra-group aggregation (the paper's reduce group + master, Sec. IV-B).

The reference's `role_index`/`select_by_role` exist for branching under
SPMD; a rank takes its branch with a Python ``if`` on its group.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.channel import StreamChannel
from repro_torch.core.groups import GroupedMesh
from repro_torch.utils.treeutil import tree_map


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


__all__ = ["conventional_allreduce", "group_pmax", "group_psum", "stream_reduce",
           "stream_reduce_and_return"]
