"""Elastic re-scaling: move state between meshes and row partitions (a
port of the reference's `launch/elastic.py`).

Two paths:

  * the CHECKPOINT path. Checkpoints hold whole leaves (`io.checkpoint`),
    so the same files resume on any row count and in any step mode:
    `restore_for_mesh` loads them onto the target mesh's device, and the
    step's rows take their shards from there (`row_shard`,
    `train.sharding`); on a model axis each rank takes its column's
    slices by the new world's `param_specs`, and under FSDP each row its
    own parts of them, a unit at a time. `healthy_mesh` picks the largest
    mesh the healthy devices allow, halving the data axis as the
    reference does and never the model axis; `healthy_mesh_with_backoff`
    probes a few times before it shrinks.
  * the IN-MEMORY path (`reshard_state`): live row-partitioned state moves
    between two row partitions of the same world with no checkpoint round
    trip, the regroup leg of the adaptive loop (`core.adapt`).
    `repack_block_pool` is its paged-KV counterpart: it compacts a block
    pool onto the slots that survive a serving regroup or fault
    (`serve.fleet.reshard_paged_serving_state`).
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.io import checkpoint as ckpt
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.train.sharding import MOMENTS, FsdpPlan, host_unit, shard_model, spec_list
from repro_torch.utils.treeutil import tree_flatten, tree_map, tree_unflatten


def restore_for_mesh(ckpt_dir: str, step: int, like_state: dict, mesh: Mesh,
                     fsdp: FsdpPlan | None = None, *, replicate_ssm: bool = False) -> dict:
    """Load ``step`` in the structure of ``like_state`` (``{"params",
    "opt", "step"}``, whole trees) onto ``mesh``'s device. On a model axis,
    this rank's column slices of the parameters and moments (the mesh's
    `param_specs`, with ``replicate_ssm`` as the model's, whatever world
    wrote the files). ``fsdp``: this row's
    parts of them instead (`FsdpPlan` of the mesh's row count, which need
    not be the writer's). Either way the files are memory-mapped and each
    leaf's (under FSDP, each unit's) slice goes to the device on its own,
    so no rank holds the whole tree, on the device or the host."""
    size, col = mesh.shape["model"], mesh.col
    if fsdp is None and size == 1:
        restored = ckpt.restore(ckpt_dir, step, like_state, device=mesh.device)
    else:
        host = ckpt.restore(ckpt_dir, step, like_state, mmap=True)

        def local(tree):
            if fsdp is not None:
                return fsdp.shard_units(lambda name: host_unit(
                    tree, name, mesh.device, size, col, replicate_ssm=replicate_ssm))
            specs = spec_list(tree, size, replicate_ssm=replicate_ssm)
            column = shard_model(tree, specs, size, col)
            return tree_map(lambda a: torch.from_numpy(np.array(a)).to(mesh.device), column)

        restored = {"params": local(host["params"]),
                    "opt": {k: local(v) if k in MOMENTS else v for k, v in host["opt"].items()},
                    "step": host["step"]}
    restored["step"] = int(restored["step"])
    return restored


def _device_count() -> int:
    return torch.cuda.device_count()


def healthy_mesh(preferred_shape: tuple[int, ...], axis_names: tuple[str, ...] = ("data",),
                 n_devices: int | None = None, *, device=None) -> Mesh:
    """A planning mesh of the most rows the healthy devices allow: the
    ``data`` axis (axis 0) of ``preferred_shape`` halves until the shape
    fits ``n_devices`` (by default the cards present); the model axis (the
    product of the other axes) never shrinks, as in the reference (model
    parallelism is bound to the topology)."""
    n = _device_count() if n_devices is None else int(n_devices)
    shape = list(preferred_shape)
    total = math.prod(shape)
    while total > n and shape[0] > 1:
        shape[0] //= 2
        total //= 2
    if total > n:
        raise RuntimeError(f"not enough devices: need {total}, have {n}")
    mesh = make_host_mesh(shape[0], math.prod(shape[1:]), device=device)
    mesh.axis = axis_names[0]
    return mesh


def healthy_mesh_with_backoff(preferred_shape: tuple[int, ...],
                              axis_names: tuple[str, ...] = ("data",), *,
                              prober: Callable[[], int] | None = None, attempts: int = 4,
                              base_delay: float = 0.05,
                              sleep: Callable[[float], None] = time.sleep,
                              on_retry: Callable[[int, float], None] | None = None,
                              device=None) -> Mesh:
    """`healthy_mesh` behind a bounded exponential backoff: ask
    ``prober`` (healthy device count; by default the cards present) up to
    ``attempts`` times, doubling the delay from ``base_delay``, and shrink
    only if the count still falls short after the last probe (a slow node
    looks like a lost one to a single probe)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    probe = _device_count if prober is None else prober
    need = math.prod(preferred_shape)
    n = probe()
    for attempt in range(1, attempts):
        if n >= need:
            break
        delay = base_delay * (2 ** (attempt - 1))
        if on_retry is not None:
            on_retry(attempt, delay)
        sleep(delay)
        n = probe()
    return healthy_mesh(preferred_shape, axis_names, n_devices=n, device=device)


def reshard_state(state: Any, old_gmesh, new_gmesh,
                  repartition: Callable[[Any, Any, Any], Any] | None = None) -> Any:
    """This rank's part of an in-memory migration of row-partitioned state
    between two row partitions of the same world (no checkpoint round
    trip). Collective: every rank of the world calls it alike.

    A *row leaf* is a leaf that holds this rank's own row of a
    row-partitioned buffer: the reference's leaf whose leading dimension
    is the axis size, without that dimension (each rank holds one row of
    the same shape and dtype). Every tensor leaf is a row leaf; any other
    leaf (a Python value) passes through untouched.

    Each row leaf is gathered from every row to the host (one
    `Mesh.all_gather` a leaf), and the OLD compute rows' slices, stacked
    ``(old_rows, ...)`` numpy arrays in the tree, are handed to
    ``repartition(compute_rows_tree, old_gmesh, new_gmesh)`` (a whole-tree
    hook, so cross-leaf repartitioning, such as re-binning particles by
    position, sees every leaf at once). It must return the tree with
    ``(new_rows, ...)`` leaves in their place. Every rank computes the same
    tree and keeps its new row, on the old leaf's device and in its dtype;
    service rows get zeros.

    The default repartition flattens each leaf's (rows, per_row, ...)
    items and deals them evenly over the new compute rows (zero-padding
    the ragged tail), the natural move for masked item buffers (documents,
    stream chunks). A 0-d row leaf (the reference's rank-1 leaf) has no
    item axis to re-deal, so it needs an explicit ``repartition``.

    The reference also takes meshes of different axis sizes (the fleet's
    shrink onto a `healthy_mesh`). One gloo world has one size, so that
    raises here; the serving reshards (`serve.fleet.reshard_serving_state`,
    `reshard_paged_serving_state`) move the global slot layout between
    planning meshes of any sizes on the host instead."""
    n_old = old_gmesh.axis_size
    n_new = new_gmesh.axis_size
    if n_old != n_new:
        raise ValueError(
            f"reshard_state between axis sizes {n_old} and {n_new}: one gloo world has one "
            f"size; a shrink onto fewer rows moves the global serving layout "
            f"(serve.fleet.reshard_serving_state) instead")
    mesh = new_gmesh.mesh
    if mesh.shape["model"] > 1:
        raise ValueError(f"reshard_state on a model axis of {mesh.shape['model']} is not "
                         f"ported (ROADMAP A8: the adaptive regroup on a (data, model) world)")
    old_rows = old_gmesh.compute.size
    new_rows = new_gmesh.compute.size

    leaves, treedef = tree_flatten(state)
    row_mask = [isinstance(leaf, torch.Tensor) for leaf in leaves]
    host = []
    for leaf, row in zip(leaves, row_mask):
        if not row:
            host.append(leaf)
            continue
        whole = mesh.all_gather(leaf.detach()[None]) if mesh.in_world else leaf.detach()[None]
        if whole.shape[0] != n_old:
            raise ValueError(f"a row leaf gathered {whole.shape[0]} rows, the axis has {n_old}")
        whole = whole.cpu()
        if whole.dtype == torch.bfloat16:  # numpy has no bf16; f32 holds it exactly
            whole = whole.float()
        host.append(whole.numpy()[:old_rows])

    if repartition is not None:
        new_tree = repartition(tree_unflatten(treedef, host), old_gmesh, new_gmesh)
        new_leaves = tree_flatten(new_tree)[0]
        if len(new_leaves) != len(leaves):
            raise ValueError("repartition must preserve the state's tree structure")
    else:

        def redeal(x):
            if x.ndim < 2:
                raise ValueError("rank-1 row leaves have no item axis to re-deal; "
                                 "pass an explicit `repartition`")
            items = x.reshape((-1,) + x.shape[2:])
            per = -(-items.shape[0] // new_rows)
            pad = per * new_rows - items.shape[0]
            if pad:
                items = np.concatenate([items, np.zeros((pad,) + items.shape[1:], x.dtype)])
            return items.reshape((new_rows, per) + items.shape[1:])

        new_leaves = [redeal(leaf) if row else leaf for leaf, row in zip(host, row_mask)]

    def place(rows, like: torch.Tensor) -> torch.Tensor:
        rows = np.asarray(rows)
        if rows.shape[0] != new_rows:
            raise ValueError(f"repartition returned {rows.shape[0]} rows, expected {new_rows}")
        if mesh.row < new_rows:
            mine = torch.from_numpy(np.ascontiguousarray(rows[mesh.row]))
        else:
            mine = torch.zeros(rows.shape[1:], dtype=like.dtype)
        return mine.to(device=like.device, dtype=like.dtype)

    out = [place(leaf, orig) if row else orig
           for leaf, row, orig in zip(new_leaves, row_mask, leaves)]
    return tree_unflatten(treedef, out)


def repack_block_pool(k_pool, v_pool, tables, lens, *, keep, n_blocks=None):
    """Compact a paged KV pool (`serve/kvstore.py`) onto a surviving slot
    set: the paged counterpart of a dense slot migration.

    ``keep`` lists the old slot indices that survive, in new-slot order.
    Every block a kept table references is gathered once and renumbered
    densely from 1 (block 0 stays the zero block), so blocks shared across
    slots (prefix-cache blocks in several tables) stay shared, and the new
    pool is exactly the live demand (``n_blocks`` leaves headroom).
    Returns ``(k_pool, v_pool, tables, lens)``: pools on the old pool's
    device, tables and lens on the host, ready to seed a re-sized store."""
    tables = np.asarray(tables)
    lens = np.asarray(lens)
    mapping: dict[int, int] = {}
    new_tables = np.full((len(keep), tables.shape[1]), -1, np.int32)
    for r, src in enumerate(keep):
        for c, b in enumerate(tables[src]):
            b = int(b)
            if b <= 0:
                continue
            if b not in mapping:
                mapping[b] = len(mapping) + 1
            new_tables[r, c] = mapping[b]
    need = len(mapping) + 1
    if n_blocks is None:
        n_blocks = need
    if n_blocks < need:
        raise ValueError(f"n_blocks={n_blocks} < {need} live blocks")
    order = sorted(mapping, key=mapping.get)
    ln, _, bs, dk = k_pool.shape
    new_k = k_pool.new_zeros((ln, n_blocks, bs, dk))
    new_v = v_pool.new_zeros((ln, n_blocks, bs, v_pool.shape[-1]))
    if order:
        idx = torch.as_tensor(order, dtype=torch.long, device=k_pool.device)
        new_k[:, 1:1 + len(order)] = k_pool.index_select(1, idx)
        new_v[:, 1:1 + len(order)] = v_pool.index_select(1, idx)
    return new_k, new_v, new_tables, lens[list(keep)].copy()


__all__ = ["healthy_mesh", "healthy_mesh_with_backoff", "repack_block_pool", "reshard_state",
           "restore_for_mesh"]
