"""Nested-container <-> flat-buffer utilities used by the stream layer.

The port's parameters, gradients and payloads are nested dicts, lists and
tuples of tensors (the reference's pytrees). `tree_flatten` orders leaves
as `jax.tree.flatten` does: dict entries by sorted key, lists and tuples
in order; so a payload of the same structure packs the same way in both
packages. To stream an arbitrary tree, `flatten` concatenates its leaves
into one 1-D buffer, `pad_to_multiple` pads that to whole stream
elements, and `unflatten` inverts it from a static `TreeSpec`.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

LEAF = None  # the treedef of a leaf


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, treedef): dicts by sorted key, lists/tuples in order."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _walk(t: Any, leaves: list) -> Any:
    # module-level recursion: a recursive closure would form a reference
    # cycle that keeps ``leaves`` (whole gradient trees) alive until the
    # garbage collector runs
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", tuple(keys), tuple(_walk(t[k], leaves) for k in keys))
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, len(t), tuple(_walk(x, leaves) for x in t))
    leaves.append(t)
    return LEAF


def tree_unflatten(treedef: Any, leaves) -> Any:
    return _build(treedef, iter(leaves))


def _build(d: Any, it) -> Any:
    if d is LEAF:
        return next(it)
    kind, keys, kids = d
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    out = [_build(c, it) for c in kids]
    return tuple(out) if kind == "tuple" else out


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of ``rest``, same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, d in others:
        if d != treedef:
            raise ValueError("tree_map: trees differ in structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *(o for o, _ in others))])


def tree_meta(tree: Any) -> Any:
    """The same tree of ``meta`` tensors: shapes and dtypes, no storage."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)


class TreeSpec(NamedTuple):
    """Static description of a flattened tree."""

    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    total: int  # unpadded element count of the flat buffer


def spec_of(tree: Any) -> TreeSpec:
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    return TreeSpec(treedef, shapes, tuple(l.dtype for l in leaves), sizes, int(sum(sizes)))


def flatten(tree: Any, dtype=torch.float32) -> torch.Tensor:
    """Flatten a tree of tensors into one 1-D buffer of ``dtype``."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=dtype)
    return torch.cat([l.reshape(-1).to(dtype) for l in leaves])


def unflatten(spec: TreeSpec, buf: torch.Tensor) -> Any:
    """Inverse of `flatten` given the static `TreeSpec`."""
    leaves, off = [], 0
    for shape, dt, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        leaves.append(buf[off:off + size].reshape(shape).to(dt))
        off += size
    return tree_unflatten(spec.treedef, leaves)


def pad_to_multiple(buf: torch.Tensor, multiple: int) -> torch.Tensor:
    n = buf.shape[0]
    padded = -(-n // multiple) * multiple if multiple > 0 else n
    if padded == n:
        return buf
    return torch.cat([buf, buf.new_zeros((padded - n,))])


def num_chunks(total: int, chunk: int) -> int:
    return max(1, -(-total // chunk))


__all__ = ["TreeSpec", "flatten", "num_chunks", "pad_to_multiple", "spec_of",
           "tree_flatten", "tree_leaves", "tree_map", "tree_meta", "tree_unflatten",
           "unflatten"]
