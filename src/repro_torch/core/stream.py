"""Stream elements: the paper's granularity-S dataflow unit (Sec. II-D), a
port of the reference's `core/stream.py`.

A *stream element* is the basic unit injected into a channel "as soon as
data for one element is ready". A `StreamChunker` turns a tree of
tensors into a ``(n_chunks, chunk_elems)`` buffer (and back), so channels
and operators are defined over one element type. The granularity S
trades pipelining (``beta(S)``) against per-element overhead
(``(D/S) * o``) as in Eq. 4.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils import treeutil


@dataclasses.dataclass(frozen=True)
class StreamChunker:
    """Chunking plan for a tree with element granularity S.

    ``chunk_elems`` plays the role of S, in elements of ``dtype`` (bytes =
    chunk_elems * itemsize). The plan reads shapes and dtypes only."""

    spec: treeutil.TreeSpec
    chunk_elems: int
    n_chunks: int
    padded: int
    dtype: torch.dtype

    @staticmethod
    def plan(tree: Any, chunk_elems: int, dtype: torch.dtype = torch.float32) -> "StreamChunker":
        spec = treeutil.spec_of(tree)
        total = max(spec.total, 1)
        chunk_elems = int(min(chunk_elems, total)) if chunk_elems > 0 else total
        n_chunks = treeutil.num_chunks(total, chunk_elems)
        return StreamChunker(spec=spec, chunk_elems=chunk_elems, n_chunks=n_chunks,
                             padded=n_chunks * chunk_elems, dtype=dtype)

    # -- pack / unpack ------------------------------------------------------
    def pack(self, tree: Any) -> torch.Tensor:
        """tree -> (n_chunks, chunk_elems) stream-element buffer."""
        flat = treeutil.flatten(tree, self.dtype)
        flat = treeutil.pad_to_multiple(flat, self.chunk_elems)
        return flat.reshape(self.n_chunks, self.chunk_elems)

    def unpack(self, elements: torch.Tensor) -> Any:
        """(n_chunks, chunk_elems) -> tree (padding dropped)."""
        flat = elements.reshape(-1)[: self.spec.total]
        return treeutil.unflatten(self.spec, flat)

    # -- bookkeeping for the perf model (D, S, D/S) --------------------------
    @property
    def element_bytes(self) -> int:
        return self.chunk_elems * self.dtype.itemsize

    @property
    def total_bytes(self) -> int:
        return self.spec.total * self.dtype.itemsize

    def overhead_calls(self) -> int:
        """Number of element injections = D/S in Eq. 4."""
        return self.n_chunks


def granularity_from_bytes(nbytes: int, dtype: torch.dtype = torch.float32) -> int:
    """A byte granularity in elements of ``dtype``."""
    return max(1, int(nbytes) // dtype.itemsize)


__all__ = ["StreamChunker", "granularity_from_bytes"]
