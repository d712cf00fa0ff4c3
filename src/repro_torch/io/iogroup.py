"""Decoupled I/O group: the paper's particle-I/O pattern (Sec. IV-D2) as a
`ServiceGraph` sink stage (a port of the reference's `io/iogroup.py`).

Compute rows stream state chunks to the io service rows; the io rows
accumulate them in a device-side ring buffer (`buffer_op`, the paper's
"substantial memory for buffering") and drain it to host storage off the
compute rows' critical path: only the io rows copy to the host and touch
the disk.

Callers declare the io group as one stage of a `ServiceGraph` (``edges=[...,
(src, "io")]``) and either chain it behind other services (`io_sink_stage`,
a tail stage for `ServiceGraph.run_chain` that ring-buffers each upstream
emission) or stream to it directly (`stream_to_io_group`). A bare
`GroupedMesh` is accepted too and wrapped in a single-edge graph.

Everything here is this rank's part of the computation (`launch.mesh`).
The reference drains with an ordered ``io_callback`` that every row
executes, with a zero count off the io rows; here an io rank synchronises
its device, copies ``(buffer, count)`` to the host and calls its sink, and
every other rank returns 0 without touching the disk.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.dataflow import ServiceGraph, Stage
from repro_torch.core.groups import COMPUTE, GroupedMesh
from repro_torch.core.operators import StreamOperator, buffer_op
from repro_torch.core.stream import StreamChunker

IO = "io"


class HostSink:
    """Host-side append-only store: one ``.npy`` file per drain that holds
    at least one chunk.

    File names: ``drain_{n:06d}.npy`` for the n-th drain, the reference's
    names, when one io row drains into the directory. Each io rank holds
    its own sink (the reference's one instance is shared by every row of
    its process), so with several io rows `drain_to_sink` passes the
    row, and the file is ``drain_row{row:03d}_{n:06d}.npy``: no rank can
    overwrite another's file."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.n_drains = 0

    def drain(self, buf: np.ndarray, count, row: int | None = None) -> int:
        """Write the first ``min(count, len(buf))`` chunks; returns 0 (the
        reference's callback result)."""
        n = int(count)
        if n > 0:
            tag = "" if row is None else f"row{row:03d}_"
            path = os.path.join(self.directory, f"drain_{tag}{self.n_drains:06d}.npy")
            np.save(path, np.asarray(buf)[: min(n, buf.shape[0])])
            self.n_drains += 1
        return 0


def _as_graph(graph: ServiceGraph | GroupedMesh, src: str) -> ServiceGraph:
    """A ServiceGraph with a declared (src, io) edge, or a bare GroupedMesh
    wrapped into a single-edge graph."""
    if isinstance(graph, GroupedMesh):
        return ServiceGraph.from_grouped(graph, [(src, IO)])
    return graph


def io_sink_stage(src: str, *, granularity_elems: int, capacity_chunks: int = 64,
                  device=None) -> Stage:
    """An io sink `Stage` for `ServiceGraph.run_chain`: upstream stages emit
    ``(granularity_elems,)`` elements, and the io rows append each to the
    ring buffer. The folded state is `buffer_op`'s ``(buffer, count)``:
    pass it to `drain_to_sink` after the step. ``device``: where the ring
    lives (cuda unless named)."""
    op = buffer_op(capacity_chunks, granularity_elems, device=device)
    return Stage(src=src, dst=IO, operator=op.apply, init=op.init())


def io_ring_init(op: StreamOperator, gmesh: GroupedMesh) -> tuple:
    """The start of a `buffer_op` fold: ``op.init()`` on the io rows,
    which fold into it; elsewhere an empty ring and a zero count, which
    the channel hands back untouched (so only io rows hold the ring)."""
    if gmesh.is_member(IO):
        return op.init()
    dev = gmesh.mesh.device
    return torch.zeros((0,), device=dev), torch.zeros((), dtype=torch.int32, device=dev)


def drain_to_sink(graph: ServiceGraph | GroupedMesh, sink: HostSink, buf: torch.Tensor,
                  count) -> int:
    """Drain a `buffer_op` state to ``sink`` on the io rows: synchronise,
    copy the written chunks and the count to the host, write. Other rows
    return 0 and touch neither the host nor the disk."""
    g = _as_graph(graph, COMPUTE)
    gm = g.gmesh
    if not gm.is_member(IO):
        return 0
    gm.mesh.sync()
    n = int(count)
    host = buf[: min(max(n, 0), buf.shape[0])].cpu().numpy()
    return sink.drain(host, n, row=gm.mesh.row if gm.group(IO).size > 1 else None)


def stream_to_io_group(tree, graph: ServiceGraph | GroupedMesh, sink: HostSink, *,
                       src: str = COMPUTE, granularity_elems: int = 8192,
                       capacity_chunks: int = 64) -> torch.Tensor:
    """Stream ``tree`` (a tree of tensors on the mesh's device, of the same
    shapes on every row) from the ``src`` rows to the io rows, buffer it
    there and drain to ``sink``. Returns the number of chunks the io row
    buffered (0 on the other rows). Size the ring to what arrives: past
    ``capacity_chunks`` the ring wraps and overwrites older chunks."""
    g = _as_graph(graph, src)
    channel = g.channel(src, IO)
    chunker = StreamChunker.plan(tree, granularity_elems)
    elements = chunker.pack(tree)
    op = buffer_op(capacity_chunks, chunker.chunk_elems, device=g.gmesh.mesh.device)
    buf, count = channel.stream_fold(elements, op.apply, io_ring_init(op, g.gmesh))
    drain_to_sink(g, sink, buf, count)
    return count


__all__ = ["HostSink", "IO", "drain_to_sink", "io_ring_init", "io_sink_stage",
           "stream_to_io_group"]
