"""Particle-in-cell mini-app: the paper's Sec. IV-D case study (iPIC3D), a
port of the reference's `apps/pic.py` without its adaptive part.

1-D domain decomposition over the ``data`` axis. Particles (position,
velocity) live in fixed-capacity per-row buffers with validity masks. A
push moves particles; movers that leave the local domain must reach their
new owner row.

Particle communication variants (the paper's Fig. 7):
  reference   multi-hop neighbour forwarding: exiting particles hop one
              row per round (to the row above or below) until they
              arrive, the paper's Dim_x-step scheme, at most rows - 1
              rounds per step.
  decoupled   exiting particles stream to the comm service row, which
              buckets them by destination and delivers each bucket in ONE
              hop (the paper's <= 2-step guarantee).

With ``io_alpha > 0`` the app declares BOTH services on one `ServiceGraph`
(compute -> comm for exiting particles, compute -> io for the particle
trace): the paper's multi-group layout with two concurrent decoupled
operations (Fig. 8's io group buffering the trace). Within a step every
rank makes the comm transfers, then the io channel's waves, in one order.
The GEM-challenge particle skew (a current-sheet concentration) is
`imbalance.skewed_partition`.

Messages keep the reference's shapes: full-capacity masked buffers, one
packed message per peer ((x, v, mask) forwarded; (x, v, mask, dst) to the
comm row). Slot order follows the reference's stable sorts
(``stable=True``), and `_merge_in` places arrivals as the reference's
(capacity x capacity) match matrix does, by a stable sort and a
cumulative-sum scatter in O(capacity log capacity).

Everything but the host entry point `pic_world` is this rank's part of the
computation (`launch.mesh`). `_owner` divides by the row width; the
reference's compiler may multiply by its reciprocal instead (ROADMAP C).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.dataflow import ServiceGraph
from repro_torch.core.groups import COMPUTE, GroupedMesh
from repro_torch.core.imbalance import sheet_partition, skewed_partition
from repro_torch.core.operators import buffer_op
from repro_torch.core.stream import StreamChunker
from repro_torch.io.iogroup import io_ring_init

MODES = ("reference", "decoupled")
# (run name, mode, io_alpha) of `pic_world`: both comm schemes, and the
# decoupled one beside the io service
RUNS = (("reference", "reference", 0.0), ("decoupled", "decoupled", 0.0),
        ("decoupled_io", "decoupled", 0.125))


@dataclasses.dataclass(frozen=True)
class PICCfg:
    capacity: int = 4096  # particle slots per row
    n_particles_total: int = 8192
    domain: float = 1.0  # global [0, 1); row r owns [r, r+1)/R of it
    dt: float = 0.08
    skew: float = 0.8
    seed: int = 3
    n_steps: int = 4
    # the current sheet's width for `init_particles(center=...)`
    sheet_width: float = 0.08


def init_particles(cfg: PICCfg, work_rows: int, center: float | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Skewed initial distribution over the compute rows (the GEM current
    sheet) as ``(work_rows, capacity)`` f32 numpy arrays (x, v, valid), the
    reference's draws from the same generator. With ``center`` the
    concentration is the deterministic sheet profile around that
    fractional position; by default the shuffled Zipf placement."""
    rng = np.random.default_rng(cfg.seed)
    if center is None:
        counts = skewed_partition(cfg.n_particles_total, work_rows, cfg.skew, rng)
    else:
        counts = sheet_partition(cfg.n_particles_total, work_rows, min(cfg.skew, 1.0), center,
                                 width=cfg.sheet_width)
    counts = np.minimum(counts, cfg.capacity)
    xs = np.zeros((work_rows, cfg.capacity), np.float32)
    vs = np.zeros((work_rows, cfg.capacity), np.float32)
    valid = np.zeros((work_rows, cfg.capacity), np.float32)
    width = cfg.domain / work_rows
    for r in range(work_rows):
        n = counts[r]
        xs[r, :n] = rng.uniform(r * width, (r + 1) * width, n)
        vs[r, :n] = rng.normal(0.0, 1.0, n)
        valid[r, :n] = 1.0
    return xs, vs, valid


def _push(x, v, valid, dt: float, domain: float):
    """Move particles (the field-free push); reflecting walls at the global
    domain's ends."""
    x = x + v * dt * valid
    v = torch.where((x < 0) | (x > domain), -v, v)
    x = torch.clamp(x, 0.0, domain - 1e-6)
    return x, v


def _owner(x: torch.Tensor, width: float) -> torch.Tensor:
    """The row owning each position: floor(x / width), a true division."""
    return torch.floor(x / width).to(torch.int32)


def _compact(x, v, valid):
    """Valid particles to the front of the buffer, in their order (a
    stable sort, as the reference's)."""
    order = torch.argsort(-valid, stable=True)
    return x[order], v[order], valid[order]


def _merge_in(x, v, valid, xin, vin, vin_mask):
    """Append arriving particles into free slots: the buffer compacted,
    arrivals in their own stable order into the next free slots, stale
    coordinates in free slots zeroed. Arrivals past the capacity are
    dropped, as in the reference (only slots below it take one)."""
    x, v, valid = _compact(x, v, valid)
    cap = x.shape[0]
    n_have = valid.sum().to(torch.int64)
    order = torch.argsort(-vin_mask, stable=True)
    xin, vin, arriving = xin[order], vin[order], vin_mask[order] > 0
    slot = n_have + torch.cumsum(arriving.to(torch.int64), 0) - 1
    # arrivals that do not fit, and the non-arrivals, land in a spare slot
    slot = torch.where(arriving & (slot < cap), slot, cap)
    keep = valid > 0
    x = torch.cat([torch.where(keep, x, 0.0), x.new_zeros(1)]).scatter_(0, slot, xin)
    v = torch.cat([torch.where(keep, v, 0.0), v.new_zeros(1)]).scatter_(0, slot, vin)
    valid = torch.cat([valid, valid.new_zeros(1)]).scatter_(0, slot, torch.ones_like(vin_mask))
    return x[:cap], v[:cap], valid[:cap]


# -- reference: multi-hop neighbour forwarding -------------------------------------

def comm_reference(x, v, valid, gmesh: GroupedMesh, width: float, n_rows_active: int):
    """Forward exiting particles one hop at a time, ``n_rows_active - 1``
    rounds (the paper's Dim_x forwarding steps). Each round every compute
    row sends its up-bound set to the row above and its down-bound set to
    the row below, as one packed ``(3, cap)`` message each, then merges
    what came from below, then what came from above."""
    mesh = gmesh.mesh
    comp = list(gmesh.rows_of(COMPUTE))
    row = mesh.row
    i = comp.index(row) if row in comp else None
    above = comp[i + 1] if i is not None and i + 1 < len(comp) else None
    below = comp[i - 1] if i is not None and i > 0 else None
    shape = (3,) + tuple(x.shape)
    for _ in range(n_rows_active - 1):
        owner = _owner(x, width)
        live = valid > 0
        go_up = (owner > row) & live
        go_dn = (owner < row) & live
        # snapshot both departing sets before any buffer mutation
        recvs = [mesh.irecv(shape, x.dtype, peer) if peer is not None else None
                 for peer in (below, above)]
        sends = [mesh.isend(torch.stack([torch.where(m, x, 0.0), torch.where(m, v, 0.0),
                                         torch.where(m, valid, 0.0)]), peer)
                 for m, peer in ((go_up, above), (go_dn, below)) if peer is not None]
        valid = valid * ~(go_up | go_dn)  # departures
        for p in sends:
            p.wait()
        for p in recvs:
            arrived = p.wait() if p is not None else x.new_zeros(shape)
            x, v, valid = _merge_in(x, v, valid, arrived[0], arrived[1], arrived[2])
    return x, v, valid


# -- decoupled: stream to the comm group, bucket, deliver in one hop -------------------

def _buckets(table: torch.Tensor, compute_rows: Sequence[int], cap: int) -> torch.Tensor:
    """The comm row's bucketing: ``table`` holds every compute row's
    ``(x, v, m, dst)`` as ``(4, n, cap)``. For each destination row, its
    particles in (source row, slot) order, then zeros, cut to ``cap``:
    ``(n_dst, 3, cap)``. One stable sort by destination stands for the
    reference's stable sort per destination."""
    x, v, m, dst = (t.reshape(-1) for t in table)
    n_dst = len(compute_rows)
    first = compute_rows[0]
    live = m > 0
    key = torch.where(live, dst.to(torch.int64) - first, n_dst)
    order = torch.argsort(key, stable=True)
    count = torch.bincount(key, minlength=n_dst + 1)[:n_dst]
    start = torch.cumsum(count, 0) - count
    pos = torch.arange(cap, device=table.device)
    idx = order[(start[:, None] + pos[None, :]).clamp_(max=order.numel() - 1)]
    take = pos[None, :] < count[:, None]
    return torch.stack([torch.where(take, t[idx], 0.0) for t in (x, v, m)], dim=1)


def comm_decoupled(x, v, valid, graph: ServiceGraph, width: float):
    """Exiting particles stream to the comm row, one ``(4, cap)`` message
    (x, v, mask, destination) per compute row; the comm row buckets them
    by destination and sends each compute row its ``(3, cap)`` bucket,
    which only that row merges (<= 2 hops per particle)."""
    gmesh = graph.gmesh
    mesh = gmesh.mesh
    comm_row = gmesh.group("comm").start
    compute_rows = list(gmesh.rows_of(COMPUTE))
    row = mesh.row
    cap = x.shape[0]
    if row in compute_rows:
        owner = _owner(x, width)
        leaving = (owner != row) & (valid > 0)
        payload = torch.stack([torch.where(leaving, x, 0.0), torch.where(leaving, v, 0.0),
                               torch.where(leaving, valid, 0.0),
                               torch.where(leaving, owner, -1).to(torch.float32)])
        valid = valid * ~leaving
        recv = mesh.irecv((3, cap), x.dtype, comm_row)
        mesh.isend(payload, comm_row).wait()
        bucket = recv.wait()
        return _merge_in(x, v, valid, bucket[0], bucket[1], bucket[2])
    if row == comm_row:
        pending = [mesh.irecv((4, cap), x.dtype, src) for src in compute_rows]
        table = torch.stack([p.wait() for p in pending], dim=1)
        buckets = _buckets(table, compute_rows, cap)
        for p in [mesh.isend(buckets[i], dst) for i, dst in enumerate(compute_rows)]:
            p.wait()
    return x, v, valid


# -- the concurrent particle-trace I/O service ------------------------------------------

def io_trace_stream(x, v, valid, graph: ServiceGraph, io_state, chunker: StreamChunker, op):
    """Stream this step's particle trace (x, v, validity) from the compute
    rows to the io group's ring buffer, the second concurrent service; the
    host drain (`io.iogroup`) stays off the compute rows."""
    elements = chunker.pack({"x": x, "v": v, "m": valid})
    return graph.channel(COMPUTE, "io").stream_fold(elements, op.apply, io_state)


def pic_graph(mesh, mode: str, alpha: float, io_alpha: float) -> ServiceGraph | None:
    """The service topology of one mode (None for the reference)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if mode != "decoupled":
        return None
    stages, edges = {"comm": alpha}, [(COMPUTE, "comm")]
    if io_alpha > 0:
        stages["io"] = io_alpha
        edges.append((COMPUTE, "io"))
    return ServiceGraph.build(mesh, stages=stages, edges=edges)


# -- entry points ----------------------------------------------------------------------

def run_pic(mesh, mode: str, cfg: PICCfg, alpha: float = 0.125, io_alpha: float = 0.0,
            io_capacity_chunks: int = 256, *, stats: dict | None = None) -> tuple:
    """This rank's part of the mini-app: mode "decoupled" forms the comm
    service group, and ``io_alpha > 0`` also runs the particle-io service on
    the same graph. Returns this row's (x, v, valid, per-step valid counts
    ``(n_steps,)``[, io chunks buffered: nonzero on the io row]), the
    reference's per-row outputs.

    ``stats``: a dict that collects synchronised seconds per phase
    (push_s, comm_s, io_s) and this row's movers per step (``movers``:
    valid particles whose owner is another row after the push)."""
    graph = pic_graph(mesh, mode, alpha, io_alpha)
    gmesh = graph.gmesh if graph is not None else GroupedMesh.trivial(mesh)
    with_io = graph is not None and gmesh.has("io")
    work_rows = gmesh.compute.size
    xs, vs, valid = init_particles(cfg, work_rows)
    dev = mesh.device
    if mesh.row < work_rows:
        x, v, m = (torch.from_numpy(a[mesh.row]).to(dev) for a in (xs, vs, valid))
    else:
        x, v, m = (torch.zeros(cfg.capacity, dtype=torch.float32, device=dev) for _ in range(3))
    width = cfg.domain / work_rows
    io_state = None
    if with_io:
        chunker = StreamChunker.plan({"x": x, "v": v, "m": m}, chunk_elems=cfg.capacity)
        io_op = buffer_op(io_capacity_chunks, chunker.chunk_elems, device=dev)
        io_state = io_ring_init(io_op, gmesh)
    counts, movers = [], []
    for _ in range(cfg.n_steps):
        with mesh.phase(stats, "push_s"):
            x, v = _push(x, v, m, cfg.dt, cfg.domain)
        if stats is not None:
            moving = (_owner(x, width) != mesh.row) & (m > 0) & (mesh.row < work_rows)
            movers.append(moving.sum())
        with mesh.phase(stats, "comm_s"):
            if graph is not None:
                x, v, m = comm_decoupled(x, v, m, graph, width)
            else:
                x, v, m = comm_reference(x, v, m, gmesh, width, work_rows)
        if with_io:
            with mesh.phase(stats, "io_s"):
                io_state = io_trace_stream(x, v, m, graph, io_state, chunker, io_op)
        counts.append(m.sum())
    if stats is not None:
        stats["movers"] = [int(n) for n in movers]
    out = (x, v, m, torch.stack(counts))
    if with_io:
        return out + (io_state[1],)
    return out


def _pic_rank(mesh, cfg: PICCfg, runs: Sequence[tuple]) -> dict:
    out = {}
    for name, mode, io_alpha in runs:
        res = run_pic(mesh, mode, cfg, io_alpha=io_alpha)
        out[name] = tuple(t.cpu().numpy() for t in res)
    return out


def pic_world(cfg: PICCfg, runs: Sequence[tuple] = RUNS, *, n_rows: int = 8,
              device=None) -> dict:
    """Host entry point: start an ``n_rows``-rank world (`launch.mesh.spawn`,
    on the card unless ``device`` names another), run each ``(name, mode,
    io_alpha)`` of ``runs`` in it at `run_pic`'s defaults, and return per
    name what the reference's `run_pic` returns, stacked over rows: (x, v,
    valid, per-step counts[, io chunks per row])."""
    from repro_torch.launch.mesh import spawn

    ranks = spawn(_pic_rank, n_rows, device=device, args=(cfg, tuple(runs)), timeout_s=600.0)
    return {name: tuple(np.stack([r[name][i] for r in ranks]) for i in range(len(ranks[0][name])))
            for name, _, _ in runs}


def histogram_positions(x, m, bins: int, domain: float) -> np.ndarray:
    """Distribution check: both comm schemes must transport particles to the
    same places."""
    h, _ = np.histogram(np.asarray(x).reshape(-1), bins=bins, range=(0, domain),
                        weights=np.asarray(m).reshape(-1))
    return h


__all__ = ["MODES", "PICCfg", "RUNS", "comm_decoupled", "comm_reference", "histogram_positions",
           "init_particles", "io_trace_stream", "pic_graph", "pic_world", "run_pic"]
