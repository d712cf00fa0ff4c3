"""The rank world: one process per mesh row, in a `torch.distributed`
world with the gloo backend (the port's counterpart of the reference's
`launch/mesh.py` and of `shard_map` over a mesh axis).

The reference's decoupling layer is per-device SPMD code under
``shard_map``; here each row of the partitioned ``data`` axis is one
process, and the lax collectives it uses map to point-to-point and group
calls of this rank:

  =====================================  ========================================
  lax, inside ``shard_map``              port, in each rank
  =====================================  ========================================
  ``lax.axis_index(axis)``               ``mesh.row``
  ``lax.ppermute(x, axis, perm)``        `Mesh.isend` on the pair's source,
                                         `Mesh.irecv` on its destination
  ``lax.psum(x, axis, groups)``          `Mesh.all_reduce` on a subgroup
                                         (a group of one row is the identity)
  ``lax.all_gather(x, axis, groups)``    `Mesh.all_gather` on a subgroup
  ``lax.psum_scatter(x, axis)`` (the     `Mesh.reduce_scatter` of a flat buffer
  reduce-scatter of GSPMD's ZeRO-1)
  masked-psum broadcast from a row       `Mesh.broadcast` from that row (exact)
  ``lax.cond(is_compute, ...)``          a plain Python ``if``
  =====================================  ========================================

gloo takes CPU tensors only. A CUDA tensor is staged through a pinned
host buffer on the way out (device -> host, then the wire) and back on
the way in (the wire, then host -> device); `WireStats` counts the bytes
and seconds of each direction and the time spent waiting on the wire.
NCCL would take CUDA tensors directly, but refuses two ranks on one GPU,
and the port's chip runs put every row on one card.

`spawn` starts the world with the ``spawn`` start method (CUDA cannot be
initialised again in a forked child), rendezvous through a `FileStore`
in a fresh temporary directory (no fixed TCP port to collide with), and
gives every collective and the result queue a timeout, so a hung rank
fails the call instead of blocking it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass
class WireStats:
    """Bytes and seconds of this rank's traffic, and of the folds of what
    arrives (host clock)."""

    sent_bytes: int = 0
    recv_bytes: int = 0
    d2h_bytes: int = 0
    d2h_s: float = 0.0
    h2d_bytes: int = 0
    h2d_s: float = 0.0
    wait_s: float = 0.0  # blocked in `wait()` of a send or receive
    collective_bytes: int = 0  # the local payloads given to collectives
    collective_s: float = 0.0  # the collectives, staging included
    fold_s: float = 0.0  # the consumer's wave folds (`StreamChannel`), synchronised

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Pending:
    """An in-flight send or receive; `wait` returns the received tensor
    on the mesh's device (None for a send)."""

    def __init__(self, mesh: "Mesh", work, host: torch.Tensor, dtype=None):
        self.mesh, self.work, self.host, self.dtype = mesh, work, host, dtype

    def wait(self) -> torch.Tensor | None:
        t0 = time.perf_counter()
        self.work.wait()
        self.mesh.stats.wait_s += time.perf_counter() - t0
        if self.dtype is None:
            return None
        return self.mesh._from_host(self.host, self.dtype)


@dataclasses.dataclass
class Mesh:
    """This rank's view of a world of ``n_rows`` mesh rows: its ``row``,
    its ``device`` (cuda unless the caller names another;
    `resolve_device`), and the transfers it takes part in. Without an
    initialised world (``n_rows`` rows named for planning only) the
    transfer methods raise."""

    n_rows: int
    row: int = 0
    device: torch.device | str | None = None
    axis: str = "data"
    stats: WireStats = dataclasses.field(default_factory=WireStats)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def shape(self) -> dict[str, int]:
        """The reference mesh's shape: ``data`` rows, one ``model`` column."""
        return {self.axis: self.n_rows, "model": 1}

    @property
    def in_world(self) -> bool:
        return dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == self.n_rows

    def new_group(self, rows) -> object | None:
        """A process group over ``rows`` (collective: every rank calls it,
        in the same order). None outside a world or for one row."""
        rows = list(rows)
        if not self.in_world or len(rows) < 2:
            return None
        return dist.new_group(rows, backend="gloo")

    # -- staging ---------------------------------------------------------------
    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        if not t.is_cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.sync()  # d2h_s times the copy alone, not the work queued before it
        t0 = time.perf_counter()
        host.copy_(t)
        self.stats.d2h_s += time.perf_counter() - t0
        self.stats.d2h_bytes += host.numel() * host.element_size()
        return host

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        wire = torch.uint8 if dtype == torch.bool else dtype
        return torch.empty(shape, dtype=wire, pin_memory=self.device.type == "cuda")

    def _from_host(self, host: torch.Tensor, dtype=None) -> torch.Tensor:
        out = host
        if self.device.type == "cuda":
            self.sync()  # h2d_s times the copy alone, which returns when it is done
            t0 = time.perf_counter()
            out = host.to(self.device)
            self.stats.h2d_s += time.perf_counter() - t0
            self.stats.h2d_bytes += host.numel() * host.element_size()
        return out.to(torch.bool) if dtype == torch.bool else out

    # -- point to point (ppermute) -----------------------------------------------
    def isend(self, t: torch.Tensor, dst_row: int) -> _Pending:
        host = self._to_host(t)
        self.stats.sent_bytes += host.numel() * host.element_size()
        return _Pending(self, dist.isend(host, dst_row), host)

    def irecv(self, shape, dtype, src_row: int) -> _Pending:
        host = self._host_buffer(shape, dtype)
        self.stats.recv_bytes += host.numel() * host.element_size()
        return _Pending(self, dist.irecv(host, src_row), host, dtype)

    # -- collectives ---------------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Sum (or ``op``) of ``t`` over ``group`` (the whole world when
        None); returns a new tensor on ``t``'s device."""
        t0 = time.perf_counter()
        host = self._to_host(t)
        if host is t:
            host = t.clone()
        dist.all_reduce(host, op=op, group=group)
        out = self._from_host(host, t.dtype)
        self._collective(host, t0)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This row's part of the sum of ``t`` over the world: ``t`` is
        1-D, its length divides by the row count, and row i gets the i-th
        of that many equal parts. Returns a new tensor on ``t``'s device."""
        t0 = time.perf_counter()
        n = self.n_rows
        if t.dim() != 1 or t.shape[0] % n:
            raise ValueError(f"reduce_scatter takes a 1-D buffer whose length divides by "
                             f"{n}; got shape {tuple(t.shape)}")
        host = self._to_host(t)
        part = self._host_buffer((t.shape[0] // n,), t.dtype)
        dist.reduce_scatter(part, list(host.chunk(n)))
        out = self._from_host(part, t.dtype)
        self._collective(host, t0)
        return out

    def all_gather(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """Every row's ``t`` (one shape on all of them) concatenated along
        dim 0 in row order, over ``group`` (the whole world when None)."""
        t0 = time.perf_counter()
        host = self._to_host(t)
        n = dist.get_world_size(group)
        # the rows' parts land in one host buffer (pinned when staging for
        # the card), which goes to the device as it is
        gathered = self._host_buffer((n,) + tuple(t.shape), t.dtype)
        dist.all_gather(list(gathered.unbind(0)), host, group=group)
        out = self._from_host(gathered.reshape((-1,) + tuple(t.shape[1:])), t.dtype)
        self._collective(host, t0)
        return out

    def broadcast(self, t: torch.Tensor, src_row: int) -> torch.Tensor:
        """Row ``src_row``'s ``t`` on every row, bit for bit; the other
        rows' ``t`` gives only the shape and dtype. The source gets its
        own tensor back."""
        t0 = time.perf_counter()
        if self.row == src_row:
            host = self._to_host(t)
        else:
            host = self._host_buffer(t.shape, t.dtype)
        dist.broadcast(host, src_row)
        out = t if self.row == src_row else self._from_host(host, t.dtype)
        self._collective(host, t0)
        return out

    def _collective(self, host: torch.Tensor, t0: float) -> None:
        self.stats.collective_bytes += host.numel() * host.element_size()
        self.stats.collective_s += time.perf_counter() - t0

    def barrier(self) -> None:
        if self.in_world:
            dist.barrier()

    def sync(self) -> None:
        """Wait for this rank's device work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, phases: dict | None, name: str):
        """Adds the block's synchronised seconds to ``phases[name]``
        (nothing is synchronised when ``phases`` is None)."""
        if phases is None:
            yield
            return
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0


def make_host_mesh(data: int = 4, model: int = 1, device=None) -> Mesh:
    """A planning mesh of ``data`` rows (no world: its transfers raise).
    The reference's ``model`` axis is GSPMD tensor parallelism, which the
    port does not have: ``model`` must be 1."""
    if model != 1:
        raise NotImplementedError(f"a model axis of {model}: the model axis (tensor "
                                  f"parallelism over it, the reference's param_specs) is not "
                                  f"ported; see ROADMAP A8")
    return Mesh(n_rows=data, device=device)


def required_devices(*, multi_pod: bool = False) -> int:
    """Devices of the reference's production mesh: 16 x 16 per pod."""
    return 512 if multi_pod else 256


def _rank_main(fn, row: int, n_rows: int, device: str, init_method: str, args: tuple,
               results, timeout_s: float) -> None:
    try:
        if device == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_rows))
        dist.init_process_group("gloo", init_method=init_method, rank=row,
                                world_size=n_rows,
                                timeout=datetime.timedelta(seconds=timeout_s))
        mesh = Mesh(n_rows=n_rows, row=row, device=torch.device(device))
        out = fn(mesh, *args)
        mesh.barrier()  # no rank tears down while another still talks to it
        results.put((row, True, out))
    except BaseException:  # reported to the parent, which fails the call
        results.put((row, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n_rows: int, *, device=None, args: tuple = (), timeout_s: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` in each of ``n_rows`` new processes, one
    per mesh row, and return their results in row order. ``fn`` and the
    results are pickled (``fn`` by import path): return numpy arrays or
    plain Python values, not tensors. ``device``: cuda unless the caller
    names another (`resolve_device`); every row uses that one device.
    Raises with the rank's traceback if any rank fails, and
    `TimeoutError` if the world has not finished in ``timeout_s`` (every
    collective inside times out at ``timeout_s`` too)."""
    dev = resolve_device(device)
    dev_name = "cuda" if dev.type == "cuda" else str(dev)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict[int, object] = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n_rows, dev_name, init_method, args, results,
                                   timeout_s))
                 for r in range(n_rows)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < n_rows:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"the {n_rows}-row world did not finish in {timeout_s} s; "
                                       f"rows done: {sorted(out)}")
                try:
                    row, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {row} failed:\n{payload}")
                out[row] = payload
        finally:
            for p in procs:
                p.join(timeout=10)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(n_rows)]


__all__ = ["Mesh", "WireStats", "make_host_mesh", "required_devices", "spawn"]
