"""StreamChannel: the MPIStream communication channel over a rank world
(a port of the reference's `core/channel.py`).

The paper's channel (Sec. III-A) connects a producer group to a consumer
group: producers inject stream elements as soon as they are ready
(``MPIStream_Isend``) and consumers fold an operator over arriving
elements (``MPIStream_Operate``).

Everything here is this rank's part of the channel (`launch.mesh`): a
producer row sends, a consumer row receives and folds, and a row that
takes no part in a wave does nothing. The reference's SPMD form folds
zeros on such rows and selects the old value; skipping the fold gives the
same value.

Schedule: with C producer rows and R consumer rows, producers drain in
``ceil(C/R)`` waves, each a static partial permutation (`wave_perm`),
the reference's round-robin schedule (DESIGN.md §2), so results match it
value for value.

ChannelWire: a channel owns a wire codec (identity / bf16 / int8,
`core.wire`) and, for whole-tree folds, a chunked schedule
(``chunk_bytes``): the payload is packed into fixed-size wire chunks, and
the consumer posts the receive of chunk ``k+1`` before it decodes chunk
``k``, so two chunks are in flight (the producer keeps at most two
unacknowledged sends). ``chunk_bytes=None`` keeps the whole-payload
fold per wave.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import wire as wirelib
from repro_torch.core.groups import COMPUTE, GroupedMesh
from repro_torch.kernels.stream_reduce import ops as reduce_ops
from repro_torch.utils.treeutil import (tree_flatten, tree_leaves, tree_map, tree_meta,
                                       tree_unflatten)

Operator = Callable[[Any, torch.Tensor, int], Any]  # (acc, element, k) -> acc

#: wave-combine strategies of the chunked tree fold (see stream_fold_tree)
WAVE_FOLDS = ("kernel", "add", "scan")


def broadcast_from_row(gmesh: GroupedMesh, src_row: int, value: Any) -> Any:
    """Row ``src_row``'s tree on every row, every leaf bit for bit in its
    own dtype; the other rows' ``value`` gives only shapes and dtypes."""
    return tree_map(lambda x: gmesh.mesh.broadcast(x, src_row), value)


@dataclasses.dataclass(frozen=True)
class StreamChannel:
    """A directed channel ``producer -> consumer`` over the world's rows.

    ``codec`` and ``chunk_bytes`` are the channel's wire defaults
    (declared per edge on a `ServiceGraph`); a fold call may override
    both. ``codec=None`` means identity."""

    gmesh: GroupedMesh
    producer: str
    consumer: str
    codec: wirelib.WireCodec | None = None
    chunk_bytes: int | None = None

    # -- static schedule ----------------------------------------------------
    @property
    def mesh(self):
        return self.gmesh.mesh

    @property
    def n_producers(self) -> int:
        return self.gmesh.group(self.producer).size

    @property
    def n_consumers(self) -> int:
        return self.gmesh.group(self.consumer).size

    @property
    def n_waves(self) -> int:
        return math.ceil(self.n_producers / max(self.n_consumers, 1))

    def wave_perm(self, wave: int) -> list[tuple[int, int]]:
        """Static (src, dst) row pairs of one wave (a partial permutation)."""
        prod = list(self.gmesh.rows_of(self.producer))
        cons = list(self.gmesh.rows_of(self.consumer))
        r = len(cons)
        return [(prod[wave * r + j], cons[j]) for j in range(r) if wave * r + j < len(prod)]

    def _role(self, wave: int) -> tuple[str | None, int | None]:
        """("send", dst), ("recv", src) or (None, None) for this rank."""
        row = self.mesh.row
        for src, dst in self.wave_perm(wave):
            if src == row:
                return "send", dst
            if dst == row:
                return "recv", src
        return None, None

    def _codec(self, codec) -> wirelib.WireCodec:
        return wirelib.get_codec(codec if codec is not None else self.codec)

    # -- transfers of one wave ---------------------------------------------------
    def _send_chunks(self, wire: Any, n_chunks: int, dst: int) -> None:
        """Send chunks 0..n_chunks-1 of every wire leaf, at most two
        chunks unacknowledged."""
        leaves, _ = tree_flatten(wire)
        inflight: collections.deque = collections.deque()
        for k in range(n_chunks):
            inflight.extend(self.mesh.isend(leaf[k], dst) for leaf in leaves)
            while len(inflight) > 2 * len(leaves):
                inflight.popleft().wait()
        for p in inflight:
            p.wait()

    def _recv_chunks(self, wire_like: Any, n_chunks: int, src: int, decode):
        """Yield (k, decoded chunk k) as chunks arrive; chunk k+1's
        receive is posted before chunk k is decoded."""
        leaves, treedef = tree_flatten(wire_like)

        def post():
            return [self.mesh.irecv(leaf.shape[1:], leaf.dtype, src) for leaf in leaves]

        pending = post() if n_chunks else None
        for k in range(n_chunks):
            nxt = post() if k + 1 < n_chunks else None
            arrived = tree_unflatten(treedef, [p.wait() for p in pending])
            yield k, decode(arrived)
            pending = nxt

    @staticmethod
    def _encoder(codec: wirelib.WireCodec, dtype: torch.dtype):
        """(encode_chunks, decode_chunk) of a buffer of ``dtype``."""
        if codec.applies(dtype):
            return codec.encode_chunks, codec.decode_chunk
        return (lambda b: b), (lambda w: w)

    def _check_device(self, *trees: Any) -> None:
        """Folds run on the mesh's device: a payload on another device (the
        card's gradients on a CPU mesh, say) is refused, never folded
        there. ``meta`` leaves (shapes only) pass."""
        want = self.mesh.device.type
        for tree in trees:
            for x in tree_leaves(tree) if tree is not None else ():
                if isinstance(x, torch.Tensor) and x.device.type not in (want, "meta"):
                    raise ValueError(f"a payload leaf lies on {x.device}, the mesh on "
                                     f"{self.mesh.device}: build the Mesh on the "
                                     f"payload's device")

    # -- the core fold ---------------------------------------------------------
    def stream_fold(self, elements: torch.Tensor, operator: Operator, init: Any, *,
                    count=None, waves: Sequence[int] | None = None,
                    codec: "wirelib.WireCodec | str | None" = None) -> Any:
        """Stream producer-local ``elements`` (n_chunks, S) to the
        consumers and fold ``operator(acc, element, k)`` over what
        arrives, from ``init``. Returns the folded state (meaningful on
        consumer rows; ``init`` elsewhere).

        ``count``: this producer's number of valid chunks (an int or a
        0-d tensor); it travels ahead of the chunks, and only chunks
        ``k < count`` are sent and folded (the reference masks the rest).
        ``waves``: the waves to drain (default all). ``codec``: the wire
        codec (default the channel's); producers encode once, consumers
        decode each chunk before the operator sees it."""
        self._check_device(elements)
        n_chunks = elements.shape[0]
        encode, decode = self._encoder(self._codec(codec), elements.dtype)
        acc = init
        for wave in range(self.n_waves) if waves is None else waves:
            role, peer = self._role(wave)
            if role == "send":
                n_send = n_chunks
                if count is not None:
                    n_send = min(int(count), n_chunks)
                    self.mesh.isend(torch.tensor([n_send], dtype=torch.int64), peer).wait()
                self._send_chunks(encode(elements), n_send, peer)
            elif role == "recv":
                n_recv = n_chunks
                if count is not None:
                    n_recv = int(self.mesh.irecv((1,), torch.int64, peer).wait()[0])
                wire_like = encode(elements.to("meta"))
                for k, elem in self._recv_chunks(wire_like, n_recv, peer, decode):
                    acc = operator(acc, elem, k)
        return acc

    # -- whole-tree fold ---------------------------------------------------------
    def stream_fold_tree(self, payload: Any, *, acc_init: Any | None = None,
                         combine: Callable[[Any, Any, bool], Any] | None = None,
                         codec: "wirelib.WireCodec | str | None" = None,
                         chunk_bytes: int | None = None,
                         waves: Sequence[int] | None = None,
                         wave_fold: str | None = None) -> Any:
        """Stream a whole tree and fold it on the consumer group.

        ``payload`` is read on producer rows only; elsewhere only its
        shapes and dtypes matter (``meta`` tensors will do), and the
        accumulator lives on the mesh's device. ``combine(acc, arrived,
        ok)`` folds one wave (the default sums leaf by leaf); a consumer
        calls it only for a wave it receives, with ``ok=True``.

        Two schedules: ``chunk_bytes=None`` sends the whole payload per
        wave; ``chunk_bytes=B`` packs it into B-byte wire chunks streamed
        two at a time. ``wave_fold`` picks the chunked default-sum fold:
        ``"kernel"`` stages the wave's decoded chunks and folds f32
        groups with the `chunk_accumulate` kernel on the (2, S) stack of
        accumulator and staging (as the reference does); ``"add"`` the
        same staging with a plain add; ``"scan"`` adds each chunk as it
        arrives. All three give the same values. None picks "kernel" on a
        CUDA device and "scan" on the CPU (the reference picks the Pallas
        kernel on the TPU). A payload leaf on another device than the
        mesh's is refused."""
        self._check_device(payload, acc_init)
        codec = self._codec(codec)
        chunk_bytes = chunk_bytes if chunk_bytes is not None else self.chunk_bytes
        if wave_fold is None:
            wave_fold = "kernel" if self.mesh.device.type == "cuda" else "scan"
        if wave_fold not in WAVE_FOLDS:
            raise ValueError(f"wave_fold={wave_fold!r} not in {WAVE_FOLDS}")
        wave_ids = range(self.n_waves) if waves is None else waves
        if chunk_bytes is None:
            return self._fold_tree_whole(payload, acc_init, combine, codec, wave_ids)
        return self._fold_tree_chunked(payload, acc_init, combine, codec, int(chunk_bytes),
                                       wave_ids, wave_fold)

    def _zeros_like(self, tree: Any) -> Any:
        return tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype,
                                              device=self.mesh.device), tree)

    def _idle_result(self, payload, acc_init):
        """What a row that received nothing returns: ``acc_init``, else
        zeros of the payload's structure (allocated only now, after this
        row's own sends have released their buffers)."""
        return self._zeros_like(payload) if acc_init is None else acc_init

    def _fold_tree_whole(self, payload, acc_init, combine, codec, wave_ids):
        """The whole payload per wave (the reference's barrier schedule)."""
        default = combine is None
        combine = combine or (lambda acc, new, ok: tree_map(torch.add, acc, new))
        identity = codec.name == "identity"
        acc = None
        for wave in wave_ids:
            role, peer = self._role(wave)
            if role == "send":
                leaves, _ = tree_flatten(payload if identity else codec.encode_tree(payload))
                for p in [self.mesh.isend(x, peer) for x in leaves]:
                    p.wait()
            elif role == "recv":
                like = tree_meta(payload)
                leaves, treedef = tree_flatten(like if identity else codec.encode_tree(like))
                pending = [self.mesh.irecv(x.shape, x.dtype, peer) for x in leaves]
                arrived = tree_unflatten(treedef, [p.wait() for p in pending])
                if not identity:
                    arrived = codec.decode_tree(arrived)
                if acc is None:
                    acc = self._idle_result(payload, acc_init)
                acc = combine(acc, arrived, True)
        if acc is None:
            return self._idle_result(payload, acc_init)
        if default and not identity:
            # lossy codecs decode to f32 and the sum promotes to f32: round
            # once at the end to the accumulator's dtype
            ref = payload if acc_init is None else acc_init
            acc = tree_map(lambda a, r: a.to(r.dtype), acc, ref)
        return acc

    def _fold_tree_chunked(self, payload, acc_init, combine, codec, chunk_bytes, wave_ids,
                           wave_fold):
        """The ChannelWire schedule: packed chunks, two in flight."""
        packer = wirelib.WirePacker.plan(payload, chunk_bytes)
        generic = combine is not None
        dev = self.mesh.device
        acc = acc_bufs = packed = pairs = None
        for wave in wave_ids:
            role, peer = self._role(wave)
            if role == "send":
                packed = packer.pack(payload) if packed is None else packed
                for g, buf in zip(packer.groups, packed):
                    encode, _ = self._encoder(codec, g.dtype)
                    self._send_chunks(encode(buf), g.n_chunks, peer)
                continue
            if role != "recv":
                continue
            if generic and acc is None:
                acc = self._idle_result(payload, acc_init)
            elif not generic and acc_bufs is None:
                pairs, acc_bufs = self._accumulators(packer, acc_init, codec, wave_fold)
            staged_all = []
            for i, g in enumerate(packer.groups):
                encode, decode = self._encoder(codec, g.dtype)
                wire_like = encode(torch.empty((g.n_chunks, g.chunk_elems), dtype=g.dtype,
                                               device="meta"))
                chunks = self._recv_chunks(wire_like, g.n_chunks, peer, decode)
                if not generic and wave_fold == "scan":
                    for k, chunk in chunks:
                        acc_bufs[i][k] += chunk.to(acc_bufs[i].dtype)
                    continue
                staged = None if generic or pairs[i] is None else pairs[i][1]
                for k, chunk in chunks:
                    if staged is None:
                        staged = torch.empty((g.n_chunks, g.chunk_elems), dtype=chunk.dtype,
                                             device=dev)
                    staged[k] = chunk
                if generic:
                    staged_all.append(staged)
                elif pairs[i] is not None:
                    self._fold_pair(pairs[i])
                else:
                    acc_bufs[i] = self._fold_wave(acc_bufs[i], staged)
            if generic:
                acc = combine(acc, packer.unpack(staged_all), True)
        del packed
        if acc is None and acc_bufs is None:
            return self._idle_result(payload, acc_init)
        return acc if generic else packer.unpack(acc_bufs)

    def _accumulators(self, packer, acc_init, codec, wave_fold):
        """The default-sum fold's accumulators, one a packer group, from
        ``acc_init`` or zeros (f32 for a codec group, which decodes to f32:
        rounded once in unpack). For the "kernel" fold an f32 group's
        accumulator is row 0 of a (2, n_chunks, chunk_elems) stack whose
        row 1 stages each wave: the operand `chunk_accumulate` reads, its
        sum written back into row 0, so the fold copies nothing (at full
        width the gradient is GBs). -> (the stacks or None, by group; the
        accumulators)."""
        start = None if acc_init is None else packer.pack(acc_init)
        pairs, bufs = [], []
        for i, g in enumerate(packer.groups):
            shape = (g.n_chunks, g.chunk_elems)
            dtype = torch.float32 if codec.applies(g.dtype) else g.dtype
            pair = None
            if wave_fold == "kernel" and g.dtype == torch.float32:
                pair = torch.empty((2,) + shape, dtype=torch.float32, device=self.mesh.device)
                buf = pair[0]
            else:
                buf = torch.empty(shape, dtype=dtype, device=self.mesh.device)
            if start is None:
                buf.zero_()
            else:
                buf.copy_(start[i])
            pairs.append(pair)
            bufs.append(buf)
        return pairs, bufs

    def _fold_pair(self, pair) -> None:
        """One f32 wave with the `chunk_accumulate` kernel: ``pair`` is the
        (2, n_chunks, chunk_elems) stack of accumulator and staged wave, and
        the sum goes back into the accumulator's row (timed, synchronised)."""
        self.mesh.sync()
        t0 = time.perf_counter()
        reduce_ops.accumulate(pair.reshape(2, -1), out=pair[0].reshape(-1))
        self.mesh.sync()
        self.mesh.stats.fold_s += time.perf_counter() - t0

    def _fold_wave(self, acc_buf, staged):
        """One wave's staged chunks into the accumulator with a plain add
        (timed, synchronised): the "add" fold, and "kernel"'s for a
        non-f32 group."""
        self.mesh.sync()
        t0 = time.perf_counter()
        out = acc_buf + staged.to(acc_buf.dtype)
        self.mesh.sync()
        self.mesh.stats.fold_s += time.perf_counter() - t0
        return out

    # -- result return path --------------------------------------------------------
    def broadcast_from_consumer(self, value: Any) -> Any:
        """The consumer group's (identical) result on every row, bit for
        bit: broadcast from the group's first row."""
        return broadcast_from_row(self.gmesh, self.gmesh.group(self.consumer).start, value)

    def scatter_back(self, value: Any, *, wave_of_target: int = 0) -> Any:
        """Reverse-direction transfer: the consumer rows of wave
        ``wave_of_target`` send ``value`` to that wave's producer rows,
        along the inverse of `wave_perm` (isend/irecv). A producer row of
        the wave returns what its consumer sent; every other row returns
        zeros of ``value``'s structure, as the reference's ppermute does.
        ``value`` gives every row the shapes and dtypes."""
        self._check_device(value)
        leaves, treedef = tree_flatten(value)
        for prod, cons in self.wave_perm(wave_of_target):
            if cons == self.mesh.row:
                for p in [self.mesh.isend(x, prod) for x in leaves]:
                    p.wait()
            elif prod == self.mesh.row:
                pending = [self.mesh.irecv(x.shape, x.dtype, cons) for x in leaves]
                return tree_unflatten(treedef, [p.wait() for p in pending])
        return self._zeros_like(value)


def make_channel(gmesh: GroupedMesh, consumer: str, producer: str = COMPUTE, *,
                 codec: "wirelib.WireCodec | str | None" = None,
                 chunk_bytes: int | None = None) -> StreamChannel:
    """One channel on a bare `GroupedMesh` (a `ServiceGraph` declares
    them per edge)."""
    return StreamChannel(gmesh=gmesh, producer=producer, consumer=consumer,
                         codec=wirelib.get_codec(codec) if codec is not None else None,
                         chunk_bytes=chunk_bytes)


__all__ = ["Operator", "StreamChannel", "WAVE_FOLDS", "broadcast_from_row", "make_channel"]
