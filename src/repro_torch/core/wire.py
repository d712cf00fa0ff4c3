"""ChannelWire: the wire format of a `StreamChannel` (a port of the
reference's `core/wire.py`: the codecs, `WireSpec` and `WirePacker`).

* `WirePacker` flattens a payload tree into fixed-size wire chunks. It
  groups leaves by dtype and gives each group its own ``(n_chunks,
  chunk_elems)`` buffer, so f32 gradients, bf16 caches and int32 ids all
  travel in their own width. The ragged tail chunk is zero-padded;
  padding never reaches the unpacked tree. Leaves are ordered as
  `utils.treeutil.tree_flatten` orders them (dicts by sorted key, as
  `jax.tree.flatten` does).
* `WireCodec` encodes packed buffers chunk-wise, or whole leaves (the
  unchunked path). `identity` is bit-exact, `bf16` halves f32 (exact for
  bf16-representable values), `int8` quantises symmetrically with one
  scale per chunk or leaf (about 4x fewer bytes). Codecs transform
  floating groups only; integer and bool groups pass through unchanged.
* `raw_bytes` / `encoded_bytes` count the bytes of one payload send.

The reference's producer-side error feedback (`compress_with_feedback`)
and its speculative-decoding payload helpers are not ported yet (they
come with the int8 training wire and with ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils.treeutil import tree_flatten, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Identity codec and the base of the codec hierarchy.

    ``encode_leaf``/``decode_leaf`` act on whole tensors (the unchunked
    fold); ``encode_chunks``/``decode_chunk`` on a packed ``(n_chunks,
    S)`` buffer, giving a wire tree whose leaves keep the leading chunk
    axis (chunk ``k`` of every wire leaf travels together).
    ``applies(dtype)`` says which packed dtype groups the codec transforms.
    """

    name: str = "identity"

    def applies(self, dtype) -> bool:
        return False

    def encode_leaf(self, x: torch.Tensor) -> Any:
        return x

    def decode_leaf(self, wire: Any) -> torch.Tensor:
        return wire

    def encode_chunks(self, buf: torch.Tensor) -> Any:
        """(n_chunks, S) buffer -> wire tree with a leading chunk axis."""
        return buf

    def decode_chunk(self, wire: Any) -> torch.Tensor:
        """Wire chunk(s) -> data (broadcasts over a leading chunk axis)."""
        return wire

    def encoded_chunk_bytes(self, chunk_elems: int, itemsize: int) -> int:
        return chunk_elems * itemsize

    def encode_tree(self, payload: Any) -> Any:
        return tree_map(self.encode_leaf, payload)

    def decode_tree(self, wire_tree: Any) -> Any:
        return _map_wire(self.decode_leaf, wire_tree)


@dataclasses.dataclass(frozen=True)
class Bf16Codec(WireCodec):
    """f32 (and wider floats) to bfloat16 on the wire: half the bytes,
    exact for values already representable in bf16."""

    name: str = "bf16"

    def applies(self, dtype) -> bool:
        return dtype.is_floating_point and dtype.itemsize > 2

    def encode_leaf(self, x):
        return x.to(torch.bfloat16) if self.applies(x.dtype) else x

    def decode_leaf(self, wire):
        return wire.float() if wire.dtype == torch.bfloat16 else wire

    def encode_chunks(self, buf):
        return buf.to(torch.bfloat16)

    def decode_chunk(self, wire):
        return wire.float()

    def encoded_chunk_bytes(self, chunk_elems, itemsize):
        return chunk_elems * 2


@dataclasses.dataclass(frozen=True)
class Int8Codec(WireCodec):
    """Symmetric int8: q = round(x / scale), scale = max|x| / 127 (+1e-12).
    One scale per leaf in leaf form, one per chunk in chunk form."""

    name: str = "int8"

    def applies(self, dtype) -> bool:
        return dtype.is_floating_point

    @staticmethod
    def _quantize(xf: torch.Tensor, amax: torch.Tensor) -> dict:
        scale = amax / 127.0 + 1e-12
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale.float()}

    def encode_leaf(self, x):
        if not self.applies(x.dtype):
            return x
        xf = x.float()
        return self._quantize(xf, xf.abs().max())

    def decode_leaf(self, wire):
        if not is_int8_payload(wire):
            return wire
        return wire["q"].float() * wire["scale"]

    def encode_chunks(self, buf):
        buf = buf.float()
        return self._quantize(buf, buf.abs().amax(dim=-1, keepdim=True))

    def decode_chunk(self, wire):
        return wire["q"].float() * wire["scale"]

    def encoded_chunk_bytes(self, chunk_elems, itemsize):
        return chunk_elems + 4  # int8 data + one f32 scale


def is_int8_payload(x: Any) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _map_wire(fn, tree: Any) -> Any:
    """``fn`` over a wire tree whose int8 payloads ({"q", "scale"}) are leaves."""
    if is_int8_payload(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_wire(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_wire(fn, v) for v in tree)
    return fn(tree)


CODECS = {"identity": WireCodec(), "bf16": Bf16Codec(), "int8": Int8Codec()}


def get_codec(codec: "str | WireCodec | None") -> WireCodec:
    """A codec from its name, an instance, or None (identity)."""
    if codec is None:
        return CODECS["identity"]
    if isinstance(codec, WireCodec):
        return codec
    try:
        return CODECS[codec]
    except KeyError:
        raise KeyError(f"unknown codec {codec!r}; have {sorted(CODECS)}") from None


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Per-edge wire declaration of a `ServiceGraph`: the codec, and the
    chunked schedule's wire granularity in bytes (None keeps the
    unchunked whole-payload fold)."""

    codec: "str | WireCodec" = "identity"
    chunk_bytes: "int | None" = None

    @staticmethod
    def of(spec: "str | WireCodec | WireSpec | None") -> "WireSpec":
        if spec is None:
            return WireSpec()
        if isinstance(spec, WireSpec):
            return spec
        if isinstance(spec, WireCodec):
            return WireSpec(codec=spec)
        return WireSpec(codec=get_codec(spec).name)


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------

def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf travels as: itself, except bool -> uint8."""
    return torch.uint8 if dtype == torch.bool else dtype


@dataclasses.dataclass(frozen=True)
class WireGroup:
    """One dtype group of a packed payload: its leaves and chunk geometry."""

    dtype: torch.dtype
    leaf_idx: tuple[int, ...]
    total: int  # unpadded element count
    chunk_elems: int
    n_chunks: int

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class WirePacker:
    """Static, dtype-preserving chunking plan for a payload tree.

    ``chunk_bytes`` sets the wire granularity in bytes; each dtype group
    chunks its own flat buffer into ``(n_chunks, chunk_bytes / itemsize)``
    rows. `pack` gives one buffer per group, `unpack` restores the tree
    bit for bit."""

    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    groups: tuple[WireGroup, ...]

    @staticmethod
    def plan(payload_like: Any, chunk_bytes: int) -> "WirePacker":
        """Plan from the payload's shapes and dtypes alone (``meta``
        tensors will do)."""
        leaves, treedef = tree_flatten(payload_like)
        shapes = tuple(tuple(l.shape) for l in leaves)
        dtypes = tuple(l.dtype for l in leaves)
        by_dtype: dict[torch.dtype, list[int]] = {}
        for i, l in enumerate(leaves):
            by_dtype.setdefault(_wire_dtype(l.dtype), []).append(i)
        groups = []
        for dtype, idx in by_dtype.items():
            total = max(int(sum(math.prod(shapes[i]) for i in idx)), 1)
            chunk_elems = min(max(1, int(chunk_bytes) // dtype.itemsize), total)
            groups.append(WireGroup(dtype, tuple(idx), total, chunk_elems,
                                    -(-total // chunk_elems)))
        return WirePacker(treedef, shapes, dtypes, tuple(groups))

    def pack(self, payload: Any) -> tuple[torch.Tensor, ...]:
        leaves, _ = tree_flatten(payload)
        out = []
        for g in self.groups:
            flat = torch.cat([leaves[i].reshape(-1).to(g.dtype) for i in g.leaf_idx])
            pad = g.n_chunks * g.chunk_elems - g.total
            if pad:
                flat = torch.cat([flat, flat.new_zeros((pad,))])
            out.append(flat.reshape(g.n_chunks, g.chunk_elems))
        return tuple(out)

    def unpack(self, buffers) -> Any:
        leaves: list = [None] * len(self.shapes)
        for g, buf in zip(self.groups, buffers):
            flat = buf.reshape(-1)[:g.total].to(g.dtype)
            off = 0
            for i in g.leaf_idx:
                size = math.prod(self.shapes[i])
                leaves[i] = flat[off:off + size].reshape(self.shapes[i]).to(self.dtypes[i])
                off += size
        return tree_unflatten(self.treedef, leaves)

    def zeros(self, device=None) -> tuple[torch.Tensor, ...]:
        return tuple(torch.zeros((g.n_chunks, g.chunk_elems), dtype=g.dtype, device=device)
                     for g in self.groups)

    def raw_bytes(self) -> int:
        """Bytes of one full payload send with the identity wire."""
        return sum(g.n_chunks * g.chunk_elems * g.itemsize for g in self.groups)

    def encoded_bytes(self, codec: "str | WireCodec") -> int:
        """Bytes of one full payload send after ``codec``."""
        codec = get_codec(codec)
        return sum(g.n_chunks * (codec.encoded_chunk_bytes(g.chunk_elems, g.itemsize)
                                 if codec.applies(g.dtype) else g.chunk_elems * g.itemsize)
                   for g in self.groups)


__all__ = ["CODECS", "Bf16Codec", "Int8Codec", "WireCodec", "WireGroup", "WirePacker",
           "WireSpec", "get_codec", "is_int8_payload"]
