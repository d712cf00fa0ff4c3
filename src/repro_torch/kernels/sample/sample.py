"""Wrapper of the hand-written CUDA last-token argmax kernel
(``kernels/csrc/argmax_last.cu``), which replaces the reference's Pallas
`argmax_last_kernel`.

Takes the (B, V) last-position rows, strided or not (the last dimension
must be contiguous), and returns (B,) int32. Each row is split over
blocks (`argmax_split`, from shapes alone) and the splits are merged
inside the same launch, so a call is one launch on PyTorch's current
stream with no host synchronisation. Counts each launch in
``argmax_last_kernel.launches``. The library is built and loaded on the
first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the split: B x splits blocks should cover the SMs of an H100 once, each
# span a multiple of 64 elements (so 16-byte loads stay aligned across
# spans wherever the row is) and at least 2 KB long
SMS = 132
SPAN_UNIT = 64
MIN_SPAN_BYTES = 2048
MAX_ROWS = 65535


@functools.lru_cache(maxsize=256)
def argmax_split(b: int, vocab: int, elt: int) -> tuple[int, int]:
    """(span, splits) for ``b`` rows of ``vocab`` ``elt``-byte logits: each
    row is cut into ``splits`` spans of ``span`` elements (the last one
    shorter, none empty), one block each. A function of shapes only."""
    span = max(-(-vocab // -(-SMS // b)), MIN_SPAN_BYTES // elt)
    span = -(-span // SPAN_UNIT) * SPAN_UNIT
    return span, -(-vocab // span)


@functools.cache
def _entry():
    fn = runtime.load("argmax_last").argmax_last
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# (device index, stream) -> (rows, tickets, partials): kept across calls,
# so a call allocates nothing but its output. Tickets (one per row) are
# zeroed once here and left at zero by every launch (see argmax_last.cu);
# partials hold a row's (value, index) pairs, two int32 words each. A call
# of b rows has at most b + SMS - 1 pairs (`argmax_split`).
# The key is the raw stream handle. PyTorch's own streams (the default one
# and its fixed pools, which `torch.cuda.Stream()` draws from) are never
# destroyed, so a handle names one stream for the life of the process, and
# the launches that share an entry are ordered by that stream; the dict
# holds at most one entry per pooled stream. A `torch.cuda.ExternalStream`
# must outlive the argmax launches made on it: CUDA may hand a destroyed
# stream's handle to a new stream, which would then share this scratch
# with launches it is not ordered against.
_SCRATCH: dict[tuple[int, int], tuple[int, int, int, torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, rows: int):
    held = _SCRATCH.get((device.index, stream))
    if held is None or held[0] < rows:
        rows = max(rows, 256)
        tickets = torch.zeros(rows, dtype=torch.int32, device=device)
        partials = torch.empty(2 * (rows + SMS), dtype=torch.int32, device=device)
        held = (rows, tickets.data_ptr(), partials.data_ptr(), tickets, partials)
        _SCRATCH[(device.index, stream)] = held
    return held


def argmax_last_kernel(last: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab axis of (B, V) f32/bf16 rows -> (B,) int32."""
    if not last.is_cuda:
        runtime.require_cuda("argmax_last_kernel", last)
    if last.ndim != 2 or last.dtype not in _CODE:
        raise TypeError(f"want (B, V) f32/bf16 rows, got {tuple(last.shape)} {last.dtype}")
    b, vocab = last.shape
    if vocab == 0:
        raise ValueError("argmax over an empty vocabulary")
    if b > MAX_ROWS:
        raise ValueError(f"{b} rows is past the kernel's {MAX_ROWS} (its grid's y extent)")
    if last.stride(1) != 1:
        last = last.contiguous()
    out = last.new_empty((b,), dtype=torch.int32)
    if b == 0:
        return out
    span, splits = argmax_split(b, vocab, last.element_size())
    stream = runtime.stream_handle(last)
    _, tickets, partials = _scratch(last.device, stream, b)[:3]
    rc = _entry()(last.data_ptr(), last.stride(0), b, vocab, _CODE[last.dtype], span, splits,
                  partials, tickets, out.data_ptr(), stream)
    runtime.check(rc, "argmax_last_kernel")
    argmax_last_kernel.launches += 1
    return out


argmax_last_kernel.launches = 0

__all__ = ["argmax_last_kernel", "argmax_split"]
