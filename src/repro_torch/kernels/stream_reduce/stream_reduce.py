"""Wrappers of the hand-written CUDA stream-reduce kernels
(``kernels/csrc/stream_reduce.cu``), which replace the reference's Pallas
`chunk_accumulate` and `histogram`.

Each wrapper checks its inputs, allocates the output, launches on
PyTorch's current stream and counts one launch in ``<wrapper>.launches``
per call (`chunk_accumulate_kernel` may issue a second CUDA launch for a
ragged or unaligned tail; it still counts once). The histogram adds into
its output; given ``out=``, it adds into that accumulator (a stream of
elements folded into one histogram pays no zero fill per element). Its
path comes from `histogram_plan`, a function of ``n_bins`` alone. The
library is built and loaded on the first call, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the histogram's private bins: one block's shared memory holds up to
# CTA_BINS f32 bins (227 KB, the opt-in limit of an H100 block)
SMEM_BYTES = 232_448
CTA_BINS = SMEM_BYTES // 4
PATHS = ("block", "global")


def histogram_plan(n_bins: int) -> tuple[str, int]:
    """(path, block_bins) of the histogram kernel for ``n_bins`` f32 bins,
    whatever the counts' type: "block" while one block's shared memory
    holds every bin (``block_bins`` of them, ``n_bins`` rounded up to a
    multiple of 4), else "global" (adds to the output behind a per-block
    cache of hot keys; ``block_bins`` 0). A function of n_bins only."""
    if n_bins <= CTA_BINS:
        return "block", -(-n_bins // 4) * 4
    return "global", 0


def _lib():
    lib = runtime.load("stream_reduce")
    if lib.chunk_accumulate.argtypes is None:
        lib.chunk_accumulate.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.chunk_accumulate.restype = ctypes.c_int
        lib.keyed_histogram.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p]
        lib.keyed_histogram.restype = ctypes.c_int
    return lib


def chunk_accumulate_kernel(elements: torch.Tensor) -> torch.Tensor:
    """Column sum of a contiguous (n, S) f32/bf16 buffer -> (S,) f32."""
    runtime.require_cuda("chunk_accumulate_kernel", elements)
    if elements.ndim != 2 or elements.dtype not in _CODE:
        raise TypeError(f"want (n, S) f32/bf16, got {tuple(elements.shape)} {elements.dtype}")
    n, s = elements.shape
    if n == 0:
        raise ValueError("chunk_accumulate of zero rows")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows is past the kernel's int row count")
    elements = elements.contiguous()
    out = torch.empty((s,), dtype=torch.float32, device=elements.device)
    rc = _lib().chunk_accumulate(elements.data_ptr(), s, n, _CODE[elements.dtype],
                                 out.data_ptr(), runtime.stream_handle(elements))
    runtime.check(rc, "chunk_accumulate_kernel")
    chunk_accumulate_kernel.launches += 1
    return out


def check_hist_out(out: torch.Tensor, keys: torch.Tensor, n_bins: int) -> None:
    """An accumulator a histogram may add into: contiguous (n_bins,) f32 on
    the keys' device."""
    if out.dtype != torch.float32 or tuple(out.shape) != (n_bins,) \
            or not out.is_contiguous() or out.device != keys.device:
        raise ValueError(f"out must be a contiguous ({n_bins},) float32 tensor on "
                         f"{keys.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")


def histogram_kernel(keys: torch.Tensor, counts: torch.Tensor, n_bins: int, *,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Keyed sum of counts (N,) f32/bf16 by keys (N,) int32 -> (n_bins,) f32;
    negative keys and keys >= n_bins are dropped. With ``out`` the sums are
    added into it (`check_hist_out`), and it is returned."""
    runtime.require_cuda("histogram_kernel", keys, counts)
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    if counts.dtype not in _CODE:
        raise TypeError(f"counts must be f32/bf16, got {counts.dtype}")
    if keys.ndim != 1 or keys.shape != counts.shape:
        raise ValueError(f"want keys and counts of one (N,) shape, got "
                         f"{tuple(keys.shape)} and {tuple(counts.shape)}")
    if not 0 < n_bins < 2 ** 31:
        raise ValueError(f"n_bins={n_bins} outside [1, 2^31)")
    keys, counts = keys.contiguous(), counts.contiguous()
    path, block_bins = histogram_plan(n_bins)
    if out is None:
        out = torch.zeros((n_bins,), dtype=torch.float32, device=keys.device)
    else:
        check_hist_out(out, keys, n_bins)
    rc = _lib().keyed_histogram(keys.data_ptr(), counts.data_ptr(), keys.shape[0], n_bins,
                                _CODE[counts.dtype], PATHS.index(path), block_bins,
                                out.data_ptr(), runtime.stream_handle(keys))
    runtime.check(rc, f"histogram_kernel ({path} path)")
    histogram_kernel.launches += 1
    return out


chunk_accumulate_kernel.launches = 0
histogram_kernel.launches = 0

__all__ = ["check_hist_out", "chunk_accumulate_kernel", "histogram_kernel", "histogram_plan"]
