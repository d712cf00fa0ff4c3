"""Stream-reduce kernels: the reducer group's chunk fold and the keyed
histogram (plain versions, CUDA kernels, ops)."""
from repro_torch.kernels.stream_reduce.ops import accumulate, keyed_histogram
from repro_torch.kernels.stream_reduce.ref import chunk_accumulate_ref, histogram_ref
from repro_torch.kernels.stream_reduce.stream_reduce import (
    chunk_accumulate_kernel,
    histogram_kernel,
)

__all__ = ["accumulate", "chunk_accumulate_kernel", "chunk_accumulate_ref",
           "histogram_kernel", "histogram_ref", "keyed_histogram"]
