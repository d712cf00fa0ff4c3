"""Mamba-2 SSD chunked scan: plain version, CUDA kernel, op."""
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_naive, ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_kernel

__all__ = ["ssd", "ssd_naive", "ssd_ref", "ssd_scan_kernel"]
