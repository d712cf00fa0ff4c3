"""Kernel runtime for the port: device resolution, and the nvcc build of
the hand-written CUDA kernels.

Build: each source under ``kernels/csrc/`` compiles on first use, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC``, into a shared library with a plain C interface under
``build/repro_torch/`` at the repository root. The library name carries
a hash of the sources and flags, so an edited kernel rebuilds and a
stale one is never loaded. `build_all` starts one nvcc per source at
once, so a cold start pays for the slowest source, not their sum. The
library is loaded with `ctypes`; each C entry point returns
``cudaGetLastError()`` and the wrapper raises if it is not 0.

Dispatch policy (every kernel family's ``ops.py``): a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel or raises.
There is no switch, and no environment variable, that routes a CUDA
tensor away from its kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SOURCES = {
    "paged_attention": "paged_attention.cu",
    "argmax_last": "argmax_last.cu",
    "flash_attention": "flash_attention.cu",
    "ssd_scan": "ssd_scan.cu",
    "stream_reduce": "stream_reduce.cu",
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is asked for (or defaulted to) and
    no GPU is present — never a quiet CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where the built library of kernel source ``name`` lives: keyed on
    a hash of every source and header in ``csrc`` plus the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        if f.suffix == ".cuh" or f.name == SOURCES[name]:
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Build every named kernel library not yet built, one nvcc process
    per source, all started together. Returns name -> library path;
    raises with the compiler's output if any build fails. The ptxas
    report (registers, shared memory, spills) is kept beside each
    library as ``<lib>.log``."""
    names = list(SOURCES) if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_name(paths[n].name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built if needed)."""
    return ctypes.CDLL(str(build_all([name])[name]))


def check(rc: int, what: str) -> None:
    """Raise if a C entry point's ``cudaGetLastError()`` was not 0."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer (read
    without building a `torch.cuda.Stream`, which costs a host-bound
    decode tick ~5 us per kernel call)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require_cuda(what: str, *tensors) -> None:
    """Kernel wrappers take CUDA tensors only, all on one device."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors on one device, "
                         f"got {sorted(map(str, devs))}")
