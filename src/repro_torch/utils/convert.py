"""Carry the reference package's parameters into the port.

`params_from_numpy` takes the JAX parameter pytree after the caller has
turned every leaf into a numpy array (``jax.tree.map(np.asarray, p)``;
bf16 leaves arrive as ``ml_dtypes.bfloat16``). It unstacks the scanned
``(L, ...)`` layer leaves into the port's per-layer dicts and stores the
tensors as the port keeps them: matmul weights, biases and embedding
tables in ``cfg.dtype``; norm scales and biases, and the SSM's own
parameters (`F32_LEAVES`), in f32 as the reference stores and uses
them; all bit for bit from the reference's f32 leaves, on the device
the caller names (`resolve_device`: no device is an error without a
GPU, never a quiet CPU fallback). This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch on ``device``, bf16 (ml_dtypes) included, bit for bit."""
    device = resolve_device(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


# Mamba-2 leaves the reference keeps and computes in f32 (`models/ssm.py`):
# rounding A_log to bf16 moves A = -exp(A_log) by up to ~0.5 %, and the
# decay compounds that over every position
F32_LEAVES = frozenset({"A_log", "D", "dt_bias", "conv_w", "conv_b"})


def _convert(tree, dtype, device, keep_f32: bool = False):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device, keep_f32 or "norm" in k or k in F32_LEAVES)
                for k, v in tree.items()}
    t = tensor_from_numpy(np.asarray(tree), device)
    return t.to(torch.float32 if keep_f32 else dtype)


def params_from_numpy(tree: dict, cfg, device, *, param_dtype=None) -> dict:
    """The reference's LM parameter tree (numpy leaves, layers stacked
    on a leading L axis) -> the port's parameters on ``device``. Matmul
    leaves are stored in ``param_dtype``, by default ``cfg.dtype`` (the
    serving path); training passes ``torch.float32`` to keep the
    reference's f32 leaves as they are."""
    device = resolve_device(device)
    dtype = cfg.dtype if param_dtype is None else param_dtype
    stacked = tree["layers"]
    per_layer = [_index(stacked, i) for i in range(cfg.n_layers)]
    out = {k: _convert(v, dtype, device, "norm" in k)
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_convert(p, dtype, device) for p in per_layer]
    return out


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
