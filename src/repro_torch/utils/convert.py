"""Carry the reference package's parameters into the port.

`params_from_numpy` takes the JAX parameter pytree after the caller has
turned every leaf into a numpy array (``jax.tree.map(np.asarray, p)``;
bf16 leaves arrive as ``ml_dtypes.bfloat16``). It unstacks the scanned
``(L, ...)`` layer leaves (``layers``; an encoder-decoder's
``enc_layers`` and ``dec_layers``) into the port's per-layer lists of
dicts and stores the
tensors as the port keeps them: matmul weights, biases and embedding
tables in ``cfg.dtype``; norm scales and biases, and the SSM's own
parameters (`F32_LEAVES`), in f32 as the reference stores and uses
them; all bit for bit from the reference's f32 leaves, on the device
the caller names (`resolve_device`: no device is an error without a
GPU, never a quiet CPU fallback). `unit_from_numpy` converts one unit
of the port's tree at a time (`Model.units`), so that an FSDP row takes
its parts without the whole tree on its device. On a model axis
(``tp``: a rank's `launch.mesh.Mesh`) both
keep this rank's column slices of what they convert
(`train.sharding.param_specs`), one unit whole at a time. This module
imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.train import sharding


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch on ``device``, bf16 (ml_dtypes) included, bit for bit."""
    device = resolve_device(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


# Mamba-2 leaves the reference keeps and computes in f32 (`models/ssm.py`;
# a hybrid layer's ``mamba`` dict too):
# rounding A_log to bf16 moves A = -exp(A_log) by up to ~0.5 %, and the
# decay compounds that over every position
F32_LEAVES = frozenset({"A_log", "D", "dt_bias", "conv_w", "conv_b"})


def _convert(tree, dtype, device, keep_f32: bool = False):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device, keep_f32 or "norm" in k or k in F32_LEAVES)
                for k, v in tree.items()}
    t = tensor_from_numpy(np.asarray(tree), device)
    return t.to(torch.float32 if keep_f32 else dtype)


def _stacked(cfg) -> dict[str, int]:
    """The scanned layer stacks of the reference's tree -> their depth."""
    if cfg.family == "encdec":
        return {"enc_layers": cfg.encoder_layers, "dec_layers": cfg.n_layers}
    return {"layers": cfg.n_layers}


def params_from_numpy(tree: dict, cfg, device, *, param_dtype=None, tp=None,
                      replicate_ssm: bool = False) -> dict:
    """The reference's parameter tree (numpy leaves, layers stacked on a
    leading L axis) -> the port's parameters on ``device``. Matmul
    leaves are stored in ``param_dtype``, by default ``cfg.dtype`` (the
    serving path); training passes ``torch.float32`` to keep the
    reference's f32 leaves as they are. ``tp``: this rank's column slices
    (``replicate_ssm``: in that layout of a Mamba block, as the model's)."""
    device = resolve_device(device)
    dtype = cfg.dtype if param_dtype is None else param_dtype
    stacks = _stacked(cfg)
    out = {k: _convert(v, dtype, device, "norm" in k)
           for k, v in tree.items() if k not in stacks}
    for key, depth in stacks.items():
        out[key] = [_convert(_index(tree[key], i), dtype, device) for i in range(depth)]
    if tp is not None and tp.model_size > 1:
        specs = sharding.spec_list(out, tp.model_size, replicate_ssm=replicate_ssm)
        out = sharding.shard_model(out, specs, tp.model_size, tp.col)
    return out


def unit_from_numpy(tree: dict, cfg, unit: str, device, *, param_dtype=None, tp=None,
                    replicate_ssm: bool = False):
    """Unit ``unit`` of the port's tree (``embed``, ``layers.i``,
    ``enc_layers.i``, ``dec_layers.i`` or ``rest``, the other top-level
    entries) from the reference's tree, as `params_from_numpy` converts
    it; ``tp``: this rank's column slices of it."""
    device = resolve_device(device)
    dtype = cfg.dtype if param_dtype is None else param_dtype
    stacks = _stacked(cfg)
    if unit == "embed":
        out = _convert(tree["embed"], dtype, device)
    elif unit == "rest":
        out = {k: _convert(v, dtype, device, "norm" in k)
               for k, v in tree.items() if k not in stacks and k != "embed"}
    else:
        key, i = unit.rsplit(".", 1)
        out = _convert(_index(tree[key], int(i)), dtype, device)
    if tp is not None and tp.model_size > 1:
        specs = sharding.unit_specs(unit, out, tp.model_size, replicate_ssm=replicate_ssm)
        out = sharding.shard_model(out, specs, tp.model_size, tp.col)
    return out


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
