"""Elastic re-scaling through checkpoints (a port of the checkpoint path
of the reference's `launch/elastic.py`).

Checkpoints hold whole leaves (`io.checkpoint`), so the same files resume
on any row count and in any step mode: `restore_for_mesh` loads them onto
the target mesh's device, and the step's rows take their shards from
there (`row_shard`, `train.sharding`). `healthy_mesh` picks the largest
row count the healthy devices allow, halving the rows as the reference
halves its data axis; `healthy_mesh_with_backoff` probes a few times
before it shrinks.

Not ported yet: the in-memory path (`reshard_state`, `repack_block_pool`),
which the adaptive loop drives (ROADMAP A9).
"""
from __future__ import annotations

import math
import time
from typing import Callable

import torch

from repro_torch.io import checkpoint as ckpt
from repro_torch.launch.mesh import Mesh, make_host_mesh


def restore_for_mesh(ckpt_dir: str, step: int, like_state: dict, mesh: Mesh) -> dict:
    """Load ``step`` in the structure of ``like_state`` onto ``mesh``'s device."""
    restored = ckpt.restore(ckpt_dir, step, like_state, device=mesh.device)
    restored["step"] = int(restored["step"])
    return restored


def _device_count() -> int:
    return torch.cuda.device_count()


def healthy_mesh(preferred_shape: tuple[int, ...], axis_names: tuple[str, ...] = ("data",),
                 n_devices: int | None = None, *, device=None) -> Mesh:
    """A planning mesh of the most rows the healthy devices allow: the
    ``data`` axis (axis 0) of ``preferred_shape`` halves until the shape
    fits ``n_devices`` (by default the cards present); the other axes,
    which must be 1, never shrink."""
    n = _device_count() if n_devices is None else int(n_devices)
    shape = list(preferred_shape)
    total = math.prod(shape)
    while total > n and shape[0] > 1:
        shape[0] //= 2
        total //= 2
    if total > n:
        raise RuntimeError(f"not enough devices: need {total}, have {n}")
    mesh = make_host_mesh(shape[0], math.prod(shape[1:]), device=device)
    mesh.axis = axis_names[0]
    return mesh


def healthy_mesh_with_backoff(preferred_shape: tuple[int, ...],
                              axis_names: tuple[str, ...] = ("data",), *,
                              prober: Callable[[], int] | None = None, attempts: int = 4,
                              base_delay: float = 0.05,
                              sleep: Callable[[float], None] = time.sleep,
                              on_retry: Callable[[int, float], None] | None = None,
                              device=None) -> Mesh:
    """`healthy_mesh` behind a bounded exponential backoff: ask
    ``prober`` (healthy device count; by default the cards present) up to
    ``attempts`` times, doubling the delay from ``base_delay``, and shrink
    only if the count still falls short after the last probe (a slow node
    looks like a lost one to a single probe)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    probe = _device_count if prober is None else prober
    need = math.prod(preferred_shape)
    n = probe()
    for attempt in range(1, attempts):
        if n >= need:
            break
        delay = base_delay * (2 ** (attempt - 1))
        if on_retry is not None:
            on_retry(attempt, delay)
        sleep(delay)
        n = probe()
    return healthy_mesh(preferred_shape, axis_names, n_devices=n, device=device)


__all__ = ["healthy_mesh", "healthy_mesh_with_backoff", "restore_for_mesh"]
