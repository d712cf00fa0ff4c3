"""Fault-tolerant checkpoints (a port of the reference's
`io/checkpoint.py`, with its on-disk format, so that each package reads
the other's files).

Layout on disk:
    <dir>/step_00000123/
        leaf_00000.npy ... leaf_NNNNN.npy    one plain numpy file per leaf
        treedef.json                          key paths + shapes + dtypes
        COMMIT                                atomic commit marker

Leaves are taken in the trees' flattening order (dict entries by sorted
key, lists and tuples in order: the reference's order), and the key
paths are written in its ``keystr`` form (``['params']['layers'][0]['wq']``).
A tensor leaf is stored unsharded, as the numpy array of its values on
the host; a Python scalar (the step counter) as a 0-d array. Only dtypes
numpy has are stored: a bf16 tensor is refused, as the reference's format
would need ``ml_dtypes`` to read it.

Guarantees:
  * atomic: written into ``step_XXXX.tmp``, then renamed; COMMIT written
    last. A crash mid-write leaves no COMMIT, and the loader ignores the
    directory. Leaves, manifest and marker are fsynced before each rename
    (and the parent directory after).
  * mesh-agnostic: whole leaves, restored onto any device (`restore`'s
    ``device``) and row count (`launch/elastic.py`).
  * async: `AsyncCheckpointer.save` copies every tensor to the host before
    it returns (a copy, never a view: the trainer updates its tensors in
    place), then writes on a worker thread.
  * retention: keep the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from repro_torch.utils.treeutil import tree_flatten, tree_map, tree_unflatten

COMMIT = "COMMIT"


def _leaf_paths(tree: Any, prefix: str = "") -> list[str]:
    """Key paths in the flattening order, in the reference's keystr form."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree) for p in _leaf_paths(x, f"{prefix}[{i}]")]
    return [prefix]


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf's values as a host numpy array that shares no memory with a
    tensor (so an in-place update after the call cannot change it)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError("checkpoint leaves need a numpy dtype; cast bf16 tensors to "
                             "f32 before saving")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _fsync_dir(path: str) -> None:
    # a directory fsync makes the rename itself durable; not every
    # filesystem lets a directory be opened, so a failure is benign
    with contextlib.suppress(OSError):
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def _durable_write(path: str, data: str) -> None:
    """fsync-then-rename: readers see the old bytes or the new, never a
    torn file, even across a crash mid-write."""
    tmp = path + ".part"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic checkpoint write. Returns the final directory."""
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = [_to_numpy(x) for x in tree_flatten(tree)[0]]
    meta = {"step": step, "paths": _leaf_paths(tree),
            "shapes": [list(a.shape) for a in leaves],
            "dtypes": [str(a.dtype) for a in leaves]}
    for i, arr in enumerate(leaves):
        with open(os.path.join(tmp, f"leaf_{i:05d}.npy"), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
    _durable_write(os.path.join(tmp, "treedef.json"), json.dumps(meta))
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(directory)
    # the marker is written after the rename, when the contents are whole
    # and durable: a crash anywhere above leaves no COMMIT
    _durable_write(os.path.join(final, COMMIT), "ok\n")
    _fsync_dir(final)
    return final


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(directory, name, COMMIT)):
            continue  # a torn write: the crash came before the commit
        with contextlib.suppress(ValueError):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    """The newest committed step; torn writes are ignored."""
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def _committed_dir(directory: str, step: int) -> str:
    d = _step_dir(directory, step)
    if not os.path.exists(os.path.join(d, COMMIT)):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    return d


def restore(directory: str, step: int, like: Any, device=None) -> Any:
    """Load a checkpoint into the structure of ``like``. A tensor leaf of
    ``like`` comes back as a tensor of its dtype on ``device`` (by default
    its own; only its shape and dtype are read, so with ``device`` given a
    ``meta`` tensor will do); a numpy leaf as a numpy array of its dtype;
    a Python scalar as a scalar of its type. Raises if a stored shape
    differs from ``like``'s."""
    d = _committed_dir(directory, step)
    leaves_like, treedef = tree_flatten(like)
    out = []
    for i, ref in enumerate(leaves_like):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        want = tuple(ref.shape) if isinstance(ref, torch.Tensor) else np.shape(ref)
        if arr.shape != want:
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != expected {want}")
        if isinstance(ref, torch.Tensor):
            dev = ref.device if device is None else torch.device(device)
            out.append(torch.from_numpy(arr).to(device=dev, dtype=ref.dtype))
        elif isinstance(ref, np.ndarray):
            out.append(arr.astype(ref.dtype))
        else:
            out.append(type(ref)(arr[()]))
    return tree_unflatten(treedef, out)


def restore_tree(directory: str, step: int) -> dict:
    """Load a checkpoint with no shape prior, rebuilding nested dicts from
    the recorded key paths alone (dict-of-dicts trees with string keys).
    Leaves come back as host numpy arrays (0-d arrays for scalars)."""
    d = _committed_dir(directory, step)
    with open(os.path.join(d, "treedef.json")) as f:
        meta = json.load(f)
    out: dict = {}
    for i, path in enumerate(meta["paths"]):
        keys = re.findall(r"\['([^']*)'\]", path)
        if not keys:
            raise ValueError(f"leaf {i}: non-dict key path {path!r}")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
    return out


def retain(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    for s in _committed_steps(directory)[:-keep]:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


class AsyncCheckpointer:
    """One background writer thread; at most one save in flight.

    `save(step, tree)` copies every leaf to the host before it returns,
    then writes on the thread; `wait()` blocks until the last write has
    committed (call it before another reader or a shutdown). ``log`` holds
    one dict per save: its step, bytes, the seconds `save` spent copying
    to the host (``snapshot_s``) and waiting for the previous write
    (``wait_s``), which together block the caller, and, once written, the
    seconds of the write (``write_s``, retention included)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.log: list[dict] = []
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._last: Future | None = None
        self._lock = threading.Lock()
        self._closed = False

    def save(self, step: int, tree: Any) -> None:
        t0 = time.perf_counter()
        host_tree = tree_map(_to_numpy, tree)
        t1 = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("save() on a closed AsyncCheckpointer")
            self._drain_last()  # backpressure: one write in flight
            entry = {"step": step, "snapshot_s": t1 - t0, "wait_s": time.perf_counter() - t1,
                     "bytes": sum(a.nbytes for a in tree_flatten(host_tree)[0])}
            self.log.append(entry)
            self._last = self._pool.submit(self._write, step, host_tree, entry)

    def _drain_last(self) -> None:
        # a failure on the worker thread would otherwise vanish: raise it
        # on the caller's thread at the next save() or wait()
        if self._last is None:
            return
        last, self._last = self._last, None
        try:
            last.result()
        except Exception as exc:
            raise RuntimeError(f"async checkpoint write to {self.directory} failed") from exc

    def _write(self, step: int, host_tree: Any, entry: dict) -> None:
        t0 = time.perf_counter()
        save(self.directory, step, host_tree)
        retain(self.directory, self.keep)
        entry["write_s"] = time.perf_counter() - t0

    def wait(self) -> None:
        with self._lock:
            self._drain_last()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            with self._lock:
                self._closed = True
            self._pool.shutdown()


__all__ = ["COMMIT", "AsyncCheckpointer", "latest_step", "restore", "restore_tree", "retain",
           "save"]
