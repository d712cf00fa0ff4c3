"""Optimizers from scratch: AdamW and SGD with momentum over nested
parameter trees (a port of the reference's `train/optimizer.py`).

Scalars (the learning rate, the bias corrections) are computed in f32 as
the reference computes them, and the leaf updates in f32. With
``inplace=True`` `apply_updates` writes the new parameters and moments
into the given tensors, so a full-width step holds no second copy of
them, and updates a leaf of more than `UPDATE_SLICE` elements slice by
slice (the same elementwise arithmetic), so that its temporaries stay a
few slices' worth; the reference's functional form (new trees) is the
default.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils.treeutil import tree_flatten, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


# elements of one slice of an in-place update (256 MiB of f32): at full
# width a leaf (an MoE layer's stacked experts, a ZeRO-1 part) is GBs, and
# AdamW's temporaries are several times a leaf
UPDATE_SLICE = 1 << 26


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule_lr(cfg: OptConfig, step: int) -> float:
    """Linear warmup + cosine decay, in f32 as the reference computes it
    (returned as the Python float of that f32 value)."""
    s = _f32(step)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac))
    lr = _f32(cfg.lr) * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)
    return lr.item()


def init_opt_state(cfg: OptConfig, params: Any) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    state = {"step": 0}
    if cfg.kind == "adamw":
        state["m"] = tree_map(zeros, params)
        state["v"] = tree_map(zeros, params)
    elif cfg.kind == "sgdm":
        state["m"] = tree_map(zeros, params)
    else:
        raise ValueError(cfg.kind)
    return state


def global_norm(tree: Any, *, tp=None, sharded=None) -> torch.Tensor:
    """The norm of a gradient tree. On a model axis (``tp``, the rank's
    `launch.mesh.Mesh`; ``sharded``: which leaves it shards, in
    tree order) the tree is this column's slices, and every element of the
    whole gradient counts once (`model_axis_norm`)."""
    if tp is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))
    sums = torch.zeros(2, dtype=torch.float32, device=tree_leaves(tree)[0].device)
    for g, sh in zip(tree_leaves(tree), sharded):
        sums[0 if sh else 1] += torch.sum(torch.square(g.float()))
    return model_axis_norm(tp, sums)


def model_axis_norm(tp, sums: torch.Tensor) -> torch.Tensor:
    """The gradient's norm on a model axis from this column's [sum of
    squares over the sharded leaves' elements, over the whole leaves'],
    each summed over the column's data rows: the first summed over the
    columns too, the second counted once (each column holds the same
    whole leaves)."""
    return torch.sqrt(tp.model_all_reduce(sums[:1])[0] + sums[1])


def clip_scale(grads: Any, max_norm: float,
               norm: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(the factor that brings the global norm to at most ``max_norm``, the
    norm). ``norm``: the global norm when ``grads`` is one part of the
    gradient (a ZeRO-1 shard); by default that of ``grads``."""
    norm = global_norm(grads) if norm is None else norm
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0), norm



@torch.no_grad()
def apply_updates(cfg: OptConfig, params: Any, grads: Any, state: dict, *,
                  inplace: bool = False,
                  grad_norm: torch.Tensor | None = None) -> tuple[Any, dict]:
    """One optimizer step -> (new params, new state). The update is
    elementwise, so ``params``, ``grads`` and the moments may be any one
    part of the whole (a ZeRO-1 shard); clipping then needs the whole
    gradient's norm, ``grad_norm``, which the caller gathers."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    # the clip scales each gradient piece as it is used (no scaled copy of
    # the whole gradient)
    scale = clip_scale(grads, cfg.grad_clip, grad_norm)[0] if cfg.grad_clip > 0 else None

    def put(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        return old.copy_(new) if inplace else new

    p_leaves, treedef = tree_flatten(params)

    def leaves_of(tree):
        leaves, d = tree_flatten(tree)
        if d != treedef:
            raise ValueError("apply_updates: trees differ in structure from params")
        return leaves

    def pieces(*leaves):
        """The leaves whole, or, for a large in-place update, as matching
        slices of their flat views (written in place, so the leaves hold
        the result)."""
        n = leaves[0].numel()
        if not inplace or n <= UPDATE_SLICE or not all(t.is_contiguous() for t in leaves):
            return [leaves]
        flat = [t.view(-1) for t in leaves]
        return [tuple(t[i:i + UPDATE_SLICE] for t in flat) for i in range(0, n, UPDATE_SLICE)]

    g_leaves = leaves_of(grads)
    if cfg.kind == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        bc1 = (1.0 - _f32(b1) ** step).item()
        bc2 = (1.0 - _f32(b2) ** step).item()
        m_leaves, v_leaves = leaves_of(state["m"]), leaves_of(state["v"])
        new_p, new_m, new_v = [], [], []
        for leaves in zip(p_leaves, g_leaves, m_leaves, v_leaves):
            parts = pieces(*leaves)
            for p, g, m, v in parts:
                g = (g if scale is None else g * scale).float()
                pf = p.float()
                m_new = b1 * m + (1 - b1) * g
                v_new = b2 * v + (1 - b2) * g * g
                step_dir = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
                p_new = pf - lr * (step_dir + cfg.weight_decay * pf)
                out = put(p, p_new.to(p.dtype)), put(m, m_new), put(v, v_new)
            if len(parts) > 1:
                out = leaves[0], leaves[2], leaves[3]
            new_p.append(out[0])
            new_m.append(out[1])
            new_v.append(out[2])
        return tree_unflatten(treedef, new_p), {
            "step": step, "m": tree_unflatten(treedef, new_m),
            "v": tree_unflatten(treedef, new_v)}

    if cfg.kind == "sgdm":
        new_p, new_m = [], []
        for leaves in zip(p_leaves, g_leaves, leaves_of(state["m"])):
            parts = pieces(*leaves)
            for p, g, m in parts:
                g = (g if scale is None else g * scale).float()
                pf = p.float()
                m_new = cfg.beta1 * m + g
                p_new = pf - lr * (m_new + cfg.weight_decay * pf)
                out = put(p, p_new.to(p.dtype)), put(m, m_new)
            if len(parts) > 1:
                out = leaves[0], leaves[2]
            new_p.append(out[0])
            new_m.append(out[1])
        return tree_unflatten(treedef, new_p), {"step": step,
                                                "m": tree_unflatten(treedef, new_m)}

    raise ValueError(cfg.kind)


__all__ = ["OptConfig", "apply_updates", "clip_scale", "global_norm", "init_opt_state",
           "model_axis_norm",
           "schedule_lr"]
