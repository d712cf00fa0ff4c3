"""Optimizers from scratch: AdamW and SGD with momentum over nested
parameter trees (a port of the reference's `train/optimizer.py`).

Scalars (the learning rate, the bias corrections) are computed in f32 as
the reference computes them, and the leaf updates in f32. With
``inplace=True`` `apply_updates` writes the new parameters and moments
into the given tensors, so a full-width step holds no second copy of
them; the reference's functional form (new trees) is the default.
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


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float,
                        norm: torch.Tensor | None = None) -> tuple[Any, torch.Tensor]:
    """``grads`` scaled so that their global norm is at most ``max_norm``.
    ``norm``: the global norm when ``grads`` is one part of the gradient
    (a ZeRO-1 shard); by default that of ``grads``."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


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
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip, grad_norm)

    def put(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        return old.copy_(new) if inplace else new

    p_leaves, treedef = tree_flatten(params)

    def leaves_of(tree):
        leaves, d = tree_flatten(tree)
        if d != treedef:
            raise ValueError("apply_updates: trees differ in structure from params")
        return leaves

    g_leaves = leaves_of(grads)
    if cfg.kind == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        bc1 = (1.0 - _f32(b1) ** step).item()
        bc2 = (1.0 - _f32(b2) ** step).item()
        m_leaves, v_leaves = leaves_of(state["m"]), leaves_of(state["v"])
        new_p, new_m, new_v = [], [], []
        for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
            g = g.float()
            pf = p.float()
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            step_dir = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            p_new = pf - lr * (step_dir + cfg.weight_decay * pf)
            new_p.append(put(p, p_new.to(p.dtype)))
            new_m.append(put(m, m_new))
            new_v.append(put(v, v_new))
        return tree_unflatten(treedef, new_p), {
            "step": step, "m": tree_unflatten(treedef, new_m),
            "v": tree_unflatten(treedef, new_v)}

    if cfg.kind == "sgdm":
        new_p, new_m = [], []
        for p, g, m in zip(p_leaves, g_leaves, leaves_of(state["m"])):
            g = g.float()
            pf = p.float()
            m_new = cfg.beta1 * m + g
            p_new = pf - lr * (m_new + cfg.weight_decay * pf)
            new_p.append(put(p, p_new.to(p.dtype)))
            new_m.append(put(m, m_new))
        return tree_unflatten(treedef, new_p), {"step": step,
                                                "m": tree_unflatten(treedef, new_m)}

    raise ValueError(cfg.kind)


__all__ = ["OptConfig", "apply_updates", "clip_by_global_norm", "global_norm",
           "init_opt_state", "schedule_lr"]
