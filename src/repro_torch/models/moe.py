"""Mixture-of-Experts layer: GShard-style grouped top-k dispatch with
capacity dropping, optional shared expert (the reference's
`models/moe.py`).

Tokens go in groups of ``t = min(DEFAULT_GROUP, B * S)``; each expert
takes at most ``_capacity(t, E, k, cfg.moe_capacity_factor)`` tokens of
a group. The top-k is iterative: every token's first choice claims its
slot (the running count of the group's tokens, in token order, that
chose the expert before it) before any second choice does, and a token
whose slot is past the capacity is dropped from that expert. Tokens past
the last whole group go through expert 0 densely, unweighted, as the
reference's ragged tail does. The group size and the capacity factor are
the reference's defaults; no environment variable changes them.

The reference builds one-hot ``(g, t, E, C)`` dispatch and combine
tensors and contracts them with einsums. Here the same routing is kept
as indices (`Route`: each round's expert and slot per token, and whether
it was kept), the dispatch is a scatter of the kept tokens into their
``(group, expert, slot)`` rows and the combine a gather of those rows:
the same tokens land in the same slots and are dropped alike, and the
expert products are batched matmuls over the experts (plain PyTorch, as
the reference's are plain jnp outside any kernel).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Params = dict

DEFAULT_GROUP = 1024


def init_moe(gen: torch.Generator, cfg, *, dtype=torch.bfloat16, device=None) -> Params:
    """The reference's tree and scales: a bias-free router, and the
    experts' stacked ``w_gate``/``w_up`` ``(E, d, ff)`` and ``w_down`` ``(E,
    ff, d)`` drawn at 1/sqrt(E) (`layers.dense_init` takes its fan-in from
    the first axis, as the reference's `_dense_init` does); a SwiGLU
    shared expert where the config has one."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": layers.init_linear(gen, d, e, **kw),
        "w_gate": layers.dense_init(gen, (e, d, ff), device=device).to(dtype),
        "w_up": layers.dense_init(gen, (e, d, ff), device=device).to(dtype),
        "w_down": layers.dense_init(gen, (e, ff, d), device=device).to(dtype),
    }
    if cfg.shared_expert:
        p["shared"] = layers.init_mlp(gen, d, ff, "swiglu", **kw)
    return p


def _capacity(group: int, n_experts: int, k: int, factor: float) -> int:
    c = int(group * k * factor / n_experts)
    return max(4, min(group, c))


@dataclasses.dataclass
class Route:
    """The routing of ``g`` groups of ``t`` tokens. ``choice``, ``slot``
    and ``keep`` are ``(k, g, t)``: round ``i``'s expert of each token,
    its slot in that expert's ``capacity`` rows, and whether the slot is
    inside the capacity (a dropped choice claims no slot). ``probs`` is
    the router's f32 softmax ``(g, t, E)``."""

    probs: torch.Tensor
    choice: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(p: Params, xg: torch.Tensor, cfg, dtype) -> Route:
    """Route ``xg`` ``(g, t, d)``: the reference's iterative top-k over
    ``log(p + 1e-9)`` with the experts already chosen masked to -inf
    (ties to the first index), each round's slots counted from the fill
    the earlier rounds left."""
    g, t, _ = xg.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = _capacity(t, e, k, cfg.moe_capacity_factor)
    probs = torch.softmax(layers.linear(p["router"], xg, dtype).float(), dim=-1)
    gate_in = torch.log(probs + 1e-9)
    used = torch.zeros((g, t, e), dtype=torch.bool, device=xg.device)
    fill = torch.zeros((g, e), dtype=torch.long, device=xg.device)
    choices, slots, keeps = [], [], []
    for _ in range(k):
        choice = torch.where(used, -torch.inf, gate_in).argmax(-1)  # (g, t)
        onehot = F.one_hot(choice, e)  # (g, t, e)
        before = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :]
        slot = torch.gather(before, -1, choice[..., None])[..., 0]
        keep = slot < cap
        fill = fill + (onehot * keep[..., None]).sum(1)
        used = used | onehot.bool()
        choices.append(choice)
        slots.append(slot)
        keeps.append(keep)
    return Route(probs, torch.stack(choices), torch.stack(slots), torch.stack(keeps), cap)


def _experts(p: Params, xe: torch.Tensor, dtype) -> torch.Tensor:
    """Every expert's SwiGLU on its rows: ``xe`` ``(E, n, d)`` -> ``(E, n, d)``."""
    h = F.silu(torch.bmm(xe, p["w_gate"].to(dtype)))
    h = h * torch.bmm(xe, p["w_up"].to(dtype))
    return torch.bmm(h, p["w_down"].to(dtype))


def apply_moe(p: Params, x: torch.Tensor, cfg, dtype=torch.bfloat16):
    """x: (B, S, d) -> (out (B, S, d) in ``dtype``, {aux_loss, router_entropy}),
    the reference's Switch-style load-balancing loss and routing entropy
    (f32 scalars)."""
    bsz, s, d = x.shape
    e = cfg.n_experts
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    t = min(DEFAULT_GROUP, n_tok)
    g = n_tok // t
    xg = tokens[: g * t].reshape(g, t, d)
    r = route(p, xg, cfg, dtype)
    k, cap = r.choice.shape[0], r.capacity

    # dispatch: each kept (round, group, token) to its (group, expert, slot)
    # row of ``xe``; a dropped one to a spare last row that no expert reads
    # (static shapes: no host synchronisation)
    n_rows = g * e * cap
    grp = torch.arange(g, device=x.device)[None, :, None]
    rows = torch.where(r.keep, (grp * e + r.choice) * cap + r.slot, n_rows).reshape(k, g * t)
    xe = torch.zeros((n_rows + 1, d), dtype=dtype, device=x.device)
    xe[rows.reshape(-1)] = xg.reshape(g * t, d).to(dtype).repeat(k, 1)
    xe = xe[:n_rows].reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    ye = _experts(p, xe, dtype).reshape(e, g, cap, d).transpose(0, 1).reshape(n_rows, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])

    # combine: each round's row weighted by the chosen expert's probability
    # cast to ``dtype`` (as the reference casts its combine tensor), summed
    # in f32 and rounded once; a dropped round reads the zero row
    w = torch.gather(r.probs, -1, r.choice.permute(1, 2, 0)).permute(2, 0, 1)  # (k, g, t)
    w = w.reshape(k, g * t, 1).to(dtype).float()
    out = w[0] * ye[rows[0]].float()
    for i in range(1, k):
        out = out + w[i] * ye[rows[i]].float()
    out = out.to(dtype)
    if g * t < n_tok:  # the ragged tail: expert 0, densely, unweighted
        tail = _experts({k_: p[k_][:1] for k_ in ("w_gate", "w_up", "w_down")},
                        tokens[g * t:].to(dtype)[None], dtype)[0]
        out = torch.cat([out, tail])
    y = out.reshape(bsz, s, d)
    if cfg.shared_expert:
        y = y + layers.apply_mlp(p["shared"], x, "swiglu", dtype)

    me = r.probs.mean(dim=(0, 1))  # (E,)
    routed = (F.one_hot(r.choice, e) * r.keep[..., None]).amax(0)  # (g, t, E)
    ce = routed.float().mean(dim=(0, 1))
    aux_loss = e * torch.sum(me * ce)
    entropy = -torch.sum(r.probs * torch.log(r.probs + 1e-9), dim=-1).mean()
    return y, {"aux_loss": aux_loss, "router_entropy": entropy}
