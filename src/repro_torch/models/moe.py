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
the reference's are plain jnp outside any kernel). The gradient of the
loss ``ce + 0.01 * aux_loss`` flows as the reference's does: through the
router's softmax into the combine weights and ``me``, through the
scatter and gather into the tokens and the expert ``bmm``s; the ragged
tail and ``ce`` (a count) give the router none, and a dropped token's
spare row is never read, so it gets no gradient either.

Routing over a world (`RouteWorld`): the reference's conventional and
overlap train steps are one program over the global batch, so a group
of ``min(DEFAULT_GROUP, B_global * S)`` tokens may straddle the shards
of two data-parallel rows, its capacity slots are counted in global
token order, and ``aux_loss`` is taken over the global batch. With a
world, each row routes its own shard as that part of the global token
stream: per top-k round one all-gather of every row's per-(group,
expert) choice counts gives each row its slot offsets, and one
all-reduce of the routed tokens' probability sums, routed counts and
entropies gives the global ``me``, ``ce`` and ``router_entropy``.

On a model axis (`apply_moe`'s ``tp``) the layer is the reference's
under GSPMD, by hand: its experts shard over E where E divides the axis
(each column computing its experts' rows; the router's column slices
gathered whole, so every column routes alike), else over each expert's
``ff``; one all-reduce of the combined f32 output a layer; each column
routes over its own column's rows.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Params = dict

DEFAULT_GROUP = 1024
# the metrics `apply_moe` reports (a layer mean in the model's loss); with a
# `RouteWorld` both are the global batch's
AUX_METRICS = ("aux_loss", "router_entropy")


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


class RouteWorld:
    """The data-parallel rows whose equal shards, in row order, make one
    global batch (the conventional and overlap train steps): `apply_moe`
    routes each row's tokens as their part of the global token stream.
    ``mesh`` gives ``n_rows``, ``row``, ``all_gather`` and ``all_reduce``
    (`launch.mesh.Mesh`). A world serves one forward pass and its
    recompute: every exchange is stashed under its layer and name, so a
    checkpointed layer recomputed in the backward pass runs no collective
    again."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._stash: dict = {}
        self._started = False

    def start(self) -> None:
        """Mark the one forward pass this world serves (`forward_lm`)."""
        if self._started:
            raise RuntimeError("a RouteWorld serves one forward pass (and its recompute)")
        self._started = True

    def at(self, layer: int) -> "LayerWorld":
        return LayerWorld(self, layer)


@dataclasses.dataclass(frozen=True)
class LayerWorld:
    """One layer's view of a `RouteWorld`."""

    world: RouteWorld
    layer: int

    @property
    def n_rows(self) -> int:
        return self.world.mesh.n_rows

    @property
    def row(self) -> int:
        return self.world.mesh.row

    def exchanged(self, name, fn):
        """``fn()`` (a collective) the first time this layer asks for
        ``name``; its stashed result after."""
        key = (self.layer, name)
        stash = self.world._stash
        if key not in stash:
            stash[key] = fn()
        return stash[key]


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


def route(p: Params, xg: torch.Tensor, cfg, dtype, *, present=None, exchange=None) -> Route:
    """Route ``xg`` ``(g, t, d)``: the reference's iterative top-k over
    ``log(p + 1e-9)`` with the experts already chosen masked to -inf
    (ties to the first index), each round's slots counted from the fill
    the earlier rounds left. ``present`` ``(g, t)`` marks the positions
    that hold this row's tokens (the others neither count nor keep a
    slot); ``exchange(round, counts)`` maps the round's ``(g, E)`` choice
    counts to the counts of the tokens before this row's in each group
    and the groups' totals (by default 0 and ``counts``: the groups are
    this row's alone)."""
    g, t, _ = xg.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = _capacity(t, e, k, cfg.moe_capacity_factor)
    probs = torch.softmax(layers.linear(p["router"], xg, dtype).float(), dim=-1)
    gate_in = torch.log(probs + 1e-9)
    used = torch.zeros((g, t, e), dtype=torch.bool, device=xg.device)
    fill = torch.zeros((g, e), dtype=torch.long, device=xg.device)
    choices, slots, keeps = [], [], []
    for i in range(k):
        choice = torch.where(used, -torch.inf, gate_in).argmax(-1)  # (g, t)
        onehot = F.one_hot(choice, e)  # (g, t, e)
        if present is not None:
            onehot = onehot * present[..., None]
        counts = onehot.sum(1)  # (g, e)
        before, total = (0, counts) if exchange is None else exchange(i, counts)
        slot = torch.cumsum(onehot, dim=1) - onehot + (fill + before)[:, None, :]
        slot = torch.gather(slot, -1, choice[..., None])[..., 0]
        keep = slot < cap
        if present is not None:
            keep = keep & present
        # the round's tokens take the slots from ``fill`` on in token order,
        # so the first cap - fill of them are kept
        fill = fill + torch.minimum(torch.clamp_min(cap - fill, 0), total)
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


def _world_layout(world: LayerWorld, n_tok: int) -> tuple[int, int, int, int, int]:
    """This row's place in the global token stream of ``world``: (group
    size t, global groups, first group this row's routed tokens touch,
    their offset in it, routed tokens of this row). Shards are equal and
    in row order; tokens past the last whole global group are the tail."""
    n_glob = world.n_rows * n_tok
    t = min(DEFAULT_GROUP, n_glob)
    g_glob = n_glob // t
    start = world.row * n_tok
    routed = max(0, min(n_tok, g_glob * t - start))
    if not routed:  # this row's tokens are all in the tail
        return t, g_glob, g_glob, 0, 0
    return t, g_glob, start // t, start % t, routed


def _count_exchange(world: LayerWorld, g0: int, g1: int, g_glob: int):
    """`route`'s ``exchange`` over a world: per round one all-gather of
    every row's choice counts by global group and expert."""

    def exchange(i: int, counts: torch.Tensor):
        def gather():
            buf = counts.new_zeros((g_glob, counts.shape[1]))
            buf[g0:g1] = counts
            return world.world.mesh.all_gather(buf[None])  # (rows, groups, E)

        every = world.exchanged(("counts", i), gather)
        return every[:world.row].sum(0)[g0:g1], every.sum(0)[g0:g1]

    return exchange


def expert_split(p: Params, cfg, tp) -> str | None:
    """How a model axis splits a layer's experts, read from their shapes
    (`train.sharding.param_specs`): ``"experts"`` where each column holds
    E / M of them and the router's columns for them (expert parallelism),
    ``"ff"`` where each column holds every expert's slice of ``ff`` and
    the router whole (tensor parallelism inside the experts), None
    without a model axis or where the experts are whole on every column."""
    if tp is None:
        return None
    if p["w_gate"].shape[0] != cfg.n_experts:
        return "experts"
    if p["w_gate"].shape[-1] != cfg.d_ff:
        return "ff"
    return None


def apply_moe(p: Params, x: torch.Tensor, cfg, dtype=torch.bfloat16,
              world: LayerWorld | None = None, tp=None):
    """x: (B, S, d) -> (out (B, S, d) in ``dtype``, {aux_loss, router_entropy}),
    the reference's Switch-style load-balancing loss and routing entropy
    (f32 scalars). With ``world`` (`RouteWorld.at`), ``x`` is this row's
    shard of the global batch: it routes as part of the global token
    stream, ``aux_loss`` and ``router_entropy`` are the global batch's
    (no gradient), and ``aux_share`` is this row's differentiable share
    of ``aux_loss``, ``E * sum(probsum_row / N * ce_global)`` over the N
    routed tokens of the world, so that the rows' shares sum to it.

    ``tp`` (a rank's `launch.mesh.Mesh` on a model axis; ``p`` this
    column's slices, `expert_split`): under the ``"experts"`` split the
    router's column slices are gathered whole (``d x E`` elements, a
    layer), so every column computes the whole logits, their input
    gradient and the router's gradient as one process does (and takes its
    slice of that gradient), rather than partial input gradients that an
    all-reduce would add in another order. Every column builds the same
    `Route` (and, with ``world``, the same exchanges over its column's
    rows) and dispatches the (round, token) pairs that its experts take,
    the others to the spare row; under the ``"ff"`` split every pair, its
    experts' outputs partial sums. The combine sums the column's weighted
    rows in f32, the ragged tail joins them (expert 0's: column 0's alone
    under the ``"experts"`` split, zeros elsewhere; each column's ``ff``
    slice of it under ``"ff"``), and one all-reduce of that f32 sum
    precedes the one cast to ``dtype``. The tokens the columns' partial
    products read go through `layers.copy_to_model`, and so do the
    combine weights, whose gradient each column holds for its own rows
    alone, so that every column back-propagates the whole gradient of the
    router's probabilities. The aux metrics come from the whole
    probabilities, alike on every column."""
    bsz, s, d = x.shape
    e = cfg.n_experts
    split = expert_split(p, cfg, tp)
    tokens = x.reshape(-1, d)
    # the input of the column's partial products, the experts' and the
    # ragged tail's: copied once whole, so that every column all-reduces
    # one input gradient in its backward, the tail's too, which under the
    # "experts" split column 0 alone computes
    tokens_tp = tokens if split is None else layers.copy_to_model(tokens, tp)
    n_tok = tokens.shape[0]
    if world is None:
        t = min(DEFAULT_GROUP, n_tok)
        g, lead, present, exchange = n_tok // t, 0, None, None
        n_routed = g * t

        def grouped(tok):
            return tok[:n_routed].reshape(g, t, d)
    else:
        t, g_glob, g0, lead, n_routed = _world_layout(world, n_tok)
        g = -(-(lead + n_routed) // t)  # the groups this row's routed tokens touch

        def grouped(tok):
            # this row's routed tokens at their places in those groups, the
            # other rows' places empty
            return F.pad(tok[:n_routed], (0, 0, lead, g * t - lead - n_routed)).reshape(g, t, d)

        present = torch.zeros(g * t, dtype=torch.bool, device=x.device)
        present[lead:lead + n_routed] = True
        present = present.reshape(g, t)
        exchange = _count_exchange(world, g0, g0 + g, g_glob)
    xg = grouped(tokens)
    xg_tp = xg if split is None else grouped(tokens_tp)
    router = p
    if split == "experts":  # the router whole (its gradient: this column's slice)
        router = {"router": {k: layers.gather_from_model(v, tp)
                             for k, v in p["router"].items()}}
    r = route(router, xg, cfg, dtype, present=present, exchange=exchange)
    k, cap = r.choice.shape[0], r.capacity

    # dispatch: each kept (round, group, token) that this column's experts
    # take to its (group, expert, slot) row of ``xe``; the others to a
    # spare last row that no expert reads (static shapes: no host
    # synchronisation)
    e_loc = p["w_gate"].shape[0]
    first = tp.col * e_loc if split == "experts" else 0
    take = r.keep
    if split == "experts":
        take = take & (r.choice >= first) & (r.choice < first + e_loc)
    n_rows = g * e_loc * cap
    grp = torch.arange(g, device=x.device)[None, :, None]
    rows = torch.where(take, (grp * e_loc + r.choice - first) * cap + r.slot,
                       n_rows).reshape(k, g * t)
    xe = torch.zeros((n_rows + 1, d), dtype=dtype, device=x.device)
    xe[rows.reshape(-1)] = xg_tp.reshape(g * t, d).to(dtype).repeat(k, 1)
    xe = xe[:n_rows].reshape(g, e_loc, cap, d).transpose(0, 1).reshape(e_loc, g * cap, d)
    ye = _experts(p, xe, dtype).reshape(e_loc, g, cap, d).transpose(0, 1).reshape(n_rows, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])

    # combine: each round's row weighted by the chosen expert's probability
    # cast to ``dtype`` (as the reference casts its combine tensor), summed
    # in f32 and rounded once; a dropped round (or another column's) reads
    # the zero row
    w = torch.gather(r.probs, -1, r.choice.permute(1, 2, 0)).permute(2, 0, 1)  # (k, g, t)
    w = w.reshape(k, g * t, 1).to(dtype).float()
    if split is not None:
        w = layers.copy_to_model(w, tp)
    out = w[0] * ye[rows[0]].float()
    for i in range(1, k):
        out = out + w[i] * ye[rows[i]].float()
    out = out[lead:lead + n_routed]
    if n_routed < n_tok:  # the ragged tail: expert 0, densely, unweighted
        if split == "experts" and tp.col != 0:  # expert 0 lives on column 0
            tail = out.new_zeros((n_tok - n_routed, d))
        else:
            tail = _experts({k_: p[k_][:1] for k_ in ("w_gate", "w_up", "w_down")},
                            tokens_tp[n_routed:].to(dtype)[None], dtype)[0].float()
        out = torch.cat([out, tail])
    if split is not None:
        out = layers.reduce_from_model(out, tp)
    y = out.to(dtype).reshape(bsz, s, d)
    if cfg.shared_expert:
        if tp is None:
            y = y + layers.apply_mlp(p["shared"], x, "swiglu", dtype)
        else:
            y = y + layers.apply_mlp_tp(p["shared"], x, "swiglu", cfg.d_ff, tp, dtype)

    routed = (F.one_hot(r.choice, e) * r.keep[..., None]).amax(0)  # (g, t, E)
    entropy = -torch.sum(r.probs * torch.log(r.probs + 1e-9), dim=-1)  # (g, t)
    if world is None:
        me = r.probs.mean(dim=(0, 1))  # (E,)
        ce = routed.float().mean(dim=(0, 1))
        aux_loss = e * torch.sum(me * ce)
        return y, {"aux_loss": aux_loss, "router_entropy": entropy.mean()}
    # the global batch's me, ce and entropy: sums over every row's routed
    # tokens (``present`` masks the empty places), over the N of the world
    probsum = (r.probs * present[..., None]).sum(dim=(0, 1))
    with torch.no_grad():  # the recompute, which skips the collective, saves the same
        local = torch.cat([probsum, routed.float().sum(dim=(0, 1)),
                           (entropy * present).sum()[None]])
    sums = world.exchanged("aux", lambda: world.world.mesh.all_reduce(local))
    n = g_glob * t
    ce = sums[e:2 * e] / n
    return y, {"aux_loss": e * torch.sum(sums[:e] / n * ce),
               "router_entropy": sums[2 * e] / n,
               "aux_share": e * torch.sum(probsum / n * ce)}
