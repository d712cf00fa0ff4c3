"""Decoder-only LM backbone: the dense and MoE families, the Mamba-2 SSM
family, the hybrid (attention and a Mamba-2 block side by side in every
layer, their outputs averaged) and the VLM (frontend embeddings before
the text: ``extra_embeds``).

The reference scans over stacked layer parameters; the port keeps a list
of per-layer parameter dicts and runs a Python loop (eager PyTorch, no
``jit`` counterpart). Caches keep the reference's layout: ``k``/``v`` are
``(L, B, S, n_kv * head_dim)``, an SSM cache holds ``ssm_state``
``(L, B, H, P, N)`` f32 and ``ssm_conv`` ``(L, B, conv - 1, d_inner +
2N)`` (a hybrid cache holds all four), and ``pos`` is a scalar or
``(B,)`` int32 tensor.

Prefill attention (`_attention_full`) on a CUDA tensor launches the
hand-written flash kernel (`kernels.flash_attention.mha`) at every prompt
length. On a CPU tensor, or with ``impl="ref"``, it takes the reference
model's own jnp route: `layers.attention_plain` up to
`BLOCKWISE_THRESHOLD` tokens and `layers.attention_blockwise` (blocks of
`KV_BLOCK`) above it, so CPU parity with the reference keeps its bf16
rounding of scores and probabilities, and ``impl="ref"`` gives the card
a plain path to hold the kernel path against. An SSM layer's prefill
scan takes the same ``impl`` (`ssm.mamba_block`): the hand-written SSD
kernel on a CUDA tensor, the reference's `ssd_chunked` otherwise (a
hybrid layer runs both, on the same normed input). An MoE layer's
feed-forward is `moe.apply_moe` (plain PyTorch, as the
reference's is plain jnp) wherever a dense layer's is the MLP.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers, moe, ssm
from repro_torch.utils.treeutil import tree_leaves

Params = dict

BLOCKWISE_THRESHOLD = 8192  # the reference streams softmax above this
KV_BLOCK = 1024  # its block there (the reference's REPRO_KV_BLOCK default)
XENT_CHUNK = 256  # positions per chunk of `chunked_softmax_xent`, as in the reference


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attn(cfg, gen: torch.Generator, **kw) -> Params:
    """An attention block's projections (the reference's `_init_attn`):
    biased q/k/v with ``qkv_bias``, a biased output with ``mlp_bias``."""
    d = cfg.d_model
    return {
        "wq": layers.init_linear(gen, d, cfg.d_q, cfg.qkv_bias, **kw),
        "wk": layers.init_linear(gen, d, cfg.d_kv, cfg.qkv_bias, **kw),
        "wv": layers.init_linear(gen, d, cfg.d_kv, cfg.qkv_bias, **kw),
        "wo": layers.init_linear(gen, cfg.d_q, d, cfg.mlp_bias, **kw),
    }


def _init_layer(cfg, gen: torch.Generator, device, dtype) -> Params:
    kw = dict(dtype=dtype, device=device)
    d = cfg.d_model
    p: Params = {"norm1": layers.init_norm(d, cfg.norm_kind, device=device)}
    if cfg.family == "ssm":
        p["mamba"] = ssm.init_mamba_block(gen, cfg, **kw)
        return p
    p["attn"] = init_attn(cfg, gen, **kw)
    if cfg.hybrid:
        p["mamba"] = ssm.init_mamba_block(gen, cfg, **kw)
    p["norm2"] = layers.init_norm(d, cfg.norm_kind, device=device)
    if cfg.n_experts:
        p["moe"] = moe.init_moe(gen, cfg, **kw)
    else:
        p["mlp"] = layers.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, cfg.mlp_bias, **kw)
    return p


def init_lm(cfg, gen: torch.Generator, device=None, *, param_dtype=None) -> Params:
    """Random LM parameters from ``gen``: the reference's shapes and
    scales (N(0,1)/sqrt(fan_in) weights, 0.02 embeddings, unit norms,
    zero biases; an SSM layer's own parameters as `ssm.init_mamba_block`
    makes them). Matmul weights and tables are stored in ``param_dtype``
    (default ``cfg.dtype``, as serving keeps them; training passes
    ``torch.float32``, the reference's master copies, and the forward
    casts them at use), norms and the SSM's own parameters in f32. The
    draws differ from the reference's `jax.random` ones; parity tests
    carry the reference weights over with `utils.convert.params_from_numpy`
    instead. ``device``: cuda unless the caller names another
    (`resolve_device`); ``gen`` must live there."""
    device = resolve_device(device)
    dtype = cfg.dtype if param_dtype is None else param_dtype
    out_layers = [_init_layer(cfg, gen, device, dtype) for _ in range(cfg.n_layers)]
    p = {"embed": _init_embed(cfg, gen, device, dtype), "layers": out_layers}
    p.update(_init_rest(cfg, gen, device, dtype))
    return p


def _init_embed(cfg, gen, device, dtype) -> Params:
    return layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype=dtype, device=device)


def _init_rest(cfg, gen, device, dtype) -> Params:
    p = {"final_norm": layers.init_norm(cfg.d_model, cfg.norm_kind, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _init_embed(cfg, gen, device, dtype)
    return p


def lm_units(cfg) -> tuple[str, ...]:
    """The units of an LM's parameters, in order (`train.sharding.units_of`
    names them so): ``embed``, ``layers.0`` ... ``layers.{L-1}``, ``rest``
    (the final norm and an untied ``lm_head``)."""
    return ("embed",) + tuple(f"layers.{i}" for i in range(cfg.n_layers)) + ("rest",)


def init_lm_unit(cfg, name: str, gen: torch.Generator, device=None, *,
                 param_dtype=None) -> Params:
    """One unit of `lm_units` drawn alone from ``gen``: the tree
    `init_lm` makes for it, with the same shapes, scales and dtypes (the
    draws differ, as ``gen`` is the unit's own)."""
    device = resolve_device(device)
    dtype = cfg.dtype if param_dtype is None else param_dtype
    if name == "embed":
        return _init_embed(cfg, gen, device, dtype)
    if name == "rest":
        return _init_rest(cfg, gen, device, dtype)
    return _init_layer(cfg, gen, device, dtype)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def projections_tp(cfg, p, h, dtype, tp, hkv=None):
    """q, k, v as (B, S, heads, hd) under the model axis, and whether they
    hold this column's heads; k and v are projected from ``hkv`` (a
    cross-attention's memory) where given, else from ``h``. Where both head
    counts divide the axis, each column computes its heads from its column
    slices of wq/wk/wv (the reference pins attention's heads to ``model``);
    otherwise the reference's sharding constraint gives up, and each
    projection whose weight is sharded is computed on the column's slice
    and gathered, a whole weight on the whole input, so every column holds
    every head. Each input enters the sharded products through one
    `layers.copy_to_model`, so its gradient is summed over the columns once."""
    kv_in = h if hkv is None else hkv
    b, s, _ = h.shape
    sk = kv_in.shape[1]
    hd = cfg.resolved_head_dim
    ht = layers.copy_to_model(h, tp)
    kvt = ht if hkv is None else layers.copy_to_model(hkv, tp)
    m = tp.model_size
    local = cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
    out = []
    for k, width, n, x, xt, length in (
            ("wq", cfg.d_q, cfg.n_heads, h, ht, s),
            ("wk", cfg.d_kv, cfg.n_kv_heads, kv_in, kvt, sk),
            ("wv", cfg.d_kv, cfg.n_kv_heads, kv_in, kvt, sk)):
        if local:
            y = layers.linear(p[k], xt, dtype)
            n //= m
        elif p[k]["w"].shape[-1] == width:
            y = layers.linear(p[k], x, dtype)
        else:
            y = layers.gather_from_model(layers.linear(p[k], xt, dtype), tp)
        out.append(y.reshape(b, length, n, hd))
    return (*out, local)


def attn_out(cfg, p, out, local: bool, dtype, tp=None):
    """An attention block's output projection of ``out`` (B, S, heads x hd):
    under the model axis ``tp``, where ``d_q`` divides the axis, wo's rows
    are sharded (this column's heads, or its slice of every head's output,
    into its rows of wo, then one all-reduce); otherwise wo is whole."""
    if tp is None or p["wo"]["w"].shape[0] == cfg.d_q:
        return layers.linear(p["wo"], out, dtype)
    if not local:
        out = layers.split_to_model(out, tp)
    return layers.row_parallel(p["wo"], out, tp, dtype)


def _attention_full(cfg, p, h, positions, window, dtype, impl=None, tp=None):
    """Returns (attn_out, k_flat, v_flat). ``impl``: None launches the
    flash kernel on a CUDA tensor; "ref" (or a CPU tensor) takes the
    reference's plain/blockwise route. ``tp`` (the rank's
    `launch.mesh.Mesh`, the training forward on a model axis):
    `projections_tp`'s heads and `attn_out`'s output projection; k/v are
    then this column's or every head's."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    local = False
    if tp is not None:
        q, k, v, local = projections_tp(cfg, p, h, dtype, tp)
    else:
        q = layers.linear(p["wq"], h, dtype).reshape(b, s, cfg.n_heads, hd)
        k = layers.linear(p["wk"], h, dtype).reshape(b, s, cfg.n_kv_heads, hd)
        v = layers.linear(p["wv"], h, dtype).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.pos_kind == "rope":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    if impl is None and q.is_cuda:
        out = flash_ops.mha(q, k, v, causal=True, window=window, scale=scale)
    elif s > BLOCKWISE_THRESHOLD:
        out = layers.attention_blockwise(q, k, v, positions, positions, window, scale,
                                         kv_block=KV_BLOCK)
    else:
        mask = layers.causal_window_mask(positions, positions, window)
        out = layers.attention_plain(q, k, v, mask, scale)
    out = out.reshape(b, s, -1)
    return attn_out(cfg, p, out, local, dtype, tp), k.reshape(b, s, -1), v.reshape(b, s, -1)


def _ffn(cfg, p, h, dtype, world=None, tp=None):
    """A layer's feed-forward on its normed input -> (out, aux): the MoE
    layer with its aux metrics (routed over ``world``, a
    `moe.LayerWorld`, when given), or the MLP with none; both
    tensor-parallel over ``tp`` (`moe.apply_moe`, `layers.apply_mlp_tp`)."""
    if cfg.n_experts:
        return moe.apply_moe(p["moe"], h, cfg, dtype, world=world, tp=tp)
    if tp is not None:
        return layers.apply_mlp_tp(p["mlp"], h, cfg.mlp_kind, cfg.d_ff, tp, dtype), {}
    return layers.apply_mlp(p["mlp"], h, cfg.mlp_kind, dtype), {}


def _mamba(cfg, p, h, dtype, want_kv: bool, impl, tp=None):
    """A layer's Mamba-2 block on its normed input -> (out, SSM decode
    state after the sequence or None); tensor-parallel over ``tp``
    (`ssm.mamba_block`)."""
    if want_kv:
        return ssm.mamba_block(p["mamba"], h, cfg, dtype, want_state=True, impl=impl, tp=tp)
    return ssm.mamba_block(p["mamba"], h, cfg, dtype, impl=impl, tp=tp), None


def _layer_forward(cfg, p, x, positions, window, dtype, want_kv: bool, impl, world=None,
                   tp=None):
    """One layer -> (x, aux, (k, v) or None, SSM decode state or None)."""
    p = layers.unit_params(p)
    h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
    if cfg.family == "ssm":
        y, sstate = _mamba(cfg, p, h, dtype, want_kv, impl, tp)
        return x + y, {}, None, sstate
    attn_out, kf, vf = _attention_full(cfg, p["attn"], h, positions, window, dtype, impl, tp)
    sstate = None
    if cfg.hybrid:  # both paths read the same h; averaged as they come
        ssm_out, sstate = _mamba(cfg, p, h, dtype, want_kv, impl, tp)
        attn_out = (attn_out + ssm_out) * 0.5
    x = x + attn_out
    h2 = layers.apply_norm(p["norm2"], x, cfg.norm_kind, cfg.norm_eps)
    out, aux = _ffn(cfg, p, h2, dtype, world, tp)
    return x + out, aux, ((kf, vf) if want_kv else None), sstate


def forward_lm(cfg, params: Params, tokens: torch.Tensor, *, extra_embeds=None,
               want_kv: bool = False, impl: str | None = None, route_world=None, tp=None):
    """Returns (hidden (B,S,d) post-final-norm, aux, per-layer [(k, v)]
    or None, per-layer [{state, conv}] or None): aux is the mean over
    layers of each MoE aux metric (``aux_loss``, ``router_entropy``; empty
    for the other families); k/v in the flattened (B, S, d_kv) layout for
    the attention families, the SSM decode state after the sequence for
    the ssm and hybrid families (both only with ``want_kv``).
    ``extra_embeds`` (B, n_frontend_tokens, d) (VLM patch embeddings) are
    prepended to the token embeddings, so S counts them too and positions
    run over both; callers account for the longer sequence.
    ``impl`` as in `_attention_full`, and for the SSD scan. While
    autograd records a gradient of the params, each layer runs under one
    `torch.utils.checkpoint` and is recomputed in the backward pass (the
    reference's ``jax.checkpoint`` over the layer scan), so a layer's
    activations live only while its gradient is taken. ``route_world``
    (`moe.RouteWorld`): ``tokens`` is this row's shard of a world's global
    batch, and every MoE layer routes over the world (aux then also holds
    ``aux_share``, `moe.apply_moe`); the recompute reads the exchanges the
    forward stashed. ``tp`` (the rank's `launch.mesh.Mesh` of a world of
    more than one column): ``params`` are this
    column's slices (`train.sharding.param_specs`), and the forward is the
    reference's under GSPMD on a model axis, by hand: the embedding looked
    up in a vocabulary-sharded table (a whole one where the vocabulary does
    not divide the axis), each layer's attention and MLP tensor-parallel,
    an MoE layer's experts split over the columns (`moe.apply_moe`), a
    Mamba block's projections split (`ssm.mamba_block`); the residual
    stream, and a VLM's patch embeddings, are whole on every column."""
    if cfg.family == "encdec":
        raise ValueError("an encoder-decoder model runs models.encdec, not forward_lm")
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r} (use 'ref' or None)")
    dtype = cfg.dtype
    if tp is not None and params["embed"]["table"].shape[0] != cfg.vocab_size:
        x = layers.vocab_embed(params["embed"], tokens, tp, dtype)
    else:
        x = layers.embed(params["embed"], tokens, dtype)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(dtype), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    if cfg.pos_kind == "sinusoidal":
        x = x + layers.sinusoidal_positions(s, cfg.d_model, x.device).to(dtype)[None]
    kv, states, auxes = [], [], []
    recompute = torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))
    if route_world is not None:
        route_world.start()
    for li, (p, window) in enumerate(zip(params["layers"], cfg.layer_windows())):
        world = None if route_world is None else route_world.at(li)
        if recompute:
            x, aux, kvl, sstate = checkpoint(_layer_forward, cfg, p, x, positions, window,
                                             dtype, want_kv, impl, world, tp,
                                             use_reentrant=False)
        else:
            x, aux, kvl, sstate = _layer_forward(cfg, p, x, positions, window, dtype,
                                                 want_kv, impl, world, tp)
        auxes.append(aux)
        if kvl is not None:
            kv.append(kvl)
        if sstate is not None:
            states.append(sstate)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]} if auxes else {}
    return x, aux, (kv or None), (states or None)


def unembed_table(cfg, params: Params) -> torch.Tensor:
    return params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]["table"]


def lm_logits(cfg, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    return layers.unembed({"table": unembed_table(cfg, params)}, hidden, cfg.dtype)


def _xent_chunk(h, labels, mask, table):
    """Summed NLL and token count of one chunk: f32 logits from the
    ``cfg.dtype`` product, as the reference's scan body computes them."""
    logits = torch.einsum("btd,vd->btv", h, table).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((lse - gold) * mask).sum(), mask.sum()


def _xent_chunk_tp(h, labels, mask, table, tp):
    """`_xent_chunk` over a vocabulary-sharded table: this column's logits,
    their max over the columns (a MAX all-reduce, outside the gradient),
    the sum of exponentials and the gold logit, each all-reduced from the
    columns' parts (the gold logit's from its owner). No column holds a
    chunk's whole (B, T, V) logits."""
    logits = torch.einsum("btd,vd->btv", layers.copy_to_model(h, tp), table).float()
    rows = table.shape[0]
    m = tp.model_all_reduce(logits.detach().amax(dim=-1), dist.ReduceOp.MAX)
    sumexp = layers.reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1), tp)
    local = labels.long() - tp.col * rows
    ok = (local >= 0) & (local < rows)
    gold = torch.gather(logits, -1, torch.where(ok, local, 0)[..., None])[..., 0]
    gold = layers.reduce_from_model(torch.where(ok, gold, 0.0), tp)
    return ((m + torch.log(sumexp) - gold) * mask).sum(), mask.sum()


def chunked_softmax_xent(cfg, params: Params, hidden: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, tp=None) -> torch.Tensor:
    """Mean cross-entropy over ``mask`` without the whole (B, S, V)
    logits: positions go in chunks of `XENT_CHUNK`, each under one
    `torch.utils.checkpoint` while autograd records (the reference's
    ``jax.checkpoint`` scan body), so only one chunk's logits are alive
    at a time, in the backward pass too. The table is cast to
    ``cfg.dtype`` once rather than once per chunk (the same values).
    ``tp`` (as in `forward_lm`): a vocabulary-sharded table takes the
    vocabulary-parallel chunk (`_xent_chunk_tp`); a whole one, the plain
    chunk on every column."""
    table = unembed_table(cfg, params).to(cfg.dtype)
    b, s, _ = hidden.shape
    h = hidden.to(cfg.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    recompute = torch.is_grad_enabled() and (h.requires_grad or table.requires_grad)
    chunk, extra = _xent_chunk, ()
    if tp is not None and table.shape[0] != cfg.vocab_size:
        chunk, extra = _xent_chunk_tp, (tp,)
    for start in range(0, s, XENT_CHUNK):
        end = start + XENT_CHUNK
        part = (h[:, start:end], labels[:, start:end], mask[:, start:end], table) + extra
        if recompute:
            nll, m = checkpoint(chunk, *part, use_reentrant=False)
        else:
            nll, m = chunk(*part)
        tot, cnt = tot + nll, cnt + m
    return tot / torch.clamp_min(cnt, 1.0)


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
    """A zeroed cache on ``device`` (cuda unless the caller names
    another; `resolve_device`): k/v in ``dtype`` for the attention
    families; for the ssm and hybrid families the f32 recurrent state and
    the conv window in ``dtype``."""
    device = resolve_device(device)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    ln = cfg.n_layers
    if cfg.family != "ssm":
        shape = (ln, batch, max_len, cfg.d_kv)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.family == "ssm" or cfg.hybrid:
        h, hd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        conv_ch = cfg.d_inner + 2 * n
        cache["ssm_state"] = torch.zeros((ln, batch, h, hd, n), dtype=torch.float32,
                                         device=device)
        cache["ssm_conv"] = torch.zeros((ln, batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                                        device=device)
    return cache


def prefill_lm(cfg, params: Params, tokens: torch.Tensor, cache: dict, *, extra_embeds=None,
               length=None, impl: str | None = None):
    """Run the full-sequence forward, fill the cache, return the
    last-token logits (B, 1, V) and the cache.

    ``length`` (int or 0-d tensor) marks the true prompt length of a
    right-padded ``tokens`` buffer: logits come from position length-1
    and KV at or past ``length`` is zeroed. A ``(B,)`` tensor ``length``
    packs independently ragged prompts (continuous-batching admission),
    each masked at and read from its own length, with ``cache["pos"]``
    left as the (B,) vector. An SSM or hybrid cache takes no ``length``
    (its recurrent state would have consumed the padding): the SSM state
    after the sequence comes from the chunked scan's final state.
    ``extra_embeds`` (VLM patches) go before the tokens (`forward_lm`):
    the cache then holds tokens + frontend positions, and takes no
    ``length``. The cache is written in place (the reference rebinds
    it). ``impl`` as in `_attention_full`.
    """
    if length is not None and extra_embeds is not None:
        raise ValueError("length-masked prefill does not support extra_embeds")
    if length is not None and (cfg.family == "ssm" or cfg.hybrid):
        raise ValueError("length-masked prefill needs an attention-only cache")
    hidden, _, kv, states = forward_lm(cfg, params, tokens, extra_embeds=extra_embeds,
                                       want_kv=True, impl=impl)
    b, s = hidden.shape[:2]
    ragged = torch.is_tensor(length) and length.ndim == 1
    ar = torch.arange(s, device=hidden.device)
    if ragged:
        keep = (ar[None, :] < length.to(hidden.device)[:, None])[:, :, None]
    elif length is not None:
        keep = (ar < int(length))[None, :, None]
    for li, (kf, vf) in enumerate(kv or ()):
        if length is not None:
            kf = torch.where(keep, kf, 0)
            vf = torch.where(keep, vf, 0)
        cache["k"][li, :, :s] = kf.to(cache["k"].dtype)
        cache["v"][li, :, :s] = vf.to(cache["v"].dtype)
    for li, st in enumerate(states or ()):
        cache["ssm_state"][li] = st["state"].to(cache["ssm_state"].dtype)
        cache["ssm_conv"][li] = st["conv"].to(cache["ssm_conv"].dtype)
    if length is None:
        cache["pos"] = torch.full((), s, dtype=torch.int32, device=hidden.device)
        last = hidden[:, -1:]
    elif ragged:
        lens = length.to(device=hidden.device, dtype=torch.int32)
        cache["pos"] = lens
        idx = (lens.long() - 1).clamp(min=0)
        last = hidden[torch.arange(b, device=hidden.device), idx][:, None]
    else:
        n = int(length)
        cache["pos"] = torch.full((), n, dtype=torch.int32, device=hidden.device)
        at = max(n - 1, 0)  # length 0 reads position 0, as the reference's clamped slice
        last = hidden[:, at : at + 1]
    return lm_logits(cfg, params, last), cache


def decode_step_lm(cfg, params: Params, cache: dict, token: torch.Tensor):
    """token: (B, 1) int. Returns (logits (B,1,V), cache), the cache
    updated in place.

    ``cache["pos"]`` is a scalar (the aligned engine's shared cursor:
    every slot writes and attends at the same position; a write past the
    cache's end lands on its last row, as the reference's clamped
    `dynamic_update_slice` does) or, for the dense family only, a (B,)
    vector of per-slot cursors (each slot writes its token at its own
    length, and a cursor at or past the cache length writes nothing). An
    SSM layer advances its recurrent state and conv window
    (`ssm.mamba_decode`); a hybrid layer advances both its K/V and them,
    and averages the two paths' outputs as its prefill does.
    """
    dtype = cfg.dtype
    x = layers.embed(params["embed"], token, dtype)  # (B,1,d)
    pos = cache["pos"]
    ragged = pos.ndim == 1
    if ragged and (cfg.family == "ssm" or cfg.hybrid):
        raise ValueError("ragged decode needs an attention-only cache")
    if cfg.pos_kind == "sinusoidal":
        emb = layers.sinusoidal_at(pos, cfg.d_model).to(dtype)
        x = x + (emb[:, None] if ragged else emb[None, None])
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd) if hd else 1.0
    def mamba_step(li, p, h):
        y, mc = ssm.mamba_decode(
            p["mamba"], h, {"state": cache["ssm_state"][li], "conv": cache["ssm_conv"][li]},
            cfg, dtype)
        cache["ssm_state"][li] = mc["state"]
        cache["ssm_conv"][li] = mc["conv"]
        return y

    for li, (p, window) in enumerate(zip(params["layers"], cfg.layer_windows())):
        h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
        if cfg.family == "ssm":
            x = x + mamba_step(li, p, h)
            continue
        q = layers.linear(p["attn"]["wq"], h, dtype).reshape(b, 1, cfg.n_heads, hd)
        kn = layers.linear(p["attn"]["wk"], h, dtype).reshape(b, 1, cfg.n_kv_heads, hd)
        vn = layers.linear(p["attn"]["wv"], h, dtype)
        if cfg.pos_kind == "rope":
            pos_arr = pos[:, None] if ragged else pos.reshape(1)
            q = layers.apply_rope(q, pos_arr, cfg.rope_theta)
            kn = layers.apply_rope(kn, pos_arr, cfg.rope_theta)
        kc, vc = cache["k"][li], cache["v"][li]
        kn = kn.reshape(b, cfg.d_kv).to(kc.dtype)
        vn = vn.reshape(b, cfg.d_kv).to(vc.dtype)
        s_max = kc.shape[1]
        if ragged:
            live = torch.nonzero(pos < s_max)[:, 0]
            at = pos[live].long()
            kc[live, at] = kn[live]
            vc[live, at] = vn[live]
        else:
            at = min(int(pos), s_max - 1)
            kc[:, at] = kn
            vc[:, at] = vn
        attn = layers.attention_decode(q, kc, vc, cfg.n_kv_heads, pos + 1, window, scale)
        attn = layers.linear(p["attn"]["wo"], attn.reshape(b, 1, cfg.d_q), dtype)
        if cfg.hybrid:
            attn = (attn + mamba_step(li, p, h)) * 0.5
        x = x + attn
        h2 = layers.apply_norm(p["norm2"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + _ffn(cfg, p, h2, dtype)[0]
    cache["pos"] = pos + 1
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return lm_logits(cfg, params, x), cache


def verify_step_lm(cfg, params: Params, cache: dict, tokens: torch.Tensor,
                   n_new: torch.Tensor):
    """Score a whole speculative chunk in one batched forward.

    ``tokens`` (B, S) int is each slot's chunk: its pending token followed
    by the draft block. ``cache["pos"]`` must be the ragged (B,) cursor
    vector, and ``n_new`` (B,) says how many chunk positions each slot
    really carries: chunk position ``j`` of slot ``i`` lands at ``pos[i] +
    j`` when ``j < n_new[i]`` (and that row is inside the cache), and
    nowhere otherwise. The cache is written in place, as `decode_step_lm`
    writes it; ``pos`` advances by ``n_new``. Returns ``(logits (B, S, V),
    cache)``. Each position attends the prefix the sequential decode step
    would see (`layers.attention_verify`), so the logits equal k + 1
    sequential `decode_step_lm` calls up to summation order.
    Attention-only families, like the paged decode.
    """
    if cfg.family == "ssm" or cfg.hybrid:
        raise ValueError("verify step needs an attention-only cache")
    pos = cache["pos"]
    if pos.ndim != 1:
        raise ValueError("verify step is ragged-only: cache['pos'] must be (B,)")
    dtype = cfg.dtype
    b, s_chunk = tokens.shape
    x = layers.embed(params["embed"], tokens, dtype)  # (B, S, d)
    offs = torch.arange(s_chunk, dtype=torch.int32, device=x.device)
    chunk_pos = pos[:, None].to(torch.int32) + offs[None, :]  # (B, S)
    n_new = torch.as_tensor(n_new, device=x.device)
    s_cache = cache["k"].shape[2]
    write = (offs[None, :] < n_new[:, None]) & (chunk_pos < s_cache)
    rows, cols = torch.nonzero(write, as_tuple=True)
    at = chunk_pos[rows, cols].long()
    if cfg.pos_kind == "sinusoidal":
        x = x + layers.sinusoidal_at(chunk_pos, cfg.d_model).to(dtype)
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    for li, (p, window) in enumerate(zip(params["layers"], cfg.layer_windows())):
        h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
        q = layers.linear(p["attn"]["wq"], h, dtype).reshape(b, s_chunk, cfg.n_heads, hd)
        kn = layers.linear(p["attn"]["wk"], h, dtype).reshape(b, s_chunk, cfg.n_kv_heads, hd)
        vn = layers.linear(p["attn"]["wv"], h, dtype)
        if cfg.pos_kind == "rope":
            q = layers.apply_rope(q, chunk_pos, cfg.rope_theta)
            kn = layers.apply_rope(kn, chunk_pos, cfg.rope_theta)
        kc, vc = cache["k"][li], cache["v"][li]
        kc[rows, at] = kn.reshape(b, s_chunk, cfg.d_kv)[rows, cols].to(kc.dtype)
        vc[rows, at] = vn.reshape(b, s_chunk, cfg.d_kv)[rows, cols].to(vc.dtype)
        attn = layers.attention_verify(q, kc, vc, cfg.n_kv_heads, chunk_pos + 1, window,
                                       scale)
        attn = layers.linear(p["attn"]["wo"], attn.reshape(b, s_chunk, cfg.d_q), dtype)
        x = x + attn
        h2 = layers.apply_norm(p["norm2"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + _ffn(cfg, p, h2, dtype)[0]
    cache["pos"] = pos + n_new.to(pos.dtype)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return lm_logits(cfg, params, x), cache


def decode_step_paged_lm(cfg, params: Params, pview: dict, token: torch.Tensor,
                         *, impl: str | None = None):
    """Paged-kernel decode step: attention reads the KV block pool
    directly through the block tables.

    ``pview`` is a KV store's `kernel_view`: ``k_pool``/``v_pool``
    ``(L, nb, bs, d_kv)``, ``tables`` ``(B, mb)`` int32, ``pos`` ``(B,)``
    int32 cursors, optional ``k_scale``/``v_scale`` int8 sidecars, and
    ``rows_like`` (a zero-length dtype exemplar) naming the dtype of the
    returned K/V rows. Returns ``(logits (B,1,V), rows_k (L,B,d_kv),
    rows_v)``; the store scatters the rows with `absorb_rows`. ``impl``
    forwards to `paged_ops.paged_decode_attention` (None: the kernel on
    a CUDA tensor, the plain version on a CPU tensor). Attention-only
    decoder LMs (`model_zoo` leaves `decode_step_paged` unset for the
    ssm, hybrid and encoder-decoder families).
    """
    if cfg.family in ("ssm", "encdec") or cfg.hybrid:
        raise ValueError("paged decode needs an attention-only cache")
    dtype = cfg.dtype
    x = layers.embed(params["embed"], token, dtype)  # (B,1,d)
    pos = pview["pos"]
    tables = pview["tables"]
    if pos.ndim != 1:
        raise ValueError("paged decode is ragged-only: pos must be (B,)")
    if cfg.pos_kind == "sinusoidal":
        x = x + layers.sinusoidal_at(pos, cfg.d_model).to(dtype)[:, None]
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    k_pool, v_pool = pview["k_pool"], pview["v_pool"]
    row_dtype = pview.get("rows_like", k_pool).dtype
    quantized = k_pool.dtype == torch.int8
    rows_k = torch.empty((cfg.n_layers, b, cfg.d_kv), dtype=row_dtype, device=x.device)
    rows_v = torch.empty_like(rows_k)
    pos_arr = pos[:, None]
    for li, (p, window) in enumerate(zip(params["layers"], cfg.layer_windows())):
        h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
        q = layers.linear(p["attn"]["wq"], h, dtype).reshape(b, 1, cfg.n_heads, hd)
        kn = layers.linear(p["attn"]["wk"], h, dtype).reshape(b, 1, cfg.n_kv_heads, hd)
        vn = layers.linear(p["attn"]["wv"], h, dtype)
        if cfg.pos_kind == "rope":
            q = layers.apply_rope(q, pos_arr, cfg.rope_theta)
            kn = layers.apply_rope(kn, pos_arr, cfg.rope_theta)
        kn = kn.reshape(b, cfg.d_kv)
        vn = vn.reshape(b, cfg.d_kv)
        attn = paged_ops.paged_decode_attention(
            q, kn, vn, k_pool[li], v_pool[li], tables, pos,
            n_kv=cfg.n_kv_heads, window=window, scale=scale,
            k_scale=pview["k_scale"][li] if quantized else None,
            v_scale=pview["v_scale"][li] if quantized else None,
            dequant_dtype=row_dtype, impl=impl,
        )
        attn = layers.linear(p["attn"]["wo"], attn.reshape(b, 1, cfg.d_q), dtype)
        x = x + attn
        h2 = layers.apply_norm(p["norm2"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + _ffn(cfg, p, h2, dtype)[0]
        rows_k[li] = kn
        rows_v[li] = vn
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return lm_logits(cfg, params, x), rows_k, rows_v
