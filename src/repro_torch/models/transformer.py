"""Decoder-only LM backbone: the dense family and the Mamba-2 SSM family.

The reference scans over stacked layer parameters; the port keeps a list
of per-layer parameter dicts and runs a Python loop (eager PyTorch, no
``jit`` counterpart). Caches keep the reference's layout: ``k``/``v`` are
``(L, B, S, n_kv * head_dim)``, an SSM cache holds ``ssm_state``
``(L, B, H, P, N)`` f32 and ``ssm_conv`` ``(L, B, conv - 1, d_inner +
2N)``, and ``pos`` is a scalar or ``(B,)`` int32 tensor.

Prefill attention (`_attention_full`) on a CUDA tensor launches the
hand-written flash kernel (`kernels.flash_attention.mha`) at every prompt
length. On a CPU tensor, or with ``impl="ref"``, it takes the reference
model's own jnp route: `layers.attention_plain` up to
`BLOCKWISE_THRESHOLD` tokens and `layers.attention_blockwise` (blocks of
`KV_BLOCK`) above it, so CPU parity with the reference keeps its bf16
rounding of scores and probabilities, and ``impl="ref"`` gives the card
a plain path to hold the kernel path against. An SSM layer's prefill
scan takes the same ``impl`` (`ssm.mamba_block`): the hand-written SSD
kernel on a CUDA tensor, the reference's `ssd_chunked` otherwise.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers, ssm
from repro_torch.utils.treeutil import tree_leaves

Params = dict

BLOCKWISE_THRESHOLD = 8192  # the reference streams softmax above this
KV_BLOCK = 1024  # its block there (the reference's REPRO_KV_BLOCK default)
XENT_CHUNK = 256  # positions per chunk of `chunked_softmax_xent`, as in the reference


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(cfg, gen: torch.Generator, device, dtype) -> Params:
    kw = dict(dtype=dtype, device=device)
    d = cfg.d_model
    p: Params = {"norm1": layers.init_norm(d, cfg.norm_kind, device=device)}
    if cfg.family == "ssm":
        p["mamba"] = ssm.init_mamba_block(gen, cfg, **kw)
        return p
    p["attn"] = {
        "wq": layers.init_linear(gen, d, cfg.d_q, cfg.qkv_bias, **kw),
        "wk": layers.init_linear(gen, d, cfg.d_kv, cfg.qkv_bias, **kw),
        "wv": layers.init_linear(gen, d, cfg.d_kv, cfg.qkv_bias, **kw),
        "wo": layers.init_linear(gen, cfg.d_q, d, cfg.mlp_bias, **kw),
    }
    p["norm2"] = layers.init_norm(d, cfg.norm_kind, device=device)
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
    d = cfg.d_model
    out_layers = [_init_layer(cfg, gen, device, dtype) for _ in range(cfg.n_layers)]
    p = {
        "embed": layers.init_embedding(gen, cfg.vocab_size, d, dtype=dtype, device=device),
        "layers": out_layers,
        "final_norm": layers.init_norm(d, cfg.norm_kind, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.init_embedding(gen, cfg.vocab_size, d, dtype=dtype,
                                             device=device)
    return p


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _attention_full(cfg, p, h, positions, window, dtype, impl=None):
    """Returns (attn_out, k_flat, v_flat). ``impl``: None launches the
    flash kernel on a CUDA tensor; "ref" (or a CPU tensor) takes the
    reference's plain/blockwise route."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
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
    out = layers.linear(p["wo"], out.reshape(b, s, cfg.d_q), dtype)
    return out, k.reshape(b, s, cfg.d_kv), v.reshape(b, s, cfg.d_kv)


def _layer_forward(cfg, p, x, positions, window, dtype, want_kv: bool, impl):
    """One layer -> (x, (k, v) or None, SSM decode state or None)."""
    h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
    if cfg.family == "ssm":
        if want_kv:
            y, sstate = ssm.mamba_block(p["mamba"], h, cfg, dtype, want_state=True, impl=impl)
            return x + y, None, sstate
        return x + ssm.mamba_block(p["mamba"], h, cfg, dtype, impl=impl), None, None
    attn_out, kf, vf = _attention_full(cfg, p["attn"], h, positions, window, dtype, impl)
    x = x + attn_out
    h2 = layers.apply_norm(p["norm2"], x, cfg.norm_kind, cfg.norm_eps)
    x = x + layers.apply_mlp(p["mlp"], h2, cfg.mlp_kind, dtype)
    return x, ((kf, vf) if want_kv else None), None


def forward_lm(cfg, params: Params, tokens: torch.Tensor, *, want_kv: bool = False,
               impl: str | None = None):
    """Returns (hidden (B,S,d) post-final-norm, per-layer [(k, v)] or
    None, per-layer [{state, conv}] or None): k/v in the flattened
    (B, S, d_kv) layout for the dense family, the SSM decode state after
    the sequence for the ssm family (both only with ``want_kv``).
    ``impl`` as in `_attention_full`, and for the SSD scan. While
    autograd records a gradient of the params, each layer runs under one
    `torch.utils.checkpoint` and is recomputed in the backward pass (the
    reference's ``jax.checkpoint`` over the layer scan), so a layer's
    activations live only while its gradient is taken."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(f"forward_lm ports the dense and ssm families, "
                                  f"not {cfg.family!r}")
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r} (use 'ref' or None)")
    dtype = cfg.dtype
    x = layers.embed(params["embed"], tokens, dtype)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    if cfg.pos_kind == "sinusoidal":
        x = x + layers.sinusoidal_positions(s, cfg.d_model, x.device).to(dtype)[None]
    kv, states = [], []
    recompute = torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))
    for p, window in zip(params["layers"], cfg.layer_windows()):
        if recompute:
            x, kvl, sstate = checkpoint(_layer_forward, cfg, p, x, positions, window, dtype,
                                        want_kv, impl, use_reentrant=False)
        else:
            x, kvl, sstate = _layer_forward(cfg, p, x, positions, window, dtype, want_kv, impl)
        if kvl is not None:
            kv.append(kvl)
        if sstate is not None:
            states.append(sstate)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return x, (kv or None), (states or None)


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


def chunked_softmax_xent(cfg, params: Params, hidden: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over ``mask`` without the whole (B, S, V)
    logits: positions go in chunks of `XENT_CHUNK`, each under one
    `torch.utils.checkpoint` while autograd records (the reference's
    ``jax.checkpoint`` scan body), so only one chunk's logits are alive
    at a time, in the backward pass too. The table is cast to
    ``cfg.dtype`` once rather than once per chunk (the same values)."""
    table = unembed_table(cfg, params).to(cfg.dtype)
    b, s, _ = hidden.shape
    h = hidden.to(cfg.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    recompute = torch.is_grad_enabled() and (h.requires_grad or table.requires_grad)
    for start in range(0, s, XENT_CHUNK):
        end = start + XENT_CHUNK
        part = (h[:, start:end], labels[:, start:end], mask[:, start:end], table)
        if recompute:
            nll, m = checkpoint(_xent_chunk, *part, use_reentrant=False)
        else:
            nll, m = _xent_chunk(*part)
        tot, cnt = tot + nll, cnt + m
    return tot / torch.clamp_min(cnt, 1.0)


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
    """A zeroed cache on ``device`` (cuda unless the caller names
    another; `resolve_device`): k/v in ``dtype`` for the dense family;
    for the ssm family the f32 recurrent state and the conv window in
    ``dtype``."""
    device = resolve_device(device)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    ln = cfg.n_layers
    if cfg.family != "ssm":
        shape = (ln, batch, max_len, cfg.d_kv)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    else:
        h, hd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        conv_ch = cfg.d_inner + 2 * n
        cache["ssm_state"] = torch.zeros((ln, batch, h, hd, n), dtype=torch.float32,
                                         device=device)
        cache["ssm_conv"] = torch.zeros((ln, batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                                        device=device)
    return cache


def prefill_lm(cfg, params: Params, tokens: torch.Tensor, cache: dict, *, length=None,
               impl: str | None = None):
    """Run the full-sequence forward, fill the cache, return the
    last-token logits (B, 1, V) and the cache.

    ``length`` (int or 0-d tensor) marks the true prompt length of a
    right-padded ``tokens`` buffer: logits come from position length-1
    and KV at or past ``length`` is zeroed. A ``(B,)`` tensor ``length``
    packs independently ragged prompts (continuous-batching admission),
    each masked at and read from its own length, with ``cache["pos"]``
    left as the (B,) vector. An SSM cache takes no ``length`` (its
    recurrent state would have consumed the padding): the SSM state
    after the sequence comes from the chunked scan's final state. The
    cache is written in place (the reference rebinds it). ``impl`` as in
    `_attention_full`.
    """
    if length is not None and cfg.family == "ssm":
        raise ValueError("length-masked prefill needs an attention-only cache")
    hidden, kv, states = forward_lm(cfg, params, tokens, want_kv=True, impl=impl)
    b, s = tokens.shape
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
        last = hidden[:, n - 1 : n]
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
    (`ssm.mamba_decode`).
    """
    dtype = cfg.dtype
    x = layers.embed(params["embed"], token, dtype)  # (B,1,d)
    pos = cache["pos"]
    ragged = pos.ndim == 1
    if ragged and cfg.family == "ssm":
        raise ValueError("ragged decode needs an attention-only cache")
    if cfg.pos_kind == "sinusoidal":
        emb = layers.sinusoidal_at(pos, cfg.d_model).to(dtype)
        x = x + (emb[:, None] if ragged else emb[None, None])
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd) if hd else 1.0
    for li, (p, window) in enumerate(zip(params["layers"], cfg.layer_windows())):
        h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
        if cfg.family == "ssm":
            y, mc = ssm.mamba_decode(
                p["mamba"], h, {"state": cache["ssm_state"][li], "conv": cache["ssm_conv"][li]},
                cfg, dtype)
            x = x + y
            cache["ssm_state"][li] = mc["state"]
            cache["ssm_conv"][li] = mc["conv"]
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
        x = x + attn
        h2 = layers.apply_norm(p["norm2"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + layers.apply_mlp(p["mlp"], h2, cfg.mlp_kind, dtype)
    cache["pos"] = pos + 1
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
    a CUDA tensor, the plain version on a CPU tensor).
    """
    if cfg.family != "dense":
        raise NotImplementedError(f"paged decode ports the dense family, not {cfg.family!r}")
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
        x = x + layers.apply_mlp(p["mlp"], h2, cfg.mlp_kind, dtype)
        rows_k[li] = kn
        rows_v[li] = vn
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return lm_logits(cfg, params, x), rows_k, rows_v
