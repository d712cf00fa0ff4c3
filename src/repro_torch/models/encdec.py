"""Encoder-decoder backbone (whisper-small) of the port: the reference's
`models/encdec.py`, op for op, with a Python loop over per-layer
parameter dicts where the reference scans stacked ones.

The conv/mel frontend is a stub, as in the reference: callers pass
precomputed frame embeddings ``frames`` (B, n_frames, d). The encoder is a
bidirectional self-attention stack; each decoder layer runs causal
self-attention, cross-attention over the encoder memory and the MLP.
Decode keeps the flattened ``(L, B, S, d_kv)`` self-attention cache of
`transformer` plus a static cross-attention cache ``xk``/``xv`` (L, B,
n_frames, d_kv), stored in the cache dtype (bf16 by default, in an f32
model too, as the reference stores it).

Attention over a whole sequence (the encoder's, the decoder's causal
self-attention and its cross-attention in `decode_train`) launches the
hand-written flash kernel on a CUDA tensor (`kernels.flash_attention.mha`,
non-causal for the encoder and the cross-attention). On a CPU tensor, or
with ``impl="ref"``, it takes the reference's jnp route:
`layers.attention_plain` (the causal self-attention above
`transformer.BLOCKWISE_THRESHOLD` tokens `layers.attention_blockwise`).
The decode step is plain PyTorch, as the reference's is plain jnp.

On a model axis (``tp``, a rank's `launch.mesh.Mesh`: the training
forward, `encdec_loss`) a column holds the slices
`train.sharding.param_specs` gives it: each attention's wq / wk / wv (and
their biases) column-sharded and wo row-sharded, the MLP's up projection
column-sharded and its down projection row-sharded, the tables sharded
where the vocabulary divides the axis. Attention takes the decoder LM's
route (`transformer.projections_tp`: local heads where both head counts
divide the axis, else gathered projections; `transformer.attn_out`),
every row-sharded product
ends in one all-reduce with its whole bias added once, and the encoder
memory enters each cross-attention through one `layers.copy_to_model`.
The residual streams and the memory are whole on every column.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers
from repro_torch.models.transformer import (
    BLOCKWISE_THRESHOLD,
    KV_BLOCK,
    attn_out,
    chunked_softmax_xent,
    init_attn,
    lm_logits,
    projections_tp,
)
from repro_torch.utils.treeutil import tree_leaves

Params = dict


def init_encdec(cfg, gen: torch.Generator, device=None, *, param_dtype=None) -> Params:
    """Random encoder-decoder parameters from ``gen``: the reference's tree
    (``enc_layers`` and ``dec_layers`` as lists of per-layer dicts), shapes
    and scales, stored as `transformer.init_lm` stores an LM's."""
    device = resolve_device(device)
    kw = dict(dtype=cfg.dtype if param_dtype is None else param_dtype, device=device)
    enc = [_init_enc_layer(cfg, gen, kw) for _ in range(cfg.encoder_layers)]
    dec = [_init_dec_layer(cfg, gen, kw) for _ in range(cfg.n_layers)]
    return {"embed": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, **kw),
            "enc_layers": enc, "dec_layers": dec, **_init_rest(cfg, gen, kw)}


def _norm(cfg, kw) -> Params:
    return layers.init_norm(cfg.d_model, cfg.norm_kind, device=kw["device"])


def _init_enc_layer(cfg, gen, kw) -> Params:
    return {"norm1": _norm(cfg, kw), "attn": init_attn(cfg, gen, **kw), "norm2": _norm(cfg, kw),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, cfg.mlp_bias, **kw)}


def _init_dec_layer(cfg, gen, kw) -> Params:
    return {"norm1": _norm(cfg, kw), "attn": init_attn(cfg, gen, **kw),
            "norm_x": _norm(cfg, kw), "xattn": init_attn(cfg, gen, **kw),
            "norm2": _norm(cfg, kw),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, cfg.mlp_bias, **kw)}


def _init_rest(cfg, gen, kw) -> Params:
    return {"enc_norm": _norm(cfg, kw), "final_norm": _norm(cfg, kw),
            "lm_head": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, **kw)}


def encdec_units(cfg) -> tuple[str, ...]:
    """The units of the parameters, in order (`train.sharding.units_of`
    names them so): ``embed``, ``enc_layers.i``, ``dec_layers.i``, ``rest``
    (the two final norms and ``lm_head``)."""
    return (("embed",) + tuple(f"enc_layers.{i}" for i in range(cfg.encoder_layers))
            + tuple(f"dec_layers.{i}" for i in range(cfg.n_layers)) + ("rest",))


def init_encdec_unit(cfg, name: str, gen: torch.Generator, device=None, *,
                     param_dtype=None) -> Params:
    """One unit of `encdec_units` drawn alone from ``gen``, as
    `init_encdec` makes it."""
    device = resolve_device(device)
    kw = dict(dtype=cfg.dtype if param_dtype is None else param_dtype, device=device)
    if name == "embed":
        return layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, **kw)
    if name == "rest":
        return _init_rest(cfg, gen, kw)
    return (_init_enc_layer if name.startswith("enc_") else _init_dec_layer)(cfg, gen, kw)


def _check_impl(impl) -> None:
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r} (use 'ref' or None)")


def _recompute(params) -> bool:
    """Whether autograd records a gradient of the params: each layer then
    runs under one `torch.utils.checkpoint` (the reference's
    ``jax.checkpoint`` over its layer scan)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(params))


def _run(fn, recompute: bool, *args):
    return checkpoint(fn, *args, use_reentrant=False) if recompute else fn(*args)


def _qkv(cfg, p, hq, hkv, dtype, tp):
    """q (B, Sq, heads, hd) from ``hq``, k and v from ``hkv``, and whether
    they hold this column's heads (`transformer.projections_tp` on a model
    axis; ``hkv`` None: self-attention, from ``hq``)."""
    if tp is not None:
        return projections_tp(cfg, p, hq, dtype, tp, hkv)
    kv_in = hq if hkv is None else hkv
    b, sq, _ = hq.shape
    sk = kv_in.shape[1]
    hd = cfg.resolved_head_dim
    q = layers.linear(p["wq"], hq, dtype).reshape(b, sq, cfg.n_heads, hd)
    k = layers.linear(p["wk"], kv_in, dtype).reshape(b, sk, cfg.n_kv_heads, hd)
    v = layers.linear(p["wv"], kv_in, dtype).reshape(b, sk, cfg.n_kv_heads, hd)
    return q, k, v, False


def _mlp(cfg, p, h, dtype, tp):
    if tp is None:
        return layers.apply_mlp(p, h, cfg.mlp_kind, dtype)
    return layers.apply_mlp_tp(p, h, cfg.mlp_kind, cfg.d_ff, tp, dtype)


def _mha(cfg, p, hq, hkv, dtype, impl=None, tp=None):
    """Non-causal attention of ``hq`` (B, Sq, d) over ``hkv`` (B, Sk, d;
    None: ``hq`` itself): the encoder's self-attention and the decoder's
    cross-attention."""
    b, sq, _ = hq.shape
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    q, k, v, local = _qkv(cfg, p, hq, hkv, dtype, tp)
    if impl is None and q.is_cuda:
        out = flash_ops.mha(q, k, v, causal=False, scale=scale)
    else:
        zero_mask = torch.zeros((sq, k.shape[1]), dtype=torch.float32, device=q.device)
        out = layers.attention_plain(q, k, v, zero_mask, scale)
    return attn_out(cfg, p, out.reshape(b, sq, -1), local, dtype, tp)


def _enc_layer(cfg, p, x, dtype, impl, tp=None):
    p = layers.unit_params(p)
    h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
    x = x + _mha(cfg, p["attn"], h, None, dtype, impl, tp)
    h2 = layers.apply_norm(p["norm2"], x, cfg.norm_kind, cfg.norm_eps)
    return x + _mlp(cfg, p["mlp"], h2, dtype, tp)


def encode(cfg, params: Params, frames: torch.Tensor | None, *, impl: str | None = None,
           tp=None):
    """frames: (B, n_frames, d) precomputed frontend embeddings -> the
    encoder memory (B, n_frames, d) in ``cfg.dtype``; ``tp``: this
    column's slices on a model axis (module docstring)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the encoder needs frames=(B, n_frames, d_model) "
                         "frame embeddings (the audio frontend is a stub)")
    _check_impl(impl)
    dtype = cfg.dtype
    x = frames.to(dtype)
    s = x.shape[1]
    x = x + layers.sinusoidal_positions(s, cfg.d_model, x.device).to(dtype)[None]
    recompute = _recompute(params)
    for p in params["enc_layers"]:
        x = _run(_enc_layer, recompute, cfg, p, x, dtype, impl, tp)
    return layers.apply_norm(params["enc_norm"], x, cfg.norm_kind, cfg.norm_eps)


def _causal_self_attn(cfg, p, h, pos, dtype, impl=None, tp=None):
    """Causal decoder self-attention -> (out, k_flat, v_flat), so that a
    prefill can fill the cache: the flash kernel on a CUDA tensor, else
    plain attention (streaming-softmax blocks past
    `BLOCKWISE_THRESHOLD`)."""
    b, s, _ = h.shape
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    q, k, v, local = _qkv(cfg, p, h, None, dtype, tp)
    if impl is None and q.is_cuda:
        out = flash_ops.mha(q, k, v, causal=True, scale=scale)
    elif s > BLOCKWISE_THRESHOLD:
        out = layers.attention_blockwise(q, k, v, pos, pos, 0, scale, kv_block=KV_BLOCK)
    else:
        out = layers.attention_plain(q, k, v, layers.causal_window_mask(pos, pos, 0), scale)
    out = attn_out(cfg, p, out.reshape(b, s, -1), local, dtype, tp)
    return out, k.reshape(b, s, -1), v.reshape(b, s, -1)


def _dec_layer(cfg, p, x, memory, pos, dtype, impl, tp=None):
    p = layers.unit_params(p)
    h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
    attn, kf, vf = _causal_self_attn(cfg, p["attn"], h, pos, dtype, impl, tp)
    x = x + attn
    hx = layers.apply_norm(p["norm_x"], x, cfg.norm_kind, cfg.norm_eps)
    x = x + _mha(cfg, p["xattn"], hx, memory, dtype, impl, tp)
    h2 = layers.apply_norm(p["norm2"], x, cfg.norm_kind, cfg.norm_eps)
    return x + _mlp(cfg, p["mlp"], h2, dtype, tp), kf, vf


def decode_train(cfg, params: Params, tokens: torch.Tensor, memory: torch.Tensor,
                 want_kv: bool = False, *, impl: str | None = None, tp=None):
    """Teacher-forced decoder pass -> (hidden (B, S, d) post-final-norm,
    per-layer [(k, v)] in the flattened (B, S, d_kv) layout with
    ``want_kv``, else None); ``tp`` as in `encode` (k and v are then this
    column's heads where it holds its own)."""
    _check_impl(impl)
    dtype = cfg.dtype
    if tp is not None and params["embed"]["table"].shape[0] != cfg.vocab_size:
        x = layers.vocab_embed(params["embed"], tokens, tp, dtype)
    else:
        x = layers.embed(params["embed"], tokens, dtype)
    s = x.shape[1]
    x = x + layers.sinusoidal_positions(s, cfg.d_model, x.device).to(dtype)[None]
    pos = torch.arange(s, device=x.device)
    recompute = _recompute(params)
    kv = []
    for p in params["dec_layers"]:
        x, kf, vf = _run(_dec_layer, recompute, cfg, p, x, memory, pos, dtype, impl, tp)
        if want_kv:
            kv.append((kf, vf))
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return x, (kv if want_kv else None)


def encdec_loss(cfg, params, frames, tokens, labels, mask, *, impl: str | None = None,
                tp=None):
    """The mean masked cross-entropy of the decoder's next-token logits;
    ``tp`` as in `encode` (a vocabulary-sharded ``lm_head`` takes the
    vocabulary-parallel chunk, `transformer.chunked_softmax_xent`)."""
    memory = encode(cfg, params, frames, impl=impl, tp=tp)
    hidden, _ = decode_train(cfg, params, tokens, memory, impl=impl, tp=tp)
    return chunked_softmax_xent(cfg, params, hidden, labels, mask, tp=tp)


# -- decode with caches -----------------------------------------------------------

def init_encdec_cache(cfg, batch: int, max_len: int, n_frames: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """A zeroed cache on ``device`` (cuda unless the caller names another):
    the decoder's self-attention k/v (L, B, max_len, d_kv) and the
    cross-attention xk/xv (L, B, n_frames, d_kv), all in ``dtype``."""
    device = resolve_device(device)
    ln = cfg.n_layers

    def zeros(s):
        return torch.zeros((ln, batch, s, cfg.d_kv), dtype=dtype, device=device)

    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "k": zeros(max_len), "v": zeros(max_len), "xk": zeros(n_frames),
            "xv": zeros(n_frames)}


def prime_cross_cache(cfg, params, memory: torch.Tensor, cache: dict) -> dict:
    """Compute the cross-attention K/V once per request batch, in the
    cache's dtype; the cache's ``xk``/``xv`` are replaced (their frame
    count follows ``memory``)."""
    dtype = cfg.dtype
    b, sk, _ = memory.shape
    xk, xv = [], []
    for p in params["dec_layers"]:
        xk.append(layers.linear(p["xattn"]["wk"], memory, dtype).reshape(b, sk, cfg.d_kv))
        xv.append(layers.linear(p["xattn"]["wv"], memory, dtype).reshape(b, sk, cfg.d_kv))
    cache["xk"] = torch.stack(xk).to(cache["xk"].dtype)
    cache["xv"] = torch.stack(xv).to(cache["xv"].dtype)
    return cache


def decode_step_encdec(cfg, params: Params, cache: dict, token: torch.Tensor):
    """token: (B, 1) int. Returns (logits (B, 1, V), cache), the cache
    updated in place: every slot writes its self-attention K/V at the
    shared cursor ``pos`` (a write past the cache's end lands on its last
    row, as the reference's clamped `dynamic_update_slice` does) and
    attends its prefix, then the whole cross-attention cache."""
    dtype = cfg.dtype
    x = layers.embed(params["embed"], token, dtype)
    b = x.shape[0]
    pos = cache["pos"]
    x = x + layers.sinusoidal_at(pos, cfg.d_model).to(dtype)[None, None]
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    n_frames = cache["xk"].shape[2]
    for li, p in enumerate(params["dec_layers"]):
        h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
        q = layers.linear(p["attn"]["wq"], h, dtype).reshape(b, 1, cfg.n_heads, hd)
        kc, vc = cache["k"][li], cache["v"][li]
        at = min(int(pos), kc.shape[1] - 1)
        kc[:, at] = layers.linear(p["attn"]["wk"], h, dtype).reshape(b, cfg.d_kv).to(kc.dtype)
        vc[:, at] = layers.linear(p["attn"]["wv"], h, dtype).reshape(b, cfg.d_kv).to(vc.dtype)
        attn = layers.attention_decode(q, kc, vc, cfg.n_kv_heads, pos + 1, 0, scale)
        x = x + layers.linear(p["attn"]["wo"], attn.reshape(b, 1, cfg.d_q), dtype)
        hx = layers.apply_norm(p["norm_x"], x, cfg.norm_kind, cfg.norm_eps)
        qx = layers.linear(p["xattn"]["wq"], hx, dtype).reshape(b, 1, cfg.n_heads, hd)
        xattn = layers.attention_decode(qx, cache["xk"][li], cache["xv"][li], cfg.n_kv_heads,
                                        n_frames, 0, scale)
        x = x + layers.linear(p["xattn"]["wo"], xattn.reshape(b, 1, cfg.d_q), dtype)
        h2 = layers.apply_norm(p["norm2"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + layers.apply_mlp(p["mlp"], h2, cfg.mlp_kind, dtype)
    cache["pos"] = pos + 1
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return lm_logits(cfg, params, x), cache
