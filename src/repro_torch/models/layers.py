"""Shared neural-net layers of every model family (the reference's
`models/layers.py`, whole).

Plain functions on tensors, with the JAX package's layouts at every
public function: `linear` weights are ``(d_in, d_out)``, attention
tensors are ``(B, S, H, hd)``, and decode KV caches keep the flattened
``(B, S, n_kv * hd)`` layout.

Parameters are nested dicts of tensors. Matmul weights, biases and
embedding tables are stored once in the compute dtype (the reference
keeps f32 masters and casts them on every call, which gives the same
bits); norm scales and biases stay f32.

Tensor parallelism over the model axis (``tp``: the rank's
`launch.mesh.Mesh` of a (data, model) world, whose `model_all_reduce` and
`model_all_gather` go over the row's columns; the reference's GSPMD
placement, done by hand): `copy_to_model` (identity forward,
all-reduce backward) goes before a column-sharded product,
`reduce_from_model` (all-reduce forward, identity backward) after a
row-sharded one, `gather_from_model` / `split_to_model` move an
activation between a column's slice and the whole, and
`vocab_embed` looks tokens up in a vocabulary-sharded table (rows outside
this column's range give zeros, then an all-reduce). Each is an explicit
`torch.autograd.Function`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

Params = dict

NEG_INF = -1e30


# -- initializers ----------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               *, device=None) -> torch.Tensor:
    """N(0, 1) * scale in f32, scale 1/sqrt(fan_in) by default (the
    reference's `layers._dense_init` shapes and scales)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale


def init_linear(gen, d_in: int, d_out: int, bias: bool = False, *,
                dtype=torch.bfloat16, device=None) -> Params:
    p = {"w": dense_init(gen, (d_in, d_out), device=device).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_norm(d: int, kind: str, *, device=None) -> Params:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def init_mlp(gen, d_model: int, d_ff: int, kind: str, bias: bool = False, *,
             dtype=torch.bfloat16, device=None) -> Params:
    kw = dict(dtype=dtype, device=device)
    if kind == "swiglu":
        return {
            "w_gate": init_linear(gen, d_model, d_ff, bias, **kw),
            "w_up": init_linear(gen, d_model, d_ff, bias, **kw),
            "w_down": init_linear(gen, d_ff, d_model, bias, **kw),
        }
    if kind == "gelu":
        return {
            "w_up": init_linear(gen, d_model, d_ff, bias, **kw),
            "w_down": init_linear(gen, d_ff, d_model, bias, **kw),
        }
    raise ValueError(kind)


def init_embedding(gen, vocab: int, d_model: int, *, dtype=torch.bfloat16,
                   device=None) -> Params:
    return {"table": dense_init(gen, (vocab, d_model), 0.02, device=device).to(dtype)}


# -- linear / norms ----------------------------------------------------------------

def linear(p: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    y = torch.matmul(x.to(dtype), p["w"].to(dtype))
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-5) -> torch.Tensor:
    """rms or ln, computed in f32 and cast back to ``x``'s dtype."""
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    elif kind == "ln":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y.to(x.dtype)


# -- rotary embeddings ----------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half (not interleaved) rotary embedding.
    x: (..., seq, n_heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ------------------------------------------------------------------------

def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """(q, k) additive f32 mask: causal + optional sliding window
    (window <= 0 means full causal)."""
    dist = q_pos[:, None] - k_pos[None, :]
    ok = dist >= 0
    if window > 0:
        ok = ok & (dist < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def chunked_local_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, chunk: int) -> torch.Tensor:
    """(q, k) additive f32 mask of llama4-style chunked local attention:
    causal within the same chunk of ``chunk`` positions. As in the
    reference, no model path calls it: `ArchConfig.layer_windows` masks a
    chunked-local layer as a sliding window of the chunk size."""
    same = torch.div(q_pos[:, None], chunk, rounding_mode="floor") == torch.div(
        k_pos[None, :], chunk, rounding_mode="floor")
    ok = same & (q_pos[:, None] >= k_pos[None, :])
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def _expand_kv(k: torch.Tensor, n_heads: int, n_kv: int) -> torch.Tensor:
    """(B,S,n_kv,hd) -> (B,S,n_heads,hd) by group repetition (GQA):
    head idx = kv_idx * g + group_idx."""
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


def attention_plain(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Kv, hd)
    v: torch.Tensor,  # (B, Sk, Kv, hd)
    mask: torch.Tensor,  # (Sq, Sk) additive
    softmax_scale: float,
) -> torch.Tensor:
    n_heads, n_kv = q.shape[2], k.shape[2]
    k = _expand_kv(k, n_heads, n_kv)
    v = _expand_kv(v, n_heads, n_kv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits * softmax_scale + mask[None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_blockwise(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Kv, hd)
    v: torch.Tensor,  # (B, Sk, Kv, hd)
    q_positions: torch.Tensor,  # (Sq,)
    k_positions: torch.Tensor,  # (Sk,)
    window: int,
    softmax_scale: float,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Streaming softmax over KV blocks of ``kv_block``: O(Sq * kv_block)
    scores at a time instead of O(Sq * Sk). The reference's op sequence:
    K/V padded to whole blocks with K positions at -1e9, f32 (m, l, acc)
    state, probabilities cast to q's dtype before the P·V einsum. As in
    the reference, padded positions pass the mask when ``window <= 0``
    (zero K, zero V: they add to the softmax denominator only), so the
    result matches `attention_plain` only when ``kv_block`` divides Sk or
    a window masks the padding."""
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    k = _expand_kv(k, h, n_kv)
    v = _expand_kv(v, h, n_kv)
    nblk = -(-sk // kv_block)
    pad = nblk * kv_block - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.cat([k_positions, k_positions.new_full((pad,), -(10**9))])
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k[:, blk]).float()
        logits = logits * softmax_scale + causal_window_mask(
            q_positions, k_positions[blk], window)[None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), v[:, blk]).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, H, hd)


def attention_decode(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, Kv*hd) flattened layout
    v_cache: torch.Tensor,
    n_kv: int,
    valid_len: torch.Tensor,  # (B,) or scalar
    window: int,
    softmax_scale: float,
) -> torch.Tensor:
    """Single-token decode against a flattened KV cache; GQA groups the
    query as (B, n_kv, g, hd) so the cache is never repeated. Mixed
    dtypes (f32 query, bf16 cache) promote as in the reference."""
    b, _, h, hd = q.shape
    s = k_cache.shape[1]
    g = h // n_kv
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    qg = q[:, 0].reshape(b, n_kv, g, hd).to(ct)
    kc = k_cache.reshape(b, s, n_kv, hd).to(ct)
    vc = v_cache.reshape(b, s, n_kv, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, kc).float() * softmax_scale
    pos = torch.arange(s, device=q.device)
    vl = torch.as_tensor(valid_len, device=q.device).reshape(-1, 1)
    ok = pos[None, :] < vl
    if window > 0:
        ok = ok & (pos[None, :] >= vl - window)
    logits = torch.where(ok[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    vt = torch.promote_types(q.dtype, vc.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(vt), vc.to(vt))
    return out.reshape(b, 1, h, hd)


def attention_verify(
    q: torch.Tensor,  # (B, S, H, hd): one chunk of draft positions per slot
    k_cache: torch.Tensor,  # (B, Sc, Kv*hd) flattened layout
    v_cache: torch.Tensor,
    n_kv: int,
    valid_len: torch.Tensor,  # (B, S) live length per chunk position
    window: int,
    softmax_scale: float,
) -> torch.Tensor:
    """`attention_decode` over a whole speculative chunk at once: chunk
    position ``j`` of slot ``b`` attends the cache prefix ``[0,
    valid_len[b, j])`` under the same window mask and `NEG_INF`, with the
    f32 softmax cast to q's dtype before the product with V."""
    b, sq, h, hd = q.shape
    s = k_cache.shape[1]
    g = h // n_kv
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    qg = q.reshape(b, sq, n_kv, g, hd).to(ct)
    kc = k_cache.reshape(b, s, n_kv, hd).to(ct)
    vc = v_cache.reshape(b, s, n_kv, hd)
    logits = torch.einsum("bjkgd,bskd->bjkgs", qg, kc).float() * softmax_scale
    pos = torch.arange(s, device=q.device)
    vl = valid_len.to(q.device)[:, :, None]
    ok = pos[None, None, :] < vl
    if window > 0:
        ok = ok & (pos[None, None, :] >= vl - window)
    logits = torch.where(ok[:, :, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    vt = torch.promote_types(q.dtype, vc.dtype)
    out = torch.einsum("bjkgs,bskd->bjkgd", probs.to(vt), vc.to(vt))
    return out.reshape(b, sq, h, hd)


# -- MLPs -----------------------------------------------------------------------------

def apply_mlp(p: Params, x: torch.Tensor, kind: str, dtype=torch.bfloat16) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(linear(p["w_gate"], x, dtype)) * linear(p["w_up"], x, dtype)
    elif kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(p["w_up"], x, dtype), approximate="tanh")
    else:
        raise ValueError(kind)
    return linear(p["w_down"], h, dtype)


# -- the model axis (tensor parallelism) -----------------------------------------------

def _split(t: torch.Tensor, tp) -> torch.Tensor:
    """This column's slice of ``t``'s last dimension."""
    n = t.shape[-1] // tp.model_size
    return t.narrow(t.dim() - 1, tp.col * n, n)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward all-reduces the columns' partial
    gradients (the input of a column-sharded product)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.model_all_reduce(g.contiguous()), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward (the columns' partial sums of a row-sharded
    product); identity backward: every column's gradient of the sum is
    the whole gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.model_all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The columns' slices concatenated along the last dimension forward;
    backward takes this column's slice of the whole gradient, which every
    column holds alike."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.model_all_gather(x.contiguous(), x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.tp).contiguous(), None


class _SplitToModel(torch.autograd.Function):
    """This column's slice of the last dimension forward; backward gathers
    the columns' gradients of their slices into the whole gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _split(x, tp).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.model_all_gather(g.contiguous(), g.dim() - 1), None


class _VocabEmbed(torch.autograd.Function):
    """Forward: this column's rows of a vocabulary-sharded table for the
    tokens in its range, zeros for the others, all-reduced over the
    columns. Backward: the (whole) gradient of each in-range token's row
    added into this column's rows, in the gradient's dtype."""

    @staticmethod
    def forward(ctx, table, tokens, tp):
        rows = table.shape[0]
        local = tokens.long() - tp.col * rows
        ok = (local >= 0) & (local < rows)
        idx = torch.where(ok, local, 0)
        out = torch.where(ok[..., None], table[idx], 0)
        ctx.save_for_backward(idx, ok)
        ctx.shape, ctx.tp = table.shape, tp
        return tp.model_all_reduce(out)

    @staticmethod
    def backward(ctx, g):
        idx, ok = ctx.saved_tensors
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        grad.index_put_((idx[ok],), g[ok], accumulate=True)
        return grad, None, None


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    return _GatherFromModel.apply(x, tp)


def split_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    return _SplitToModel.apply(x, tp)


def vocab_embed(p: Params, tokens: torch.Tensor, tp, dtype=torch.bfloat16) -> torch.Tensor:
    """`embed` over a table whose vocabulary is sharded over the model
    axis (each column holding ``V / model_size`` consecutive rows)."""
    return _VocabEmbed.apply(p["table"].to(dtype), tokens, tp)


def row_parallel(p: Params, x: torch.Tensor, tp, dtype=torch.bfloat16) -> torch.Tensor:
    """`linear` of a projection whose input rows are sharded over the model
    axis (``x`` holds this column's slice of the features): the columns'
    partial products all-reduced, then a whole bias added once."""
    y = reduce_from_model(torch.matmul(x.to(dtype), p["w"].to(dtype)), tp)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def apply_mlp_tp(p: Params, x: torch.Tensor, kind: str, d_ff: int, tp,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """`apply_mlp` under the model axis: where ``d_ff`` divides it, the
    gate and up projections are column-sharded and the down projection
    row-sharded (one all-reduce); otherwise every leaf is whole and the
    MLP runs whole on every column."""
    if p["w_up"]["w"].shape[-1] == d_ff:
        return apply_mlp(p, x, kind, dtype)
    x = copy_to_model(x, tp)
    if kind == "swiglu":
        h = F.silu(linear(p["w_gate"], x, dtype)) * linear(p["w_up"], x, dtype)
    elif kind == "gelu":
        h = F.gelu(linear(p["w_up"], x, dtype), approximate="tanh")
    else:
        raise ValueError(kind)
    return row_parallel(p["w_down"], h, tp, dtype)


# -- embeddings -----------------------------------------------------------------------

def unit_params(p) -> Params:
    """A layer's parameters: ``p`` itself, or, where ``p`` is a unit that
    a row holds as its part (`train.sharding.LazyUnit`, under FSDP), the
    whole unit, gathered now. The layer functions call it inside the
    function that `torch.utils.checkpoint` wraps, so the recompute in the
    backward pass gathers the unit again rather than keeping it."""
    return p() if callable(p) else p


def embed(p: Params, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return p["table"].to(dtype)[tokens]


def unembed(p: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.matmul(x.to(dtype), p["table"].to(dtype).t())


def sinusoidal_at(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal embedding rows for positions of any shape -> (..., d)."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=pos.device)
    angle = pos.float()[..., None] / torch.pow(10000.0, dim / d_model)
    out = torch.zeros(pos.shape + (d_model,), dtype=torch.float32, device=pos.device)
    out[..., 0::2] = torch.sin(angle)
    out[..., 1::2] = torch.cos(angle)
    return out


def sinusoidal_positions(seq: int, d_model: int, device=None) -> torch.Tensor:
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    angle = pos / np.power(10000.0, dim / d_model)
    out = np.zeros((seq, d_model), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return torch.from_numpy(out).to(device)
