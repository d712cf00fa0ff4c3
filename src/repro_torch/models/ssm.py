"""Mamba-2 SSD (state-space duality) block of the port.

The reference's `models/ssm.py`, op for op. `ssd_chunked` is the plain
chunked scan (a loop over heads where the reference maps over them);
`mamba_block` runs the scan through `kernels.ssd_scan.ops.ssd`, which on
a CUDA tensor launches the hand-written kernel and on a CPU tensor (or
with ``impl="ref"``) takes `ssd_chunked`. Dtype promotions follow the
reference: the SSM's own parameters (``A_log``, ``D``, ``dt_bias``,
``conv_w``, ``conv_b``) and the recurrent state are f32, the conv cache
keeps its own dtype (bf16 by default).

On a model axis (``mamba_block``'s ``tp``, the training forward) a
column holds the slices `train.sharding.param_specs` gives it, read from
their shapes: ``in_proj`` column-sharded on its flat last dimension (or
whole, ``replicate_ssm``), ``conv_w``, ``conv_b``, ``A_log``, ``D`` and
``dt_bias`` sharded on their last (or whole), ``out_proj`` row-sharded.
The split points z / x / B / C / dt and the heads do not line up with the
columns, so ``in_proj``'s weight and the small leaves are gathered whole
where they are used (a column keeps its slices between uses), the input
projection, the conv, the scan, the norm and the gate run whole on every
column, and the output projection is row-parallel (one all-reduce). The
weight is gathered rather than the projection: it is the smaller of the
two past ``d_model`` tokens a row, and the input's gradient then needs no
all-reduce.

Shapes (one B/C group, as in mamba2-130m):
  x  : (B, S, H, P)   H = d_inner / head_dim, P = head_dim
  dt : (B, S, H)      positive step sizes (softplus applied by the caller)
  A  : (H,)           negative decay rates
  Bm : (B, S, N)      input projection (shared across heads)
  Cm : (B, S, N)      output projection
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Params = dict

NEG_INF = -1e30


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    sp = x.shape[1]
    nc = sp // chunk
    dev = x.device
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = Bm.reshape(b, nc, chunk, n).float()
    Cc = Cm.reshape(b, nc, chunk, n).float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    scores = torch.einsum("bcsn,bctn->bcst", Cc, Bc)  # shared across heads (one group)
    init = (torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
            if initial_state is None else initial_state.float())
    A = A.float()
    ys, finals = [], []
    for hi in range(h):
        xh, dth = xc[:, :, :, hi], dtc[:, :, :, hi]  # (b,nc,q,p), (b,nc,q)
        dA_cum = torch.cumsum(dth * A[hi], dim=2)  # (b,nc,q)
        diff = dA_cum[:, :, :, None] - dA_cum[:, :, None, :]
        # clamp BEFORE exp: masked (s<t) entries have diff>0 and would
        # overflow to inf, and inf * 0 is NaN
        L = torch.exp(torch.where(tri, diff, NEG_INF))  # (b,nc,q,q)
        gated = L * scores
        y_diag = torch.einsum("bcst,bct,bctp->bcsp", gated, dth, xh)
        decay_to_end = torch.exp(dA_cum[:, :, -1:] - dA_cum)
        states = torch.einsum("bctn,bct,bct,bctp->bcpn", Bc, decay_to_end, dth, xh)
        chunk_decay = torch.exp(dA_cum[:, :, -1])  # (b,nc)
        carry = init[:, hi]
        prev = []
        for c in range(nc):  # the reference's lax.scan over chunks
            prev.append(carry)
            carry = states[:, c] + chunk_decay[:, c, None, None] * carry
        prev = torch.stack(prev, dim=1)  # (b,nc,p,n)
        y_off = torch.einsum("bcsn,bcpn,bcs->bcsp", Cc, prev, torch.exp(dA_cum))
        ys.append(y_diag + y_off)
        finals.append(carry)
    y = torch.stack(ys, dim=3).reshape(b, sp, h, p)[:, :s]
    return y.to(x.dtype), torch.stack(finals, dim=1)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """O(1) recurrent decode: h <- exp(dt*A) h + dt * x B^T ; y = h C.
    state (B,H,P,N), x_t (B,H,P), dt_t (B,H), A (H,), B_t/C_t (B,N)."""
    dtf = dt_t.float()
    decay = torch.exp(dtf * A.float())  # (B,H)
    outer = torch.einsum("bh,bhp,bn->bhpn", dtf, x_t.float(), B_t.float())
    new_state = decay[..., None, None] * state + outer
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t.float())
    return y.to(x_t.dtype), new_state


# -- full Mamba-2 block -------------------------------------------------------------

def init_mamba_block(gen: torch.Generator, cfg, *, dtype=torch.bfloat16, device=None) -> Params:
    """The reference's shapes and scales; projections in ``dtype``, the
    SSM's own parameters and the norm in f32."""
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": layers.init_linear(gen, d, 2 * din + 2 * n + h, dtype=dtype, device=device),
        "conv_w": layers.dense_init(gen, (cfg.ssm_conv, conv_ch), 0.2, device=device),
        "conv_b": torch.zeros((conv_ch,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm": layers.init_norm(din, "rms", device=device),
        "out_proj": layers.init_linear(gen, din, d, dtype=dtype, device=device),
    }


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d in f32, SiLU, back in ``seq``'s dtype.
    seq: (B,S,C); w: (K,C)."""
    k = w.shape[0]
    s = seq.shape[1]
    pad = F.pad(seq, (0, 0, k - 1, 0))
    out = torch.zeros(seq.shape, dtype=torch.float32, device=seq.device)
    for i in range(k):
        out = out + pad[:, i : i + s].float() * w[i].float()
    return F.silu(out + b.float()).to(seq.dtype)


def _split(proj: torch.Tensor, cfg):
    din, n = cfg.d_inner, cfg.ssm_state
    return torch.split(proj, [din, din, n, n, proj.shape[-1] - 2 * din - 2 * n], dim=-1)


def _gate_out(p: Params, y: torch.Tensor, z: torch.Tensor, cfg, dtype,
              tp=None) -> torch.Tensor:
    """rmsnorm(y) * silu(z), then the output projection (the reference's
    order; upstream Mamba-2 gates before the norm): row-parallel where
    ``tp`` shards its rows."""
    y = layers.apply_norm(p["norm"], y, "rms", cfg.norm_eps)
    y = y * F.silu(z.float()).to(y.dtype)
    if tp is None or p["out_proj"]["w"].shape[0] == cfg.d_inner:
        return layers.linear(p["out_proj"], y, dtype)
    return layers.row_parallel(p["out_proj"], layers.split_to_model(y, tp), tp, dtype)


def _whole(t: torch.Tensor, n: int, tp) -> torch.Tensor:
    """``t`` whole on every column: itself where its last dimension is
    ``n``, else the columns' slices gathered (backward: this column's slice
    of the whole gradient, which every column computes alike)."""
    return t if tp is None or t.shape[-1] == n else layers.gather_from_model(t, tp)


def mamba_block(p: Params, x: torch.Tensor, cfg, dtype=torch.bfloat16,
                want_state: bool = False, impl: str | None = None, tp=None):
    """Full-sequence Mamba-2 block (prefill, training). With ``want_state``
    also returns the decode cache ({state, conv}) after the sequence.
    ``impl`` forwards to `kernels.ssd_scan.ops.ssd`. ``tp``: the rank's
    `launch.mesh.Mesh` on a model axis, ``p`` its column's slices (module
    docstring); the output is whole on every column."""
    # imported here: the kernel family's plain version imports this module
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    bsz, s, _ = x.shape
    din, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_ch = din + 2 * n
    width = 2 * din + 2 * n + h
    proj = layers.linear({**p["in_proj"], "w": _whole(p["in_proj"]["w"], width, tp)}, x, dtype)
    z, xin, Bm, Cm, dt = _split(proj, cfg)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out = _causal_conv(conv_in, _whole(p["conv_w"], conv_ch, tp),
                            _whole(p["conv_b"], conv_ch, tp))
    xin, Bm, Cm = torch.split(conv_out, [din, n, n], dim=-1)
    dt = F.softplus(dt.float() + _whole(p["dt_bias"], h, tp))
    A = -torch.exp(_whole(p["A_log"], h, tp))
    xh = xin.reshape(bsz, s, h, hd)
    y, final_state = ssd_ops.ssd(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk, impl=impl)
    y = y + xh * _whole(p["D"], h, tp)[None, None, :, None].to(y.dtype)
    out = _gate_out(p, y.reshape(bsz, s, din), z, cfg, dtype, tp)
    if want_state:
        k = cfg.ssm_conv
        tail = conv_in[:, -(k - 1):]
        pad = (k - 1) - tail.shape[1]
        if pad > 0:
            tail = F.pad(tail, (0, 0, pad, 0))
        return out, {"state": final_state, "conv": tail}
    return out


def init_mamba_cache(cfg, batch: int, device=None) -> dict:
    h, hd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * n
    return {
        "state": torch.zeros((batch, h, hd, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=torch.bfloat16,
                            device=device),
    }


def mamba_decode(p: Params, x_t: torch.Tensor, cache: dict, cfg, dtype=torch.bfloat16):
    """One-token decode. x_t: (B, 1, d). Returns (y_t (B,1,d), new_cache);
    the new conv window is stored back in the cache's dtype."""
    bsz = x_t.shape[0]
    din, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = layers.linear(p["in_proj"], x_t[:, 0], dtype)
    z, xin, Bm, Cm, dt = _split(proj, cfg)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)  # (B, C)
    ct = torch.promote_types(cache["conv"].dtype, conv_in.dtype)
    window = torch.cat([cache["conv"].to(ct), conv_in[:, None].to(ct)], dim=1)  # (B,K,C)
    w = p["conv_w"].float()
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window.float(), w) + p["conv_b"]).to(dtype)
    xin, Bm, Cm = torch.split(conv_out, [din, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(bsz, h, hd)
    y, new_state = ssd_decode_step(cache["state"], xh, dt, A, Bm, Cm)
    y = y + xh * p["D"][None, :, None].to(y.dtype)
    out = _gate_out(p, y.reshape(bsz, din), z, cfg, dtype)[:, None]
    new_cache = {"state": new_state, "conv": window[:, 1:].to(cache["conv"].dtype)}
    return out, new_cache
