"""PyTorch port, paged decode attention: the port's plain version against
the reference's plain version and against the reference's Pallas kernel
run in interpret mode, on the same numpy inputs, and the op's dispatch.
The CUDA kernel is held against the plain version on the card, in
tests/test_torch_cuda.py.

Geometries cover windows (0, 1, 7), int8 pools, ``-1`` table entries, a
slot at ``pos=0`` and one at ``pos=mb*bs`` (the inactive-slot cursor).
At window 1 that last slot has no live position and no new row: the
reference's softmax then sees only equal masked logits and averages V
over the whole view, and the port does the same.

Tolerances, with their reasons:
  * port plain vs reference plain, f32: 1e-5 (same op sequence; only
    the CPU summation order differs);
  * port plain vs Pallas kernel (interpret), f32 pools: 2e-5 (streamed
    vs whole softmax), int8 pools: 2e-2 (the reference's own kernel test
    budget; the kernel dequantises in f32, the plain path to
    ``dequant_dtype``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.operators import kv_quantize as j_kv_quantize
from repro.kernels.paged_attention import (
    paged_decode_attention_kernel as j_kernel,
    paged_decode_attention_ref as j_ref,
)
from repro_torch.core.operators import kv_quantize
from repro_torch.kernels.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_kernel,
    paged_decode_attention_ref,
)

B, MB, BS, N_KV, REP, HD = 4, 4, 8, 2, 4, 16
D_KV = N_KV * HD


def _case(seed=0, pool_dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, N_KV * REP, HD)).astype(np.float32)
    kn = rng.normal(size=(B, D_KV)).astype(np.float32)
    vn = rng.normal(size=(B, D_KV)).astype(np.float32)
    kb = rng.normal(size=(B * MB, BS, D_KV)).astype(pool_dtype)
    vb = rng.normal(size=(B * MB, BS, D_KV)).astype(pool_dtype)
    # slot 0 mid-block, slot 1 full view (inactive cursor), slot 2 one
    # token, slot 3 empty; unused entries are -1
    table = np.arange(B * MB, dtype=np.int32).reshape(B, MB)
    table[0, 2:] = -1
    table[2, 1:] = -1
    table[3, :] = -1
    pos = np.array([11, MB * BS, 1, 0], np.int32)
    return q, kn, vn, kb, vb, table, pos


def _both(arrays, quantized):
    q, kn, vn, kb, vb, table, pos = arrays
    t = [torch.from_numpy(a) for a in (q, kn, vn, kb, vb, table, pos)]
    j = [jnp.asarray(a) for a in (q, kn, vn, kb, vb, table, pos)]
    tkw, jkw = {}, {}
    if quantized:
        t[3], tks = kv_quantize(t[3])
        t[4], tvs = kv_quantize(t[4])
        j[3], jks = j_kv_quantize(j[3])
        j[4], jvs = j_kv_quantize(j[4])
        tkw = {"k_scale": tks, "v_scale": tvs}
        jkw = {"k_scale": jks, "v_scale": jvs}
    return t, tkw, j, jkw


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else x.float().numpy()


def test_kv_quantize_matches_reference_bitwise():
    rows = np.random.default_rng(1).normal(size=(3, 5, 32)).astype(np.float32) * 4
    tq, ts = kv_quantize(torch.from_numpy(rows))
    jq, js = j_kv_quantize(jnp.asarray(rows))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("window", [0, 1, 7])
@pytest.mark.parametrize("quantized", [False, True])
def test_plain_matches_reference_plain(window, quantized):
    t, tkw, j, jkw = _both(_case(window), quantized)
    kw = dict(n_kv=N_KV, window=window, scale=HD ** -0.5)
    got = paged_decode_attention_ref(*t, **kw, **tkw, dequant_dtype=torch.float32)
    want = j_ref(*j, **kw, **jkw, dequant_dtype=jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_plain_matches_reference_plain_bf16_pool():
    """The model's mixed case: f32 query and new rows over a bf16 pool."""
    t, _, j, _ = _both(_case(3), False)
    t[3], t[4] = t[3].to(torch.bfloat16), t[4].to(torch.bfloat16)
    j[3], j[4] = j[3].astype(jnp.bfloat16), j[4].astype(jnp.bfloat16)
    kw = dict(n_kv=N_KV, window=0, scale=HD ** -0.5)
    got = paged_decode_attention_ref(*t, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(j_ref(*j, **kw)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 1, 7])
@pytest.mark.parametrize("quantized", [False, True])
def test_plain_matches_pallas_kernel_interpret(window, quantized):
    t, tkw, j, jkw = _both(_case(10 + window), quantized)
    kw = dict(n_kv=N_KV, window=window, scale=HD ** -0.5)
    got = paged_decode_attention_ref(*t, **kw, **tkw, dequant_dtype=torch.float32)
    want = j_kernel(*j, **kw, **jkw, interpret=True)
    tol = 2e-2 if quantized else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_op_dispatch_on_cpu():
    t, _, _, _ = _both(_case(4), False)
    kw = dict(n_kv=N_KV, window=0, scale=HD ** -0.5)
    before = paged_decode_attention_kernel.launches
    got = paged_decode_attention(*t, **kw)
    assert paged_decode_attention_kernel.launches == before  # CPU tensors: plain path
    torch.testing.assert_close(got, paged_decode_attention_ref(*t, **kw))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_kernel(*t, **kw)  # no CPU mode
    with pytest.raises(ValueError, match="impl"):
        paged_decode_attention(*t, **kw, impl="pallas")


# -- the CUDA kernel's split-K schedule, emulated --------------------------------
#
# The card's kernel splits each (slot, KV head) walk over blocks of `span`
# positions: a split walks the live positions of its span in tiles of 32
# with an online softmax and leaves an unnormalised partial (m, l, acc),
# or (-inf, 0) when none of its span is live; a second launch merges the
# partials by their maxima, folds in the step's own row (iff pos < mb*bs)
# and divides by max(l, 1e-30). The emulation below follows that schedule
# op for op in f32, so the combine's algebra (empty splits, none_live, the
# window across a split edge, int8 scales folded into score and
# probability) is held here before the card holds the kernel itself.

TILE = 32


def _split_combine(q, kn, vn, kb, vb, table, pos, *, n_kv, window, scale, span,
                   k_scale=None, v_scale=None):
    b, _, h, hd = q.shape
    _, bs, _ = kb.shape
    mb = table.shape[1]
    total = mb * bs
    rep = h // n_kv
    n_splits = -(-total // span)
    out = torch.empty((b, h, hd), dtype=torch.float32)
    ninf = torch.tensor(float("-inf"))
    for s_b in range(b):
        p_b = int(pos[s_b])
        hi = min(p_b, total)
        lo = max(0, p_b + 1 - window) if window > 0 else 0
        none_live = hi <= lo and p_b >= total
        if none_live:
            lo, hi = 0, total
        for kvh in range(n_kv):
            qg = q[s_b, 0, kvh * rep:(kvh + 1) * rep].float()       # (rep, hd)
            cols = slice(kvh * hd, (kvh + 1) * hd)
            parts = []
            for sp in range(n_splits):
                a, e = max(lo, sp * span), min(hi, sp * span + span)
                if a >= e:
                    parts.append((ninf.expand(rep), torch.zeros(rep), None))
                    continue
                m = ninf.expand(rep).clone()
                l = torch.zeros(rep)
                acc = torch.zeros(rep, hd)
                for t0 in range(a, e, TILE):
                    ts = torch.arange(t0, t0 + TILE)
                    ok = ts < e
                    tc = ts.clamp(max=e - 1)
                    blk = table[s_b, tc // bs].long().clamp(min=0)
                    k = kb[blk, tc % bs, cols].float() * ok[:, None]
                    v = vb[blk, tc % bs, cols].float() * ok[:, None]
                    ks = k_scale[blk, tc % bs] * ok if k_scale is not None else torch.ones(TILE)
                    vs = v_scale[blk, tc % bs] * ok if v_scale is not None else torch.ones(TILE)
                    sc = (qg @ k.T) * ks * scale
                    sc = torch.zeros_like(sc) if none_live else sc
                    sc = torch.where(ok, sc, torch.tensor(-1e30))
                    m_new = torch.maximum(m, sc.max(-1).values)
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + (p * vs) @ v
                    m = m_new
                parts.append((m, l, acc))
            fold = p_b < total
            s_new = (qg @ kn[s_b, cols].float()) * scale if fold else ninf.expand(rep)
            mx = torch.stack([s_new] + [pm for pm, _, _ in parts]).max(0).values
            w = [torch.where(pm == ninf, torch.zeros(rep), torch.exp(pm - mx)) for pm, _, _ in parts]
            pn = torch.exp(s_new - mx) if fold else torch.zeros(rep)
            l_tot = pn + sum(wi * pl for wi, (_, pl, _) in zip(w, parts))
            acc = pn[:, None] * vn[s_b, cols].float()
            for wi, (_, _, pa) in zip(w, parts):
                if pa is not None:
                    acc = acc + wi[:, None] * pa
            out[s_b, kvh * rep:(kvh + 1) * rep] = acc / l_tot.clamp(min=1e-30)[:, None]
    return out[:, None]


SPLIT_MB, SPLIT_BS, SPLIT_SPAN = 8, 8, 16


def _split_case(seed):
    """Six slots over a 64-position view split in 4 spans of 16: cursors at
    span - 1, span and span + 1 (a split edge inside, at and past the
    live range), 0 (only the new row), a free slot (pos = mb*bs, all -1
    table: reads the zero block 0) and a full slot (pos = mb*bs, real
    table: no new row, and none_live at window 1)."""
    rng = np.random.default_rng(seed)
    b, mb, bs = 6, SPLIT_MB, SPLIT_BS
    nb = b * mb + 1
    q = rng.normal(size=(b, 1, N_KV * REP, HD)).astype(np.float32)
    kn, vn = (rng.normal(size=(b, D_KV)).astype(np.float32) for _ in range(2))
    kb, vb = (rng.normal(size=(nb, bs, D_KV)).astype(np.float32) for _ in range(2))
    kb[0] = vb[0] = 0  # the store's zero block
    table = (1 + rng.permutation(b * mb)).astype(np.int32).reshape(b, mb)
    pos = np.array([SPLIT_SPAN - 1, SPLIT_SPAN, SPLIT_SPAN + 1, 0, mb * bs, mb * bs], np.int32)
    for i, p in enumerate(pos[:4]):
        table[i, -(-int(p + 1) // bs):] = -1  # unmapped past the cursor's block
    table[4] = -1
    return q, kn, vn, kb, vb, table, pos


@pytest.mark.parametrize("window", [0, 1, 7, 20])
@pytest.mark.parametrize("quantized", [False, True])
def test_split_schedule_matches_plain_and_pallas(window, quantized):
    """window 1: the full slot has no live position and no new row (none_live);
    7 and 20: windows that start inside one span and end in the next."""
    t, tkw, j, jkw = _both(_split_case(30 + window), quantized)
    kw = dict(n_kv=N_KV, window=window, scale=HD ** -0.5)
    got = _split_combine(*t, **kw, span=SPLIT_SPAN, **tkw)
    plain = paged_decode_attention_ref(*t, **kw, **tkw, dequant_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5, rtol=2e-5)
    pallas = j_kernel(*j, **kw, **jkw, interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(pallas), atol=2e-5, rtol=2e-5)
    assert torch.count_nonzero(got[4]) == 0  # the free slot: exactly 0


@pytest.mark.parametrize("span", [8, 24, 64])
def test_split_schedule_is_independent_of_span(span):
    """The same slots split at the block size, across block edges (24) and
    not at all (64): one answer, the plain version's."""
    t, _, _, _ = _both(_split_case(5), False)
    kw = dict(n_kv=N_KV, window=7, scale=HD ** -0.5)
    got = _split_combine(*t, **kw, span=span)
    want = paged_decode_attention_ref(*t, **kw, dequant_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_split_span_from_shapes():
    """The wrapper's split: at least 2 x 132 blocks at both measured shapes,
    a multiple of the block size, or of the 32-position tile when a block
    (the dense store's one block per slot) is longer than a split."""
    from repro_torch.kernels.paged_attention import split_span

    for b, n_kv, total, bs in ((8, 4, 2048, 16), (2, 2, 16384, 16), (8, 4, 2048, 2048)):
        span = split_span(b, n_kv, total, bs)
        assert b * n_kv * -(-total // span) >= 264
        assert span % (bs if bs <= span else TILE) == 0
    assert split_span(4, 2, 32, 8) == 32  # a tiny view: one split
