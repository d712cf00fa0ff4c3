"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version, and the continuous-batching engine on the GPU
against the same engine on the CPU. Every test here needs a CUDA device
and skips without one; the file imports no JAX, so it runs on a machine
that has only the port:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances, with their reasons:
  * paged decode, f32 pools: 2e-5 (the kernel streams the softmax in
    f32, the plain version takes it whole);
  * paged decode, bf16 and int8 pools: 2e-2 (bf16 outputs; the plain
    version rounds its probabilities to q's dtype, the kernel does not);
    int8 pools with f32 q: 2e-5 where the plain version dequantises in
    f32 as the kernel does (the split-K tests);
  * flash attention, f32: 2e-5 (the reference's own f32 kernel budget;
    streamed vs whole softmax, other summation order); bf16: 2e-2, the
    reference's bf16 kernel budget (both take f32 scores from the same
    bf16 inputs and round the output once; the kernel also rounds P to
    bf16 for the tensor cores, which moves an output by ~2^-9 of it);
  * SSD scan, f32: 1e-4 for y and the final state. Inputs are the
    model's A (-linspace(1, 16)) and dt (softplus of N(0, 1)), or the
    reference test's dt (U(0.01, 0.2), tests/test_kernels.py), with B and
    C scaled so that C.B has unit variance: y is O(1), and both sides'
    f32 error, set by the prefix sums of dt * A, is ~3e-5 against an f64
    evaluation there. bf16: per output row (one position and head), max
    |kernel - plain| / rms(plain row) <= 1/16: both compute in f32 from
    the same bf16 inputs and round y once, so they differ by at most one
    bf16 ulp of an element (2^-7 of it, up to ~4x the row's rms); the
    kernel's tensor-core body takes each f32 operand as two bf16 terms
    (2^-17 of it); the f32 final state keeps 1e-4;
  * engine: identical token streams and admissions in f32, logits 1e-4;
  * chunk_accumulate: bit for bit at n = 2 (one rounding, the stream
    channel's call), ragged S included; 1e-6 relative at n > 2 and for
    bf16 input (summation order);
  * argmax: exact at every split edge, NaN and -inf rows included;
  * histogram: 1e-5 relative (atomics add in a varying order); exact
    where counts are small integers (every partial sum is exact), also
    added into an accumulator (``out=``), through the stream operators
    and in the word count;
  * the conventional and overlap steps in a two-row world on the card
    against the same world on the CPU, one SGD step (lr 1, so the new
    parameters differ by the gradients' difference): 1e-4 of the largest
    gradient element, the chip smoke's `TRAIN_PARITY_REL` (f32 with TF32
    off; other GEMM blockings sum in another order); checkpoints of CUDA
    tensors: bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.operators import kv_quantize
from repro_torch.kernels.flash_attention import flash_attention_kernel, mha
from repro_torch.kernels.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_kernel,
    split_span,
)
from repro_torch.kernels.sample import argmax_last_kernel, sample_last
from repro_torch.kernels.sample.sample import argmax_split
from repro_torch.kernels.ssd_scan import ssd, ssd_scan_kernel
from repro_torch.kernels.stream_reduce import (
    accumulate,
    chunk_accumulate_kernel,
    histogram_kernel,
    keyed_histogram,
)
from repro_torch.kernels.stream_reduce.stream_reduce import CTA_BINS
from repro_torch.launch.mesh import spawn
from repro_torch.models.model_zoo import build
from repro_torch.serve import EngineConfig, KVSpec, Request, make_engine
from torch_worlds import (
    N_ROWS,
    WC_CFG,
    cuda_fold_case,
    cuda_wordcount_case,
    data_parallel_case,
)

pytestmark = pytest.mark.gpu

B, MB, BS, N_KV, REP, HD = 4, 4, 8, 2, 4, 16
D_KV = N_KV * HD


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged_case(seed, pool):
    """Slot 0 mid-block, slot 1 at the inactive cursor mb*bs, slot 2 one
    token, slot 3 empty (pos 0); unused table entries are -1."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, N_KV * REP, HD)).astype(np.float32)
    kn, vn = (rng.normal(size=(B, D_KV)).astype(np.float32) for _ in range(2))
    kb, vb = (rng.normal(size=(B * MB, BS, D_KV)).astype(np.float32) for _ in range(2))
    table = np.arange(B * MB, dtype=np.int32).reshape(B, MB)
    table[0, 2:] = -1
    table[2, 1:] = -1
    table[3, :] = -1
    pos = np.array([11, MB * BS, 1, 0], np.int32)
    t = [torch.from_numpy(a) for a in (q, kn, vn, kb, vb, table, pos)]
    scales = {}
    if pool == "int8":
        t[3], scales["k_scale"] = kv_quantize(t[3])
        t[4], scales["v_scale"] = kv_quantize(t[4])
    elif pool == "bf16":
        t = [x.to(torch.bfloat16) if x.is_floating_point() else x for x in t]
    return t, scales


@pytest.mark.parametrize("window", [0, 1, 7])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_paged_kernel_matches_plain(cuda, window, pool):
    t, scales = _paged_case(20 + window, pool)
    t = [x.to(cuda) for x in t]
    kw = dict(n_kv=N_KV, window=window, scale=HD ** -0.5,
              **{k: v.to(cuda) for k, v in scales.items()})
    before = paged_decode_attention_kernel.launches
    got = paged_decode_attention(*t, **kw)
    assert paged_decode_attention_kernel.launches == before + 1
    want = paged_decode_attention(*t, **kw, impl="ref", dequant_dtype=t[0].dtype)
    torch.cuda.synchronize()
    tol = 2e-5 if pool == "f32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_paged_kernel_rejects_what_it_cannot_take(cuda):
    t, _ = _paged_case(0, "f32")
    t = [x.to(cuda) for x in t]
    kw = dict(n_kv=N_KV, window=0, scale=HD ** -0.5)
    with pytest.raises(TypeError, match="int32"):
        paged_decode_attention(*t[:5], t[5].long(), t[6], **kw)
    with pytest.raises(ValueError, match="k_scale"):
        q8, _ = kv_quantize(t[3])
        paged_decode_attention(*t[:3], q8, q8, *t[5:], **kw)
    with pytest.raises(ValueError, match="one device"):
        paged_decode_attention(t[0], *[x.cpu() for x in t[1:]], **kw)


def test_paged_kernel_takes_a_group_of_12_heads_of_128(cuda):
    """starcoder2-15b's KV group (48 query heads over 4 KV heads of 128):
    12 x 128 = 1536 outputs per block, past the 1024 that one
    accumulator set holds."""
    rng = np.random.default_rng(3)
    b, n_kv, rep, hd, bs, mb = 3, 4, 12, 128, 16, 8
    d_kv = n_kv * hd
    q = rng.normal(size=(b, 1, n_kv * rep, hd)).astype(np.float32)
    kn, vn = (rng.normal(size=(b, d_kv)).astype(np.float32) for _ in range(2))
    kb, vb = (rng.normal(size=(b * mb, bs, d_kv)).astype(np.float32) for _ in range(2))
    table = np.arange(b * mb, dtype=np.int32).reshape(b, mb)
    pos = np.array([100, 5, mb * bs], np.int32)
    t = [torch.from_numpy(a).to(cuda) for a in (q, kn, vn, kb, vb, table, pos)]
    for window in (0, 37):
        kw = dict(n_kv=n_kv, window=window, scale=hd ** -0.5)
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            tt = [x.to(dtype) if x.is_floating_point() else x for x in t]
            got = paged_decode_attention(*tt, **kw)
            want = paged_decode_attention(*tt, **kw, impl="ref", dequant_dtype=dtype)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_paged_kernel_names_its_group_limit(cuda):
    t, _ = _paged_case(0, "f32")
    t = [x.to(cuda) for x in t]
    q = torch.zeros((B, 1, 2 * 17, 128), device=cuda)
    kv = torch.zeros((B * MB, BS, 2 * 128), device=cuda)
    new = torch.zeros((B, 2 * 128), device=cuda)
    with pytest.raises(ValueError, match="17 query heads of 128"):
        paged_decode_attention(q, new, new, kv, kv, *t[5:], n_kv=2, window=0, scale=1.0)


def _split_case(seed, pool, mb=64, n_kv=N_KV, rep=REP, hd=HD, cursors=None):
    """Six slots over 8-token blocks. By default the cursors sit at span - 1,
    span and span + 1 of the wrapper's split (a split edge inside, at
    and past the live range), then 0 (only the new row), a free slot
    (pos = mb*bs, all -1 table: the zero block 0) and a full slot (pos =
    mb*bs, real table: no new row; none_live at window 1)."""
    rng = np.random.default_rng(seed)
    b, bs = 6, 8
    span = split_span(b, n_kv, mb * bs, bs)
    d_kv = n_kv * hd
    nb = b * mb + 1
    q = rng.normal(size=(b, 1, n_kv * rep, hd)).astype(np.float32)
    kn, vn = (rng.normal(size=(b, d_kv)).astype(np.float32) for _ in range(2))
    kb, vb = (rng.normal(size=(nb, bs, d_kv)).astype(np.float32) for _ in range(2))
    kb[0] = vb[0] = 0
    table = (1 + rng.permutation(b * mb)).astype(np.int32).reshape(b, mb)
    head = (span - 1, span, span + 1) if cursors is None else cursors
    pos = np.array([*head, 0, mb * bs, mb * bs], np.int32)
    for i, p in enumerate(pos[:4]):
        table[i, -(-int(p + 1) // bs):] = -1
    table[4] = -1
    t = [torch.from_numpy(a) for a in (q, kn, vn, kb, vb, table, pos)]
    scales = {}
    if pool == "int8":
        t[3], scales["k_scale"] = kv_quantize(t[3])
        t[4], scales["v_scale"] = kv_quantize(t[4])
    elif pool == "bf16":
        t = [x.to(torch.bfloat16) if x.is_floating_point() else x for x in t]
    return t, scales


@pytest.mark.parametrize("window", [0, 1, 7, 20])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_paged_kernel_at_split_edges(cuda, window, pool):
    """A 512-position view split in spans of 16: cursors at span - 1, span
    and span + 1, pos 0, a free slot (exactly 0) and none_live (window 1);
    windows 7 and 20 cross a split edge."""
    assert split_span(6, N_KV, 64 * 8, 8) == 16
    t, scales = _split_case(40 + window, pool)
    t = [x.to(cuda) for x in t]
    kw = dict(n_kv=N_KV, window=window, scale=HD ** -0.5,
              **{k: v.to(cuda) for k, v in scales.items()})
    got = paged_decode_attention(*t, **kw)
    want = paged_decode_attention(*t, **kw, impl="ref", dequant_dtype=t[0].dtype)
    torch.cuda.synchronize()
    tol = 2e-2 if pool == "bf16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.count_nonzero(got[4]) == 0


@pytest.mark.parametrize("mb", [2, 8, 24])
def test_paged_kernel_split_at_other_views(cuda, mb):
    """Views of 16, 64 and 192 positions: one split of 32, two of 32, and
    24 of one 8-token block each."""
    total = mb * 8
    t, _ = _split_case(7, "f32", mb=mb, cursors=(total // 3, total // 2, total - 1))
    t = [x.to(cuda) for x in t]
    kw = dict(n_kv=N_KV, window=20, scale=HD ** -0.5)
    got = paged_decode_attention(*t, **kw)
    want = paged_decode_attention(*t, **kw, impl="ref", dequant_dtype=torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_paged_kernel_group_of_12_across_splits(cuda, pool):
    """starcoder2-15b's group (12 query heads of 128 per KV head) with the
    walk split in spans of 16 around the cursors."""
    t, scales = _split_case(9, pool, n_kv=2, rep=12, hd=128)
    t = [x.to(cuda) for x in t]
    for window in (0, 7):
        kw = dict(n_kv=2, window=window, scale=128 ** -0.5,
                  **{k: v.to(cuda) for k, v in scales.items()})
        got = paged_decode_attention(*t, **kw)
        want = paged_decode_attention(*t, **kw, impl="ref", dequant_dtype=t[0].dtype)
        torch.cuda.synchronize()
        tol = 2e-2 if pool == "bf16" else 2e-5
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_paged_kernel_long_walk(cuda):
    """The long arm's decode shape, narrowed: 2 slots of 15,000 and 9,500
    positions in 16-token blocks at the default split (bf16 pool, f32
    holds the walk exactly)."""
    rng = np.random.default_rng(11)
    b, n_kv, rep, hd, bs, mb = 2, 2, 8, 128, 16, 1024
    d_kv = n_kv * hd
    nb = b * mb + 1
    pos = np.array([15_000, 9_500], np.int32)
    table = (1 + rng.permutation(b * mb)).astype(np.int32).reshape(b, mb)
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((b, 1, n_kv * rep, hd), generator=g, device=cuda)
    kn, vn = (torch.randn((b, d_kv), generator=g, device=cuda) for _ in range(2))
    kb, vb = (torch.randn((nb, bs, d_kv), generator=g, device=cuda) for _ in range(2))
    tt = [torch.as_tensor(table, device=cuda), torch.as_tensor(pos, device=cuda)]
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        args = [x.to(dtype) for x in (q, kn, vn, kb, vb)] + tt
        got = paged_decode_attention(*args, n_kv=n_kv, window=0, scale=hd ** -0.5)
        want = paged_decode_attention(*args, n_kv=n_kv, window=0, scale=hd ** -0.5,
                                      impl="ref", dequant_dtype=dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# flash attention: (head dim, KV heads, group) covering every head dim the
# shipped configs use and groups 1, 8 and 12; lengths are not multiples of
# the kernel's 64-row and 64-key tiles
FLASH_GEOMETRIES = [(16, 2, 1), (16, 2, 4), (32, 1, 8), (64, 4, 8), (128, 2, 8), (128, 4, 12)]


def _flash_inputs(seed, b, sq, sk, n_kv, rep, hd, dtype, device):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, n_kv * rep, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, n_kv, hd)).astype(np.float32) for _ in range(2))
    return [torch.from_numpy(a).to(device, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 1, 50])
@pytest.mark.parametrize("hd,n_kv,rep", FLASH_GEOMETRIES)
def test_flash_kernel_matches_plain(cuda, hd, n_kv, rep, window, dtype):
    q, k, v = _flash_inputs(hd + rep + window, 2, 157, 157, n_kv, rep, hd, dtype, cuda)
    before = flash_attention_kernel.launches
    got = mha(q, k, v, window=window)
    assert flash_attention_kernel.launches == before + 1
    want = mha(q, k, v, window=window, impl="ref")
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (70, 200, True, 0), (200, 70, True, 0), (200, 70, True, 150),
    (129, 129, False, 0), (129, 100, False, 33), (1, 1, True, 0),
])
def test_flash_kernel_shapes_and_masks(cuda, sq, sk, causal, window):
    """Sq != Sk (start-aligned positions), non-causal, a single token."""
    q, k, v = _flash_inputs(sq + sk, 3, sq, sk, 2, 4, 64, torch.float32, cuda)
    got = mha(q, k, v, causal=causal, window=window, scale=0.3)
    want = mha(q, k, v, causal=causal, window=window, scale=0.3, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_flash_kernel_reads_strided_views(cuda):
    """Kernel-layout views of a model-layout buffer: a q sliced out of a
    wider buffer (16-byte aligned rows) goes in with no copy, and q, k, v
    whose rows are 129 elements apart (not 16-byte aligned) go in too: q
    through the kernel's scalar loads, k and v through the contiguous
    copies the wrapper makes for the TMA unit."""
    q, k, v = _flash_inputs(5, 2, 90, 90, 2, 8, 128, torch.bfloat16, cuda)
    want = mha(q, k, v, impl="ref").transpose(1, 2)
    wide = torch.cat([q, q], dim=-1)[..., 128:]  # head dim contiguous, rows strided
    odd = [torch.zeros(x.shape[:-1] + (129,), dtype=x.dtype, device=cuda)[..., :128]
           for x in (q, k, v)]
    for x, src in zip(odd, (q, k, v)):
        x.copy_(src)
    for qq, kk, vv in ((wide, k, v), odd):
        got = flash_attention_kernel(qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2))
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


# the bf16 body at head dims 64 and 128 (TMA and wgmma): (head dim, KV
# heads, group); lengths not multiples of its 128-row and 128-key tiles,
# windows across tile edges, and starcoder2-15b's group of 12
WGMMA_GEOMETRIES = [(64, 2, 8), (128, 2, 8), (128, 1, 12)]


@pytest.mark.parametrize("window", [0, 129])
@pytest.mark.parametrize("s", [130, 1000])
@pytest.mark.parametrize("hd,n_kv,rep", WGMMA_GEOMETRIES)
def test_flash_wgmma_body_matches_plain(cuda, hd, n_kv, rep, s, window):
    q, k, v = _flash_inputs(hd + s + window, 2, s, s, n_kv, rep, hd, torch.bfloat16, cuda)
    before = flash_attention_kernel.launches
    got = mha(q, k, v, window=window)
    assert flash_attention_kernel.launches == before + 1
    want = mha(q, k, v, window=window, impl="ref")
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (70, 200, True, 0), (200, 70, True, 0), (200, 70, True, 150),
    (129, 129, False, 0), (129, 100, False, 33), (1, 1, True, 0), (300, 300, True, 1),
])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_wgmma_body_shapes_and_masks(cuda, hd, sq, sk, causal, window):
    """Sq != Sk, non-causal, a single token and window 1 through the bf16
    body of head dims 64 and 128, in the kernel layout (contiguous K/V)."""
    q, k, v = _flash_inputs(sq + sk + hd, 3, sq, sk, 2, 4, hd, torch.bfloat16, cuda)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    got = flash_attention_kernel(qt, kt, vt, causal=causal, window=window, scale=0.3)
    want = mha(q, k, v, causal=causal, window=window, scale=0.3, impl="ref").transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v = _flash_inputs(0, 1, 16, 16, 2, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        mha(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(TypeError, match="f32 or all bf16"):
        mha(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="one device"):
        mha(q, k.cpu(), v)
    with pytest.raises(ValueError, match="no live key"):
        mha(q, k[:, :4], v[:, :4], window=8)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_kernel(q.transpose(1, 2)[..., ::2], k.transpose(1, 2)[..., ::2],
                               v.transpose(1, 2)[..., ::2])
    with pytest.raises(ValueError, match="unknown impl"):
        mha(q, k, v, impl="kernel")


def _ssd_inputs(seed, b, s, h, p, n, dtype, device, a=None, dt_range=None):
    """x (B,S,H,P), dt (B,S,H), A (H,), Bm, Cm (B,S,N): the model's A (or
    -a), dt uniform in ``dt_range`` (None: the model's softplus(N(0, 1))),
    B and C at unit-variance C.B."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32))
    if dt_range is None:
        dt = torch.nn.functional.softplus(torch.from_numpy(
            rng.normal(size=(b, s, h)).astype(np.float32)))
    else:
        dt = torch.from_numpy(rng.uniform(*dt_range, size=(b, s, h)).astype(np.float32))
    A = -torch.linspace(1.0, 16.0, h) if a is None else torch.full((h,), -float(a))
    bc = [torch.from_numpy(rng.normal(size=(b, s, n)).astype(np.float32)) / n ** 0.5
          for _ in range(2)]
    return (x.to(device, dtype), dt.to(device), A.to(device),
            bc[0].to(device, dtype), bc[1].to(device, dtype))


def _row_rel_err(got, want):
    d = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().square().mean(-1).sqrt().clamp_min(1e-6)
    return (d / rms).max().item()


# (B, S, H, P, N, chunk): mamba2-130m's head and state (P 64, N 128, chunk
# 256) at a ragged S with 5 heads (a head group of 1 after 4) and at
# S < chunk; the smoke config's (P 32, N 16, chunk 32); a chunk of 16
SSD_GEOMETRIES = [(2, 300, 5, 64, 128, 256), (1, 1000, 24, 64, 128, 256),
                  (2, 20, 4, 64, 128, 256), (2, 96, 3, 32, 16, 32), (1, 50, 2, 32, 16, 16),
                  (1, 7, 6, 32, 8, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_GEOMETRIES)
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, chunk, dtype):
    args = _ssd_inputs(s + h, b, s, h, p, n, dtype, cuda)
    before = ssd_scan_kernel.launches
    y, fin = ssd(*args, chunk=chunk)
    assert ssd_scan_kernel.launches == before + 1
    want_y, want_fin = ssd(*args, chunk=chunk, impl="ref")
    torch.cuda.synchronize()
    assert y.shape == (b, s, h, p) and y.dtype == dtype and fin.dtype == torch.float32
    torch.testing.assert_close(fin, want_fin, atol=1e-4, rtol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    else:
        assert _row_rel_err(y, want_y) <= 1 / 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_kernel_at_the_reference_tests_dt(cuda, dtype):
    """mamba2-130m's widths at the reference test's small dt, where the
    state carries across many chunks (the tests above take the model's
    dt)."""
    args = _ssd_inputs(11, 1, 1000, 24, 64, 128, dtype, cuda, dt_range=(0.01, 0.2))
    y, fin = ssd(*args, chunk=256)
    want_y, want_fin = ssd(*args, chunk=256, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(fin, want_fin, atol=1e-4, rtol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    else:
        assert _row_rel_err(y, want_y) <= 1 / 16


def test_ssd_kernel_masks_before_exp(cuda):
    """A = -16 and dt near 1: the masked exponent differences reach +4,000
    within a chunk. The kernel never exponentiates them: every output is
    finite and matches the plain version. The final state is then almost
    only the last real position's term, exp(0) = 1, so padded positions
    that shifted the ragged last chunk's prefix sums by an ulp of |cum|
    (~5e-4 here) would show as a ~3e-4 error."""
    args = _ssd_inputs(7, 1, 1000, 24, 64, 128, torch.float32, cuda, a=16.0,
                       dt_range=(0.9, 1.1))
    y, fin = ssd(*args, chunk=256)
    want_y, want_fin = ssd(*args, chunk=256, impl="ref")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=0)
    torch.testing.assert_close(fin, want_fin, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_kernel_reads_conv_output_slices(cuda, dtype):
    """The model hands the kernel column slices of the conv output
    (B, S, d_inner + 2N) with no copy: x as a (B, S, H, P) view, B and C
    as (B, S, N) views of the same rows. The result equals the kernel's
    on contiguous copies, bit for bit."""
    x, dt, A, Bm, Cm = _ssd_inputs(9, 2, 333, 4, 64, 128, dtype, cuda)
    conv_out = torch.cat([x.reshape(2, 333, 256), Bm, Cm], dim=-1)
    xs, bs, cs = torch.split(conv_out, [256, 128, 128], dim=-1)
    got = ssd(xs.reshape(2, 333, 4, 64), dt, A, bs, cs, chunk=256)
    want = ssd(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert not xs.is_contiguous()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_bf16_body_masks_before_exp_over_a_ragged_tail(cuda):
    """The tensor-core body at A = -16 and dt near 1 over 4,100 positions
    (16 chunks and a ragged 4-position tail): the masked exponent
    differences reach +4,000, the decays underflow, and the final state is
    almost only the last real position's term. y within 2^-4 of each
    row's rms, the final state within 1e-4."""
    args = _ssd_inputs(13, 1, 4100, 24, 64, 128, torch.bfloat16, cuda, a=16.0,
                       dt_range=(0.9, 1.1))
    y, fin = ssd(*args, chunk=256)
    want_y, want_fin = ssd(*args, chunk=256, impl="ref")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    assert _row_rel_err(y, want_y) <= 1 / 16
    torch.testing.assert_close(fin, want_fin, atol=1e-4, rtol=0)


@pytest.mark.parametrize("p,n", [(64, 128), (32, 40)])
def test_ssd_bf16_body_with_a_short_last_head_group(cuda, p, n):
    """13 heads: a prime, so whatever group of 2-8 heads a block of the
    tensor-core body takes at this shape, the last group is shorter. N of
    40 also pads the state to 48 columns."""
    args = _ssd_inputs(17, 1, 3000, 13, p, n, torch.bfloat16, cuda)
    y, fin = ssd(*args, chunk=256)
    want_y, want_fin = ssd(*args, chunk=256, impl="ref")
    torch.cuda.synchronize()
    assert _row_rel_err(y, want_y) <= 1 / 16
    torch.testing.assert_close(fin, want_fin, atol=1e-4, rtol=1e-4)


def test_ssd_bf16_body_reads_unaligned_views(cuda):
    """x, B and C as column slices of a conv output whose rows are 193
    elements apart (not 16-byte aligned): the tensor-core body's tiles
    arrive by plain loads instead of cp.async, and the result equals the
    kernel's on contiguous copies bit for bit."""
    x, dt, A, Bm, Cm = _ssd_inputs(19, 2, 333, 4, 32, 32, torch.bfloat16, cuda)
    pad = torch.zeros((2, 333, 1), dtype=torch.bfloat16, device=cuda)
    conv_out = torch.cat([x.reshape(2, 333, 128), Bm, Cm, pad], dim=-1)
    xs, bs, cs, _ = torch.split(conv_out, [128, 32, 32, 1], dim=-1)
    got = ssd(xs.reshape(2, 333, 4, 32), dt, A, bs, cs, chunk=64)
    want = ssd(x, dt, A, Bm, Cm, chunk=64)
    torch.cuda.synchronize()
    assert xs.stride(1) == 193 and bs.stride(1) == 193
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_kernel_rejects_what_it_cannot_take(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(0, 1, 40, 2, 64, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        ssd(x[..., :48], dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="N <= 128"):
        ssd(x, dt, A, *(torch.zeros((1, 40, 129), device=cuda),) * 2, chunk=16)
    with pytest.raises(ValueError, match="chunk <= 256"):
        ssd(x, dt, A, Bm, Cm, chunk=512)
    with pytest.raises(TypeError, match="f32"):
        ssd(x, dt.bfloat16(), A, Bm, Cm, chunk=16)
    with pytest.raises(TypeError, match="f32 or all bf16"):
        ssd(x, dt, A, Bm.bfloat16(), Cm, chunk=16)
    with pytest.raises(ValueError, match="one device"):
        ssd(x, dt.cpu(), A, Bm, Cm, chunk=16)


def _tied_logits():
    x = np.full((3, 2, 1024), -1.0, np.float32)
    x[0, -1, [3, 699]] = 7.0
    x[1, -1, :] = 0.0
    x[2, -1, [1023, 5]] = 2.0
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_argmax_kernel_matches_plain(cuda, dtype):
    rows = np.random.default_rng(0).normal(size=(5, 2, 1024)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([_tied_logits(), rows])).to(cuda, dtype)
    before = argmax_last_kernel.launches
    got = sample_last(x)
    assert argmax_last_kernel.launches == before + 1
    assert torch.equal(got, sample_last(x, impl="ref"))
    assert got[:3].tolist() == [3, 0, 5]


def _plant_argmax_rows(last, span, splits):
    """Plant, row by row (cycling), maxima where the split meets them;
    returns row -> the index that must win."""
    b, vocab = last.shape
    starts = [span * j for j in range(1, splits)]
    ends = [s - 1 for s in starts]
    want = {}
    for r in range(b):
        kind = r % 6
        if kind == 0:  # a tie at the first element of every span, and at the row's end
            last[r, starts + [vocab - 1]] = 30.0
            want[r] = starts[0] if starts else vocab - 1
        elif kind == 1:  # a tie at both ends of the row
            last[r, [0, vocab - 1]] = 30.0
            want[r] = 0
        elif kind == 2:  # a tie at the last element of every span
            last[r, ends + [vocab - 1]] = 30.0
            want[r] = ends[0] if ends else vocab - 1
        elif kind == 3:  # a NaN in a later split than a +inf
            last[r, 1] = float("inf")
            last[r, vocab - 2] = float("nan")
            want[r] = vocab - 2
        elif kind == 4:  # all -inf
            last[r] = float("-inf")
            want[r] = 0
    return want


# each arm's vocabulary and an odd one (rows not 16-byte aligned), at the
# batch sizes of admission, the long arm, the 8-slot arms and a wide batch;
# S > 1 reads the last position of (B, S, V), rows strided by S x V
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("b", [1, 2, 8, 64])
@pytest.mark.parametrize("vocab", [32_000, 50_280, 151_936, 32_001])
def test_argmax_kernel_at_split_edges(cuda, vocab, b, s, dtype):
    gen = torch.Generator(device=cuda).manual_seed(vocab + 7 * b + s)
    x = torch.randn((b, s, vocab), generator=gen, device=cuda).to(dtype)
    span, splits = argmax_split(b, vocab, x.element_size())
    want = _plant_argmax_rows(x[:, -1], span, splits)
    before = argmax_last_kernel.launches
    got = sample_last(x)
    assert argmax_last_kernel.launches == before + 1
    assert torch.equal(got, sample_last(x, impl="ref"))
    assert {r: got[r].item() for r in want} == want


def test_argmax_kernel_scratch_stays_clean_across_shapes(cuda):
    """Calls of many shapes back to back on one stream share the tickets:
    each launch must leave them at zero for the next."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    xs = [torch.randn((b, 1, v), generator=gen, device=cuda).to(torch.bfloat16)
          for b, v in [(8, 32_000), (2, 151_936), (1, 151_936), (64, 50_280), (8, 32_000)] * 3]
    before = argmax_last_kernel.launches
    got = [sample_last(x) for x in xs]
    assert argmax_last_kernel.launches == before + len(xs)
    for x, g in zip(xs, got):
        assert torch.equal(g, sample_last(x, impl="ref"))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _run_engine(model, params, kv):
    e = make_engine(model, params, EngineConfig(mode="continuous", max_batch=3, max_len=64,
                                                kv=KVSpec(**kv)))
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, model.cfg.vocab_size, 16)
    for i in range(7):
        prompt = rng.integers(0, model.cfg.vocab_size, int(rng.integers(3, 25)))
        if i % 2:
            prompt = np.concatenate([prefix, prompt])
        e.submit(Request(uid=i, prompt=prompt.astype(np.int32),
                         max_new_tokens=int(rng.integers(2, 9))))
    ticks = []
    while not e.idle():
        e.step()
        ticks.append((e.last_tick["decode_batch"], e.last_tick["prefill_lens"],
                      e.last_tick["kv"]))
    return e, ticks


@pytest.mark.parametrize("kv_dtype", ["cache", "int8"])
def test_engine_on_gpu_matches_cpu(cuda, kv_dtype):
    """The same f32 weights serve the same requests on both devices: the
    GPU run goes through the flash kernel in every layer of every
    prefill and through the paged and argmax kernels on every decode
    tick, the CPU run through their plain versions. With the bf16 cache pool the runs agree
    tick for tick and token for token. With int8 pools the kernel
    dequantizes in f32 and the plain version to the bf16 cache dtype, so
    the logits differ by bf16 rounding and a near-tie may flip a token:
    there every request must finish with its full token count."""
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    cpu_model, gpu_model = build(cfg, device="cpu"), build(cfg, device="cuda")
    params = cpu_model.init(0)
    gpu_params = _to(params, cuda)
    kv = dict(kind="paged", block_size=8, prefix_cache=kv_dtype == "cache", kv_dtype=kv_dtype)
    prefill_calls = []

    def prefill(*a, **kw):
        prefill_calls.append(1)
        return gpu_model.prefill(*a, **kw)

    paged0, argmax0 = paged_decode_attention_kernel.launches, argmax_last_kernel.launches
    flash0 = flash_attention_kernel.launches
    ge, gticks = _run_engine(dataclasses.replace(gpu_model, prefill=prefill), gpu_params, kv)
    decode_ticks = sum(1 for t in gticks if t[0])
    assert paged_decode_attention_kernel.launches - paged0 == cfg.n_layers * decode_ticks
    assert argmax_last_kernel.launches - argmax0 >= decode_ticks
    assert prefill_calls and \
        flash_attention_kernel.launches - flash0 == cfg.n_layers * len(prefill_calls)
    ce, cticks = _run_engine(cpu_model, params, kv)
    if kv_dtype == "int8":
        assert {r.uid: len(r.out_tokens) for r in ge.finished} == \
               {r.uid: r.max_new_tokens for r in ce.finished}
        return
    assert gticks == cticks
    assert {r.uid: r.out_tokens for r in ge.finished} == \
           {r.uid: r.out_tokens for r in ce.finished}


def test_aligned_mamba_engine_on_gpu_matches_cpu(cuda):
    """The f32 mamba2 smoke config served in aligned mode on both devices:
    on the GPU every prefill runs the SSD kernel in every layer and every
    admission and tick the argmax kernel; the runs agree tick for tick
    and token for token."""
    cfg = dataclasses.replace(get_smoke("mamba2-130m"), dtype=torch.float32)
    cpu_model, gpu_model = build(cfg, device="cpu"), build(cfg, device="cuda")
    params = cpu_model.init(0)
    runs = []
    for model, p in ((gpu_model, _to(params, cuda)), (cpu_model, params)):
        e = make_engine(model, p, EngineConfig(max_batch=3, max_len=128))
        rng = np.random.default_rng(1)
        for i, n in enumerate((5, 70, 33, 12, 48)):
            e.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                             max_new_tokens=6))
        ssd0, argmax0 = ssd_scan_kernel.launches, argmax_last_kernel.launches
        ticks = []
        while not e.idle():
            e.step()
            ticks.append((e.last_tick["decode_batch"], e.last_tick["prefill_lens"]))
        runs.append((e, ticks, ssd_scan_kernel.launches - ssd0,
                     argmax_last_kernel.launches - argmax0))
    (ge, gticks, g_ssd, g_argmax), (ce, cticks, c_ssd, c_argmax) = runs
    decode_ticks = sum(1 for t in gticks if t[0])
    assert g_ssd == cfg.n_layers * ge.stats["prefills"] and c_ssd == c_argmax == 0
    assert g_argmax == decode_ticks + ge.stats["prefills"]
    assert gticks == cticks
    assert {r.uid: r.out_tokens for r in ge.finished} == \
           {r.uid: r.out_tokens for r in ce.finished}


@pytest.mark.parametrize("n,s,dtype", [(2, 1 << 20, torch.float32), (2, 1_000_003, torch.float32),
                                       (7, 2500, torch.float32), (16, 4096, torch.bfloat16),
                                       (3, 1001, torch.bfloat16), (1, 10, torch.float32)])
def test_chunk_accumulate_kernel_matches_plain(cuda, n, s, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n * 31 + s)
    x = torch.randn((n, s), generator=gen, device=cuda).to(dtype)
    before = chunk_accumulate_kernel.launches
    got = accumulate(x)
    assert chunk_accumulate_kernel.launches == before + 1
    want = accumulate(x, impl="ref")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (s,)
    if n <= 2 and dtype == torch.float32:
        assert torch.equal(got, want)
        if n == 2:
            assert torch.equal(got, x[0] + x[1])
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_chunk_accumulate_kernel_takes_an_unaligned_view(cuda):
    x = torch.randn((2, 4097), device=cuda)[:, 1:]  # rows not 16-byte aligned
    got = accumulate(x)
    torch.cuda.synchronize()
    assert torch.equal(got, x[0] + x[1])


@pytest.mark.parametrize("n,bins,dtype", [(3000, 700, torch.float32), (100, 16, torch.float32),
                                          (1 << 20, 151_936, torch.float32),
                                          (50_000, 12_288, torch.bfloat16)])
def test_histogram_kernel_matches_plain(cuda, n, bins, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n + bins)
    keys = torch.randint(-1, bins + bins // 8, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    counts = (torch.rand((n,), generator=gen, device=cuda) * 5).to(dtype)
    before = histogram_kernel.launches
    got = keyed_histogram(keys, counts, bins)
    assert histogram_kernel.launches == before + 1
    want = keyed_histogram(keys, counts, bins, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# one n_bins on each side of the plan's path boundary, qwen's vocabulary,
# and the global path at eight blocks' worth of bins
HIST_EDGES = [4096, CTA_BINS, CTA_BINS + 1, 151_936, 464_896, 464_897]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bins", HIST_EDGES)
def test_histogram_kernel_at_plan_boundaries(cuda, bins, dtype):
    gen = torch.Generator(device=cuda).manual_seed(bins)
    n = 1 << 21
    keys = torch.randint(-1, bins + bins // 8, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    counts = (torch.rand((n,), generator=gen, device=cuda) * 5).to(dtype)
    before = histogram_kernel.launches
    got = keyed_histogram(keys, counts, bins)
    assert histogram_kernel.launches == before + 1
    torch.testing.assert_close(got, keyed_histogram(keys, counts, bins, impl="ref"),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("bins", HIST_EDGES)
def test_histogram_kernel_one_bin_takes_every_key(cuda, bins, where):
    """The worst contention: all 2^22 keys in one bin (the first, a
    middle or the last), counts of 1: exact."""
    key = {"first": 0, "middle": bins // 2, "last": bins - 1}[where]
    n = 1 << 22
    keys = torch.full((n,), key, dtype=torch.int32, device=cuda)
    got = keyed_histogram(keys, torch.ones(n, device=cuda), bins)
    want = torch.zeros(bins, device=cuda)
    want[key] = n
    assert torch.equal(got, want)


@pytest.mark.parametrize("bins", [700, 151_936, 464_897])
def test_histogram_kernel_padding_only(cuda, bins):
    keys = torch.full((100_003,), -1, dtype=torch.int32, device=cuda)
    keys[::7] = bins + 3  # past the last bin: dropped too
    got = keyed_histogram(keys, torch.ones(keys.shape[0], device=cuda), bins)
    assert torch.equal(got, torch.zeros(bins, device=cuda))


# N not a multiple of the 8-key group, and views at offsets that leave
# keys, counts or both off a 16-byte boundary (keys[1:] with counts[2:]
# are never aligned together: all scalar)
@pytest.mark.parametrize("key_off,count_off", [(0, 0), (1, 1), (1, 0), (0, 2), (1, 2), (3, 3)])
@pytest.mark.parametrize("n", [1, 13, 100_003])
@pytest.mark.parametrize("bins", [700, 151_936, 464_897])
def test_histogram_kernel_reads_unaligned_views(cuda, bins, n, key_off, count_off):
    gen = torch.Generator(device=cuda).manual_seed(n + key_off)
    keys = torch.randint(-1, bins, (n + 3,), generator=gen, device=cuda,
                         dtype=torch.int32)[key_off:key_off + n]
    counts = torch.randint(0, 4, (n + 3,), generator=gen, device=cuda).float()
    counts = counts[count_off:count_off + n]
    got = keyed_histogram(keys, counts, bins)
    assert torch.equal(got, keyed_histogram(keys, counts, bins, impl="ref"))


@pytest.mark.parametrize("bins", [CTA_BINS + 1, 151_936, 464_896])
def test_histogram_kernel_hot_key_among_spread_keys(cuda, bins):
    """Every fourth key is the last bin (it claims cache slots and repeats
    within warps), the rest spread over the bins and past them; integer
    counts (exact), whole and through an unaligned view."""
    gen = torch.Generator(device=cuda).manual_seed(bins)
    n = 1 << 20
    keys = torch.randint(-1, bins + bins // 8, (n + 1,), generator=gen, device=cuda,
                         dtype=torch.int32)
    keys[::4] = bins - 1
    counts = torch.randint(0, 4, (n + 1,), generator=gen, device=cuda).float()
    for k, c in [(keys[:n], counts[:n]), (keys[1:], counts[1:])]:
        before = histogram_kernel.launches
        got = keyed_histogram(k, c, bins)
        assert histogram_kernel.launches == before + 1
        assert torch.equal(got, keyed_histogram(k, c, bins, impl="ref"))


def test_histogram_kernel_drops_keys_past_the_last_bin(cuda):
    keys = torch.tensor([0, 5, 7, 9, -1, 12], dtype=torch.int32, device=cuda)
    got = keyed_histogram(keys, torch.full((6,), 2.0, device=cuda), 8)
    assert got.cpu().tolist() == [2, 0, 0, 0, 0, 2, 0, 2]


def test_stream_reduce_kernels_reject_what_they_cannot_take(cuda):
    with pytest.raises(TypeError, match="f32/bf16"):
        accumulate(torch.zeros((2, 8), dtype=torch.float16, device=cuda))
    with pytest.raises(TypeError, match="int32"):
        keyed_histogram(torch.zeros(4, dtype=torch.int64, device=cuda),
                        torch.ones(4, device=cuda), 4)
    with pytest.raises(ValueError, match="one device"):
        keyed_histogram(torch.zeros(4, dtype=torch.int32, device=cuda), torch.ones(4), 4)


def test_two_row_world_folds_a_wave_through_the_kernel(cuda):
    """Row 0 streams 3 MiB in 1 MiB wire chunks to row 1 over gloo; the
    reducer folds the one wave with one chunk_accumulate launch (the
    default on a CUDA device), bit for bit the in-scan add and the sent
    payload (0 + x)."""
    sender, reducer = spawn(cuda_fold_case, 2, device="cuda", timeout_s=120)
    assert reducer["launches"] == 1 and sender["launches"] == 0
    for k, v in reducer["payload"].items():
        np.testing.assert_array_equal(reducer["kernel"][k], v)
        np.testing.assert_array_equal(reducer["scan"][k], v)
        assert not sender["kernel"][k].any()
    assert sender["stats"]["sent_bytes"] == reducer["stats"]["recv_bytes"] == 2 * 3 * (1 << 20)
    assert reducer["stats"]["h2d_bytes"] >= reducer["stats"]["recv_bytes"]


# -- the accumulating histogram, the stream operators and the word count -------------

@pytest.mark.parametrize("bins", [4096, CTA_BINS, CTA_BINS + 1, 151_936])
def test_histogram_kernel_adds_into_an_accumulator(cuda, bins):
    """``out=``: one launch adds the keys' counts into a nonzero
    accumulator in place (block and global paths), exact at counts of 1;
    padding and keys past the last bin add nothing."""
    gen = torch.Generator(device=cuda).manual_seed(bins + 1)
    n = 1 << 20
    keys = torch.randint(-1, bins + bins // 8, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    acc = torch.randint(0, 1000, (bins,), generator=gen, device=cuda).float()
    want = acc + keyed_histogram(keys, torch.ones(n, device=cuda), bins, impl="ref")
    before = histogram_kernel.launches
    got = histogram_kernel(keys, torch.ones(n, device=cuda), bins, out=acc)
    assert histogram_kernel.launches == before + 1
    assert got is acc
    assert torch.equal(acc, want)


def test_histogram_kernel_refuses_a_bad_accumulator(cuda):
    keys = torch.zeros(8, dtype=torch.int32, device=cuda)
    counts = torch.ones(8, device=cuda)
    for out in (torch.zeros(16), torch.zeros(16, dtype=torch.float64, device=cuda),
                torch.zeros(32, device=cuda)[::2], torch.zeros(17, device=cuda)):
        with pytest.raises(ValueError, match="out must be"):
            keyed_histogram(keys, counts, 16, out=out)


@pytest.mark.parametrize("bins", [500, 32_000, 151_936])
def test_histogram_op_on_the_card_matches_plain(cuda, bins):
    """`histogram_op` (MapReduce's fold, `histogram_fold`) over CUDA
    ``[keys | counts]`` elements with padding (-1) and keys past the last
    bin (clamped into it, as the reference clips): one launch per element,
    exact against the same fold on the CPU (the plain version)."""
    from repro_torch.core.operators import histogram_op

    rng = np.random.default_rng(bins)
    s = 8192
    keys = rng.integers(-1, bins + 50, size=(5, s)).astype(np.float32)
    counts = rng.integers(0, 2, size=(5, s)).astype(np.float32)
    elems = torch.from_numpy(np.concatenate([keys, counts], axis=1))
    op = histogram_op(bins, s, device=cuda)
    acc = op.init()
    before = histogram_kernel.launches
    for k, e in enumerate(elems.to(cuda)):
        acc = op.apply(acc, e, k)
    assert histogram_kernel.launches == before + 5
    plain = torch.zeros(bins)
    for k, e in enumerate(elems):
        plain = op.apply(plain, e, k)
    assert torch.equal(acc.cpu(), plain)
    assert plain[bins - 1] > 0


@pytest.mark.parametrize("granularity", [256, 100])
def test_wordcount_world_on_the_card(cuda, granularity):
    """An 8-rank world on the card: the word count in every mode, on every
    row, bit for bit `np.bincount` of the valid words, the histogram
    kernel launched as often as the schedule says (summed over ranks)."""
    from repro_torch.apps.mapreduce import MODES, CorpusCfg, histogram_launches, make_corpus

    ranks = spawn(cuda_wordcount_case, N_ROWS, device="cuda", args=(granularity,),
                  timeout_s=300)
    cfg = CorpusCfg(**WC_CFG)
    tokens, mask = make_corpus(cfg, cfg.n_docs_per_row * N_ROWS)
    host = np.bincount(tokens[mask > 0], minlength=cfg.vocab).astype(np.float32)
    for mode in MODES:
        for r in ranks:
            assert r[mode]["device"].startswith("cuda")
            np.testing.assert_array_equal(r[mode]["hist"], host)
        launches = sum(r[mode]["launches"] for r in ranks)
        assert launches == histogram_launches(mode, cfg, N_ROWS, granularity_words=granularity)
        assert launches > 0


def test_wordcount_world_runs_on_the_card(cuda):
    from repro_torch.apps.mapreduce import CorpusCfg, make_corpus, wordcount_world

    cfg = CorpusCfg(**WC_CFG)
    hists = wordcount_world(cfg, device=None, n_rows=N_ROWS)
    tokens, mask = make_corpus(cfg, cfg.n_docs_per_row * N_ROWS)
    for h in hists.values():
        np.testing.assert_array_equal(h, np.bincount(tokens[mask > 0], minlength=cfg.vocab))


# -- the CG and PIC apps (no kernel of their own: the card's PyTorch ops) -----------

def _particle_buffers(seed: int, cap: int, fill: float, n_in: int):
    """A buffer with about ``fill`` of its slots valid (scattered, so the
    sort meets long runs of ties), and ``n_in`` arrivals scattered over a
    buffer of the same capacity."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(cap, np.float32)
    mask[rng.permutation(cap)[:n_in]] = 1.0
    return [torch.from_numpy(a) for a in (
        rng.uniform(0, 1, cap).astype(np.float32), rng.normal(size=cap).astype(np.float32),
        (rng.uniform(size=cap) < fill).astype(np.float32),
        rng.uniform(0, 1, cap).astype(np.float32), rng.normal(size=cap).astype(np.float32),
        mask)]


@pytest.mark.parametrize("fill,n_in", [(0.35, 200_000), (0.7, 400_000), (0.0, 1 << 20)])
def test_pic_merge_in_on_the_card_matches_cpu(cuda, fill, n_in):
    """`_merge_in` at the smoke's capacity, 2^20 slots, bit for bit against
    the CPU (stable sorts on both; the second case overflows the free
    slots, the third fills an empty buffer)."""
    from repro_torch.apps.pic import _merge_in

    arrays = _particle_buffers(int(fill * 10) + n_in, 1 << 20, fill, n_in)
    want = _merge_in(*arrays)
    got = _merge_in(*[a.to(cuda) for a in arrays])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[2].sum()) == min(1 << 20, int(arrays[2].sum()) + n_in)


def test_pic_compact_on_the_card_matches_cpu(cuda):
    from repro_torch.apps.pic import _compact

    x, v, valid = _particle_buffers(11, 1 << 20, 0.5, 0)[:3]
    want = _compact(x, v, valid)
    got = _compact(x.to(cuda), v.to(cuda), valid.to(cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_pic_buckets_on_the_card_match_cpu(cuda):
    """The comm row's bucketing of 7 rows of 2^20 slots, one destination
    over capacity."""
    from repro_torch.apps.pic import _buckets

    rng = np.random.default_rng(12)
    n, cap = 7, 1 << 20
    m = (rng.uniform(size=(n, cap)) < 0.2).astype(np.float32)
    m[0] = 1.0
    dst = np.where(m > 0, rng.integers(0, n, size=(n, cap)), -1).astype(np.float32)
    dst[0] = 3.0
    table = torch.from_numpy(np.stack([rng.uniform(size=(n, cap)).astype(np.float32) * m,
                                       rng.normal(size=(n, cap)).astype(np.float32) * m,
                                       m, dst]))
    want = _buckets(table, list(range(n)), cap)
    assert torch.equal(_buckets(table.to(cuda), list(range(n)), cap).cpu(), want)
    assert int(want[3, 2].sum()) == cap


def test_cg_stencil_on_the_card_matches_cpu(cuda):
    """The matvec's arithmetic at the smoke's slab (144 x 120 x 120): inner
    Laplacian, both halo planes, negation, bit for bit."""
    from repro_torch.apps.cg import _apply_halo, _laplacian_inner

    rng = np.random.default_rng(13)
    u, below, above = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                       for s in ((144, 120, 120), (120, 120), (120, 120)))
    want = -_apply_halo(_laplacian_inner(u), below, above)
    got = -_apply_halo(_laplacian_inner(u.to(cuda)), below.to(cuda), above.to(cuda))
    assert torch.equal(got.cpu(), want)


def test_cg_and_pic_worlds_run_on_the_card(cuda):
    """`cg_world` and `pic_world` at the reference tests' sizes on the card
    (their default device): blocking and nonblocking bit for bit, each
    mode converging; every PIC run conserving its particles, each on the
    row that owns it."""
    from repro_torch.apps.cg import CGCfg, cg_world
    from repro_torch.apps.pic import RUNS, PICCfg, pic_world

    cg = cg_world(CGCfg(nx_local=14, ny=12, nz=12, n_iters=20), n_rows=N_ROWS)
    for got, want in zip(cg["nonblocking"], cg["blocking"]):
        np.testing.assert_array_equal(got, want)
    assert all(hist[-1] < hist[0] for _, _, hist in cg.values())
    cfg = PICCfg(capacity=1024, n_particles_total=1024, n_steps=3, dt=0.15)
    pic = pic_world(cfg, n_rows=N_ROWS)
    for (name, _, _), rows in zip(RUNS, (8, 7, 6)):
        x, _, m, counts = pic[name][:4]
        assert (counts.sum(0) == cfg.n_particles_total).all(), name
        for r in range(rows):
            owner = np.floor(x[r][m[r] > 0] / np.float32(1.0 / rows))
            assert (owner == r).all(), (name, r)
    assert pic["decoupled_io"][4].tolist() == [0] * 7 + [54]


# -- the training path: data-parallel steps and checkpoints on the card ---------------

TRAIN_PARITY_REL = 1e-4


def test_data_parallel_steps_on_the_card_match_cpu(cuda):
    gpu = spawn(data_parallel_case, 2, device="cuda", timeout_s=300)
    cpu = spawn(data_parallel_case, 2, device="cpu", timeout_s=300)
    assert gpu[0]["device"].startswith("cuda") and cpu[0]["device"] == "cpu"
    gmax = max(float(np.abs(a - b).max()) for a, b in zip(cpu[0]["p0"], cpu[0]["conventional"]))
    assert gmax > 1e-3  # it moved
    for mode in ("conventional", "overlap"):
        for row in range(2):
            diff = max(float(np.abs(a - b).max())
                       for a, b in zip(gpu[row][mode], cpu[0][mode]))
            assert diff <= TRAIN_PARITY_REL * gmax, (mode, row, diff / gmax)
        assert gpu[0][mode + "/loss"] == pytest.approx(cpu[0][mode + "/loss"], rel=1e-5)


def test_cuda_state_round_trips_through_a_checkpoint(cuda, tmp_path):
    from repro_torch.io import checkpoint as ckpt
    from repro_torch.utils.treeutil import tree_leaves, tree_meta

    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {"params": {"w": torch.randn((1000, 77), generator=gen, device="cuda"),
                        "layers": [{"b": torch.randn((13,), generator=gen, device="cuda")}]},
             "opt": {"step": 5, "count": torch.arange(7, device="cuda", dtype=torch.int32)},
             "step": 5}
    before = [t.clone() for t in tree_leaves(state) if isinstance(t, torch.Tensor)]
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=1)
    saver.save(5, state)
    for t in tree_leaves(state):  # an in-place update right after save returns
        if isinstance(t, torch.Tensor):
            t.add_(1)
    saver.close()
    like = {**state, "params": tree_meta(state["params"]),
            "opt": {**state["opt"], "count": tree_meta(state["opt"]["count"])}}
    back = ckpt.restore(str(tmp_path), 5, like, device="cuda")
    got = [t for t in tree_leaves(back) if isinstance(t, torch.Tensor)]
    assert all(t.is_cuda for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, before))
    assert back["step"] == 5 and back["opt"]["step"] == 5


def _replay(model, params, *, trace_on=False):
    """`bursty-prefix` (horizon cut to 24 ticks) through the multi-tenant
    scheduler and the paged engine, as `examples/serve_lm.py` builds them:
    (engine, per-tick logits on the host)."""
    from repro_torch.obs import trace
    from repro_torch.serve.sched import FleetScheduler
    from repro_torch.serve.traffic import replay, scenario

    sc = dataclasses.replace(scenario("bursty-prefix"), horizon=24)
    if trace_on:
        trace.enable()
    try:
        e = make_engine(model, params,
                        EngineConfig(mode="continuous", max_batch=4, max_len=160,
                                     kv=KVSpec(kind="paged", block_size=16, prefix_cache=True)),
                        sched=FleetScheduler(sc.tenants, token_budget=200, aging=0.05))
        logits = []
        replay(e, sc, model.cfg.vocab_size,
               on_tick=lambda eng: logits.append(
                   eng.last_logits.cpu() if eng.last_tick["decode_batch"] else None))
    finally:
        tracer = trace.disable()
    if trace_on:
        life = tracer.lifecycle_report()
        assert life["begins"] == life["ends"] == len(e.finished) and life["open"] == []
    return e, logits


def test_scenario_replay_on_gpu_matches_cpu(cuda):
    """The same f32 weights replay the same scenario on both devices (the
    kernels on the card, their plain versions on the CPU): the same
    streams, first-token and done ticks, and ledger."""
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    cpu_model, gpu_model = build(cfg, device="cpu"), build(cfg, device="cuda")
    params = cpu_model.init(0)
    paged0 = paged_decode_attention_kernel.launches
    ge, _ = _replay(gpu_model, _to(params, cuda))
    assert paged_decode_attention_kernel.launches > paged0
    ce, _ = _replay(cpu_model, params)
    by_uid = [{r.uid: (r.out_tokens, r.first_token_tick, r.done_tick) for r in e.finished}
              for e in (ge, ce)]
    assert by_uid[0] == by_uid[1] and len(by_uid[0]) > 20
    assert ge.ledger.snapshot() == ce.ledger.snapshot()


def test_tracing_on_the_card_does_not_change_logits(cuda):
    """Tracing is host-side only: the same replay on the card with the
    tracer off and on gives bit-identical logits every tick."""
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    model = build(cfg, device="cuda")
    params = model.init(0)
    off, logits_off = _replay(model, params)
    on, logits_on = _replay(model, params, trace_on=True)
    assert len(logits_off) == len(logits_on)
    for a, b in zip(logits_off, logits_on):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    assert {r.uid: r.out_tokens for r in off.finished} == \
           {r.uid: r.out_tokens for r in on.finished}
