"""PyTorch port, flash attention and blockwise attention: the port's
plain `attention_ref` against the reference's `attention_ref` and against
the reference's Pallas kernel run by the Pallas interpreter (as
tests/test_kernels.py runs it on the CPU), the port's
`layers.attention_blockwise` against the reference's, and the op's
dispatch. Inputs are numpy draws from a seed handed to both packages.
The CUDA kernel is held against the plain version on the card, in
tests/test_torch_cuda.py.

Geometries are tests/test_kernels.py's: GQA, Sq != Sk with a window,
ragged MQA without causality, ragged with a window.

Tolerances, with their reasons:
  * f32: 2e-5, the reference kernel test's own budget (the Pallas kernel
    streams the softmax in 128-key blocks, the plain versions take it
    whole; CPU summation orders differ);
  * bf16: 2e-2, the same test's budget (outputs are rounded to bf16, and
    blockwise attention also rounds its scores and probabilities to
    bf16, where a one-ulp difference in a score moves the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha as j_mha
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import layers as jl
from repro_torch.kernels.flash_attention import attention_ref, flash_attention_kernel, mha
from repro_torch.models import layers as tl

GEOMETRIES = [  # b, sq, sk, h, kv, d, causal, window
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 384, 8, 8, 32, True, 64),
    (2, 100, 100, 4, 1, 128, False, 0),  # ragged, MQA
    (1, 300, 300, 2, 2, 64, True, 128),  # ragged + window
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _pair(arrays, dtype):
    """The same numpy draws as reference and port tensors of ``dtype``
    (both round f32 to bf16 to nearest even: identical bits)."""
    jd, td, _ = DTYPES[dtype]
    return [jnp.asarray(a, jd) for a in arrays], [torch.from_numpy(a).to(td) for a in arrays]


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", GEOMETRIES)
def test_attention_ref_matches_reference_ref(b, sq, sk, h, kv, d, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _pair(_draw(sq + d, (b, h, sq, d), (b, kv, sk, d),
                                             (b, kv, sk, d)), dtype)
    got = attention_ref(tq, tk, tv, causal=causal, window=window)
    want = j_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == (b, h, sq, d)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", GEOMETRIES)
def test_mha_matches_reference_pallas_kernel(b, sq, sk, h, kv, d, causal, window, dtype):
    """The port's op on a CPU tensor (the plain version) against the
    reference's Pallas kernel in the interpreter, model layout."""
    (jq, jk, jv), (tq, tk, tv) = _pair(_draw(sq + 7 * d, (b, sq, h, d), (b, sk, kv, d),
                                             (b, sk, kv, d)), dtype)
    got = mha(tq, tk, tv, causal=causal, window=window)
    want = j_mha(jq, jk, jv, causal=causal, window=window, interpret=True)
    assert got.shape == (b, sq, h, d)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sq,sk,h,kv,window,kv_block", [
    (40, 40, 4, 2, 9, 16),     # Sk not a multiple of the block; the window masks the padding
    (48, 48, 4, 1, 0, 16),     # whole blocks, full causal
    (30, 30, 2, 2, 0, 12),     # padded K positions at window 0, live as in the reference
    (64, 64, 8, 2, 20, 64),    # one block
])
def test_attention_blockwise_matches_reference(sq, sk, h, kv, window, kv_block, dtype):
    d = 16
    (jq, jk, jv), (tq, tk, tv) = _pair(_draw(sq + window, (2, sq, h, d), (2, sk, kv, d),
                                             (2, sk, kv, d)), dtype)
    scale = 1.0 / np.sqrt(d)
    got = tl.attention_blockwise(tq, tk, tv, torch.arange(sq), torch.arange(sk), window, scale,
                                 kv_block=kv_block)
    want = jl.attention_blockwise(jq, jk, jv, jnp.arange(sq), jnp.arange(sk), window, scale,
                                  kv_block=kv_block)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, DTYPES[dtype][2])


def test_attention_blockwise_equals_plain_on_whole_blocks():
    """Inside the port: with whole blocks the streamed softmax is the
    plain attention's (f32)."""
    q, k, v = (torch.from_numpy(a) for a in _draw(1, (1, 64, 4, 16), (1, 64, 2, 16),
                                                      (1, 64, 2, 16)))
    pos = torch.arange(64)
    for window in (0, 10):
        got = tl.attention_blockwise(q, k, v, pos, pos, window, 0.25, kv_block=16)
        want = tl.attention_plain(q, k, v, tl.causal_window_mask(pos, pos, window), 0.25)
        torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)


def test_mha_dispatch_on_cpu():
    """A CPU tensor takes the plain version, exactly, and launches
    nothing; the kernel wrapper refuses CPU tensors; an unknown impl
    raises."""
    q, k, v = (torch.from_numpy(a) for a in _draw(2, (2, 33, 8, 16), (2, 33, 2, 16),
                                                      (2, 33, 2, 16)))
    before = flash_attention_kernel.launches
    got = mha(q, k, v, window=5)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         window=5).transpose(1, 2)
    assert torch.equal(got, want)
    assert torch.equal(mha(q, k, v, window=5, impl="ref"), want)
    assert flash_attention_kernel.launches == before


def test_flash_kernel_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _draw(3, (1, 2, 8, 16), (1, 1, 8, 16),
                                                      (1, 1, 8, 16)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_kernel(q, k, v)


def test_mha_rejects_unknown_impl():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="unknown impl"):
        mha(q, q, q, impl="pallas")
