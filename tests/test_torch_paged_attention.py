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
