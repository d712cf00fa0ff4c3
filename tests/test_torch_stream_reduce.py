"""PyTorch port, the stream-reduce kernel family: `chunk_accumulate_ref`
and `histogram_ref` against the JAX package's plain versions and its
Pallas kernels (run in the interpreter, as tests/test_kernels.py runs
them), on the same numpy inputs on the CPU.

Tolerances: the column sum is exact at n = 2 (one rounding either way,
the stream channel's call) and 1e-6 relative otherwise (summation
order); the histogram 1e-5 relative (the Pallas kernel sums by a one-hot
product, another order). Then the CUDA histogram's plans against their
rules, and a numpy emulation of its warp aggregation. The CUDA kernels
are tested on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.stream_reduce.ops import accumulate as j_accumulate
from repro.kernels.stream_reduce.ops import keyed_histogram as j_keyed_histogram
from repro.kernels.stream_reduce.ref import chunk_accumulate_ref as j_chunk_accumulate_ref
from repro.kernels.stream_reduce.ref import histogram_ref as j_histogram_ref
from repro_torch.kernels.stream_reduce import (
    accumulate,
    chunk_accumulate_kernel,
    chunk_accumulate_ref,
    histogram_kernel,
    histogram_ref,
    keyed_histogram,
)
from repro_torch.kernels.stream_reduce.stream_reduce import (
    CTA_BINS,
    histogram_plan,
)


# tests/test_kernels.py's shapes, the channel's n = 2, and a ragged S
@pytest.mark.parametrize("chunks,s", [(7, 2500), (1, 10), (16, 1024), (2, 1000), (2, 1003)])
def test_chunk_accumulate_ref_matches_jax(chunks, s):
    el = np.random.default_rng(chunks * 7 + s).normal(size=(chunks, s)).astype(np.float32)
    got = chunk_accumulate_ref(torch.from_numpy(el)).numpy()
    assert got.dtype == np.float32 and got.shape == (s,)
    want_ref = np.asarray(j_chunk_accumulate_ref(jnp.asarray(el)))
    want_kernel = np.asarray(j_accumulate(jnp.asarray(el), interpret=True))
    if chunks <= 2:
        np.testing.assert_array_equal(got, want_ref)
        np.testing.assert_array_equal(got, want_kernel)
    else:
        np.testing.assert_allclose(got, want_ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, want_kernel, rtol=1e-6, atol=1e-6)


def test_chunk_accumulate_ref_takes_bf16_into_f32():
    el = np.random.default_rng(1).normal(size=(4, 300)).astype(ml_dtypes.bfloat16)
    got = chunk_accumulate_ref(torch.from_numpy(el.view(np.uint16)).view(torch.bfloat16))
    want = np.asarray(j_accumulate(jnp.asarray(el), interpret=True))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,bins", [(3000, 700), (512, 2000), (100, 16)])
def test_histogram_ref_matches_pallas_and_jax_ref(n, bins):
    rng = np.random.default_rng(n + bins)
    # padding (-1), every bin, and keys past the last bin
    keys = rng.integers(-1, bins + bins // 4, size=(n,)).astype(np.int32)
    counts = rng.uniform(0, 5, size=(n,)).astype(np.float32)
    got = histogram_ref(torch.from_numpy(keys), torch.from_numpy(counts), bins).numpy()
    kernel = np.asarray(j_keyed_histogram(jnp.asarray(keys), jnp.asarray(counts), bins,
                                          interpret=True))
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
    inside = keys < bins  # where the reference's plain version clamps
    ref = np.asarray(j_histogram_ref(jnp.asarray(keys[inside]), jnp.asarray(counts[inside]),
                                     bins))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_histogram_drops_keys_past_the_last_bin_as_the_tpu_kernel_does():
    keys = np.array([0, 5, 7, 9, -1, 12], np.int32)
    counts = np.full(6, 2.0, np.float32)
    got = histogram_ref(torch.from_numpy(keys), torch.from_numpy(counts), 8).numpy()
    kernel = np.asarray(j_keyed_histogram(jnp.asarray(keys), jnp.asarray(counts), 8,
                                          interpret=True))
    ref = np.asarray(j_histogram_ref(jnp.asarray(keys), jnp.asarray(counts), 8))
    np.testing.assert_array_equal(got, [2, 0, 0, 0, 0, 2, 0, 2])
    np.testing.assert_array_equal(got, kernel)
    assert ref[7] == 6.0  # the reference's plain version clamps 9 and 12 into bin 7


def test_ops_dispatch_cpu_tensors_to_the_plain_version():
    el = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    keys = torch.tensor([0, 3, 3, -1], dtype=torch.int32)
    counts = torch.ones(4)
    before = (chunk_accumulate_kernel.launches, histogram_kernel.launches)
    torch.testing.assert_close(accumulate(el), chunk_accumulate_ref(el), rtol=0, atol=0)
    torch.testing.assert_close(keyed_histogram(keys, counts, 4),
                               torch.tensor([1.0, 0.0, 0.0, 2.0]), rtol=0, atol=0)
    assert (chunk_accumulate_kernel.launches, histogram_kernel.launches) == before
    with pytest.raises(ValueError, match="impl"):
        accumulate(el, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        chunk_accumulate_kernel(el)


# the CUDA kernel's plan: the path from n_bins alone; on the block path
# one block holds every bin (each bin has that block as its one owner),
# in whole float4 words and within its 227 KB of shared memory
@pytest.mark.parametrize("n_bins", [1, 3, 4096, CTA_BINS - 1, CTA_BINS, CTA_BINS + 1, 151_936,
                                    2 * CTA_BINS, 464_896, 464_897, 10 ** 6])
def test_histogram_plan_gives_every_bin_one_owner(n_bins):
    path, block_bins = histogram_plan(n_bins)
    assert path == ("block" if n_bins <= CTA_BINS else "global")
    if path == "global":
        assert block_bins == 0
    else:
        assert block_bins % 4 == 0 and block_bins * 4 <= 232_448
        assert n_bins <= block_bins < n_bins + 4


def _warp_add(keys, counts):
    """numpy emulation of the kernel's warp aggregation over one warp's 32
    lanes: group equal keys (`__match_any_sync`), sum each group by
    pointer jumping down its lanes, and let its lowest lane add the sum.
    Returns the (key, sum) pairs the warp's atomics would add."""
    lanes = np.arange(32)
    peers = [np.flatnonzero(keys == k) for k in keys]
    nxt = np.array([next((p for p in peers[i] if p > i), -1) for i in lanes])
    v = counts.astype(np.float32).copy()
    while (nxt >= 0).any():
        src = np.where(nxt >= 0, nxt, lanes)
        ov, on = v[src], nxt[src]
        v = np.where(nxt >= 0, v + ov, v)
        nxt = np.where(nxt >= 0, on, nxt)
    return [(keys[i], v[i]) for i in lanes if keys[i] >= 0 and peers[i][0] == i]


@pytest.mark.parametrize("distinct", [1, 2, 5, 32])
def test_warp_aggregation_emulation_sums_each_key_once(distinct):
    rng = np.random.default_rng(distinct)
    for _ in range(50):
        keys = rng.integers(-1, distinct, size=32)
        counts = rng.integers(0, 5, size=32).astype(np.float32)
        adds = _warp_add(keys, counts)
        assert len(adds) == len({k for k in keys if k >= 0})
        want = np.zeros(distinct, np.float32)
        np.add.at(want, keys[keys >= 0], counts[keys >= 0])
        got = np.zeros(distinct, np.float32)
        for k, s in adds:
            got[k] += s
        np.testing.assert_array_equal(got, want)
