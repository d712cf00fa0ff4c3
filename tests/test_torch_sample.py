"""PyTorch port, last-token sampling: the port's plain version against
the reference's plain version and its Pallas argmax kernel (interpret
mode) on the same numpy logits, ties and top-k included, and the op's
dispatch; the CUDA kernel's split (`argmax_split`) against its rules, and
a numpy emulation of its split-then-merge schedule against the
reference's kernel and jnp.argmax. Token ids are compared exactly:
argmax has no tolerance. The CUDA argmax kernel is held against the
plain version in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sample import sample_last as j_sample_last
from repro_torch.kernels.sample import argmax_last_kernel, sample_last, sample_last_ref
from repro_torch.kernels.sample.sample import MIN_SPAN_BYTES, SMS, SPAN_UNIT, argmax_split

RNG = np.random.default_rng(0)


def _tied_logits():
    x = np.full((3, 2, 1024), -1.0, np.float32)
    x[0, -1, [3, 699]] = 7.0   # duplicate max across the reference's chunk boundary
    x[1, -1, :] = 0.0          # all equal: index 0
    x[2, -1, [1023, 5]] = 2.0  # the lower index wins wherever it lies
    return x


@pytest.mark.parametrize("tied", [False, True])
def test_argmax_matches_reference(tied):
    x = _tied_logits() if tied else RNG.normal(size=(4, 3, 1000)).astype(np.float32)
    got = sample_last(torch.from_numpy(x))
    assert got.dtype == torch.int32
    for kw in ({"impl": "ref"}, {"impl": "kernel", "interpret": True}):
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_sample_last(jnp.asarray(x), **kw)))


def test_topk_matches_reference():
    x = RNG.normal(size=(2, 1, 128)).astype(np.float32)
    got = sample_last(torch.from_numpy(x), k=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_sample_last(jnp.asarray(x), k=3)))


def test_op_dispatch_on_cpu():
    x = torch.from_numpy(RNG.normal(size=(2, 1, 64)).astype(np.float32))
    before = argmax_last_kernel.launches
    assert torch.equal(sample_last(x), sample_last_ref(x))
    assert argmax_last_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        argmax_last_kernel(x[:, -1])  # no CPU mode
    with pytest.raises(ValueError, match="impl"):
        sample_last(x, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        sample_last(x, impl="pallas")


# the kernel's split (`argmax_split`): spans of a multiple of 64 elements
# that cover [0, V) once, none empty, B x splits blocks covering the SMs
# wherever spans of at least 2 KB allow it
@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("vocab", [1, 7, 1000, 5000, 32_000, 32_001, 50_280, 151_936])
@pytest.mark.parametrize("b", [1, 2, 8, 64])
def test_argmax_split_covers_each_row_once(b, vocab, elt):
    span, splits = argmax_split(b, vocab, elt)
    assert span % SPAN_UNIT == 0
    bounds = [(j * span, min((j + 1) * span, vocab)) for j in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == vocab
    assert all(lo < hi for lo, hi in bounds)
    assert all(bounds[j][1] == bounds[j + 1][0] for j in range(splits - 1))
    least = -(-(MIN_SPAN_BYTES // elt) // SPAN_UNIT) * SPAN_UNIT
    assert span >= least
    assert b * splits >= SMS or span == least or splits == 1
    assert b * splits <= b + SMS - 1  # the pairs the wrapper's scratch holds


def _better(p, q):
    """The kernel's rule: NaN above all, then the larger value, ties (and
    NaN against NaN) to the lower index."""
    (pv, pi), (qv, qi) = p, q
    if np.isnan(pv) != np.isnan(qv):
        return bool(np.isnan(pv))
    if not np.isnan(pv) and pv != qv:
        return bool(pv > qv)
    return pi < qi


def _split_argmax(last, elt):
    """numpy emulation of the CUDA kernel: each split's (value, first
    index) pair, then the last block's merge of the row's pairs."""
    b, vocab = last.shape
    span, splits = argmax_split(b, vocab, elt)
    out = []
    for row in last:
        best = None
        for j in range(splits):
            seg = row[j * span:(j + 1) * span]
            pair = None
            for i, v in enumerate(seg):
                if pair is None or _better((v, j * span + i), pair):
                    pair = (v, j * span + i)
            if best is None or _better(pair, best):
                best = pair
        out.append(best[1])
    return np.array(out, np.int32)


def _split_edge_rows(vocab, elt, b=6):
    rows = RNG.normal(size=(b, vocab)).astype(np.float32)
    span, splits = argmax_split(b, vocab, elt)
    starts = [span * j for j in range(1, splits)]
    rows[0, starts + [vocab - 1]] = 9.0             # a tie at every split's first element
    rows[1, [s - 1 for s in starts] + [vocab - 1]] = 9.0  # ... at every split's last element
    rows[2, [0, vocab - 1]] = 9.0                   # at both ends of the row
    rows[3] = -1.0                                  # all equal
    rows[4, starts[-1:] + [5]] = 9.0                # the lower index wins across splits
    return rows


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("vocab", [1100, 2049, 5000])
def test_split_argmax_emulation_matches_the_reference(vocab, elt):
    """The split-then-merge schedule against the reference's Pallas
    kernel (interpret mode) and jnp.argmax, ties placed at the split's
    edges; then with NaN and +-inf against jnp.argmax (the Pallas kernel's
    running `>` never takes a NaN chunk)."""
    rows = _split_edge_rows(vocab, elt)
    assert argmax_split(rows.shape[0], vocab, elt)[1] > 1
    got = _split_argmax(rows, elt)
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(jnp.asarray(rows), axis=-1)))
    x = rows[:, None, :]
    np.testing.assert_array_equal(
        got, np.asarray(j_sample_last(jnp.asarray(x), impl="kernel", interpret=True)))
    rows[5, 1] = np.inf
    rows[5, vocab - 2] = np.nan
    rows[3] = -np.inf
    got = _split_argmax(rows, elt)
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(jnp.asarray(rows), axis=-1)))
    assert got[5] == vocab - 2 and got[3] == 0


# -- the seeded draw (speculative decoding's sampler) ---------------------------
#
# The port's counter-based generator (`utils.prng`) is held to replay, to
# its distribution and to independence across counters, not to
# `jax.random`'s bits. Every statistic below is of a fixed draw, so it is
# deterministic; each bound is its test's 0.1 % level.


def test_seeded_draw_replays_and_spreads_over_ties():
    """A fixed key gives a fixed draw, ties included; other keys spread over
    the tied set (the reference test's all-tied logits); k > 1 with a key
    is refused."""
    from repro_torch.utils import prng

    logits = torch.zeros((2, 1, 7))
    key = prng.key(11)
    a, b = sample_last(logits, key=key), sample_last(logits, key=key)
    assert torch.equal(a, b) and a.dtype == torch.int32 and a.shape == (2,)
    draws = {int(sample_last(logits, key=prng.key(s))[0]) for s in range(32)}
    assert len(draws) > 1 and draws <= set(range(7))
    with pytest.raises(ValueError, match="k=1"):
        sample_last(logits, k=2, key=key)
    assert prng.fold_in(key, 3) == prng.fold_in(prng.key(11), 3) != prng.fold_in(key, 4)
    assert prng.fold_in(prng.fold_in(key, 1), 2) != prng.fold_in(prng.fold_in(key, 2), 1)


def test_seeded_categorical_chi_square():
    """20,000 draws from a fixed 7-way categorical (one row per draw,
    batched): the counts against the probabilities, chi-square with 6
    degrees of freedom under 22.46."""
    from repro_torch.utils import prng

    p = np.array([0.3, 0.2, 0.15, 0.15, 0.1, 0.07, 0.03])
    logits = torch.log(torch.from_numpy(p)).float().expand(20_000, 1, 7)
    ids = sample_last(logits, key=prng.fold_in(prng.key(5), 9)).numpy()
    counts = np.bincount(ids, minlength=7)
    expected = p * 20_000
    assert float(((counts - expected) ** 2 / expected).sum()) < 22.46, counts


def test_seeded_uniforms_are_uniform_and_independent_across_counters():
    """Uniforms of one key: mean and variance of U(0, 1) within 3.3 sigma,
    a 16-bin chi-square (15 dof) under 37.70; the same elements under
    counters 0..3 (fold_in) are uncorrelated (|r| < 3.3 / sqrt(n)), and
    keys differing in the last counter bit give unrelated words."""
    from repro_torch.utils import prng

    n = 50_000
    root = prng.key(2)
    us = [prng.uniform(prng.fold_in(root, c), (n,)).numpy() for c in range(4)]
    for u in us:
        assert 0.0 <= u.min() and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 3.3 * np.sqrt(1 / 12 / n)
        assert abs(u.var() - 1 / 12) < 3.3 * np.sqrt(1 / 180 / n)
        counts = np.bincount((u * 16).astype(int), minlength=16)
        assert float(((counts - n / 16) ** 2 / (n / 16)).sum()) < 37.70
    for i in range(4):
        for j in range(i + 1, 4):
            assert abs(np.corrcoef(us[i], us[j])[0, 1]) < 3.3 / np.sqrt(n)
    a = prng.bits(prng.fold_in(root, 6), n).numpy()
    b = prng.bits(prng.fold_in(root, 7), n).numpy()
    flips = np.unpackbits((a ^ b).astype(">u4").view(np.uint8)).mean()
    assert abs(flips - 0.5) < 3.3 * np.sqrt(0.25 / (32 * n))
