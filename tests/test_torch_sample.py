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
