"""PyTorch port, last-token sampling: the port's plain version against
the reference's plain version and its Pallas argmax kernel (interpret
mode) on the same numpy logits, ties and top-k included, and the op's
dispatch. Token ids are compared exactly: argmax has no tolerance. The
CUDA argmax kernel is held against the plain version in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sample import sample_last as j_sample_last
from repro_torch.kernels.sample import argmax_last_kernel, sample_last, sample_last_ref

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
