"""PyTorch port, the SSD chunked scan: `repro_torch.models.ssm.ssd_chunked`
and the kernel family `repro_torch.kernels.ssd_scan` against the JAX
package's `ssd_chunked`, its `ssd_naive` and its Pallas `ssd_scan`
(run in the interpreter, as tests/test_kernels.py runs it), on the same
numpy inputs on the CPU.

Tolerances: f32 1e-5 absolute and relative (both sides compute in f32;
the einsums and cumulative sums differ only in summation order, seen
below 1e-5); bf16 inputs 5e-2, the reference test's own bf16 budget (y
is rounded to bf16 once on each side). The CUDA kernel itself is tested
on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd as j_pallas_ssd
from repro.kernels.ssd_scan.ref import ssd_naive as j_ssd_naive
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels.ssd_scan import ops, ssd_naive, ssd_ref, ssd_scan_kernel
from repro_torch.models.ssm import ssd_chunked

# tests/test_kernels.py's three shapes (the last one ragged) and one
# sequence shorter than its chunk
SHAPES = [(2, 96, 3, 32, 16, 32), (1, 64, 2, 16, 8, 16), (1, 50, 1, 8, 4, 16),
          (2, 20, 2, 16, 8, 32)]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(b, s, h, p, n, dtype, seed=0, dt_range=(0.01, 0.2), a_range=(0.5, 2.0)):
    """numpy (x, dt, A, Bm, Cm): x, Bm, Cm in ``dtype``, dt and A f32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(dtype)
    dt = rng.uniform(*dt_range, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(*a_range, size=(h,)).astype(np.float32)
    Bm = rng.normal(size=(b, s, n)).astype(dtype)
    Cm = rng.normal(size=(b, s, n)).astype(dtype)
    return x, dt, A, Bm, Cm


def _torch(arrays):
    out = []
    for a in arrays:
        if a.dtype == ml_dtypes.bfloat16:
            out.append(torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(a.copy()))
    return out


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_chunked_matches_reference(b, s, h, p, n, chunk, dtype):
    """y and the final state against the JAX `ssd_chunked`."""
    npdt, _, tdt, tol = DTYPES[dtype]
    arrays = _inputs(b, s, h, p, n, npdt)
    y, fin = ssd_chunked(*_torch(arrays), chunk)
    jy, jfin = j_ssd_chunked(*_jax(arrays), chunk)
    assert y.dtype == tdt and fin.dtype == torch.float32
    assert y.shape == (b, s, h, p) and fin.shape == (b, h, p, n)
    _close(y, jy, tol)
    _close(fin, jfin, tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_ref_matches_pallas_kernel(b, s, h, p, n, chunk, dtype):
    """The plain version's y against the reference's Pallas kernel in the
    interpreter (which returns y alone)."""
    npdt, _, _, tol = DTYPES[dtype]
    arrays = _inputs(b, s, h, p, n, npdt, seed=1)
    y, _ = ssd_ref(*_torch(arrays), chunk=chunk)
    _close(y, j_pallas_ssd(*_jax(arrays), chunk=chunk), tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES[:3])
def test_ssd_naive_matches_reference_and_chunked(b, s, h, p, n, chunk):
    """The per-step recurrence: its y against the JAX `ssd_naive`, and its
    y and final state against the chunked form (the reference's own
    test's 2e-3 budget for the chunked form against the recurrence)."""
    arrays = _inputs(b, s, h, p, n, np.float32, seed=2)
    ny, nfin = ssd_naive(*_torch(arrays))
    _close(ny, j_ssd_naive(*_jax(arrays)), 1e-5)
    y, fin = ssd_ref(*_torch(arrays), chunk=chunk)
    _close(y, ny.numpy(), 2e-3)
    _close(fin, nfin.numpy(), 2e-3)


def test_ssd_masks_before_exp():
    """A = -16 and dt near 1: the masked differences reach +4,000 within a
    chunk, where exp overflows. Masking first keeps every output finite,
    and the result still matches the reference and the recurrence."""
    arrays = _inputs(1, 200, 2, 16, 8, np.float32, seed=3, dt_range=(0.9, 1.1),
                     a_range=(16.0, 16.0))
    y, fin = ssd_ref(*_torch(arrays), chunk=256)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    jy, jfin = j_ssd_chunked(*_jax(arrays), 256)
    _close(y, jy, 1e-5)
    _close(fin, jfin, 1e-5)
    ny, _ = ssd_naive(*_torch(arrays))
    _close(y, ny.numpy(), 1e-5)


def test_ssd_dispatch_on_cpu():
    """A CPU tensor takes the plain version (no launch counted), with or
    without impl="ref"; an unknown impl raises."""
    t = _torch(_inputs(1, 40, 2, 16, 8, np.float32, seed=4))
    before = ssd_scan_kernel.launches
    y, fin = ops.ssd(*t, chunk=16)
    want_y, want_fin = ssd_ref(*t, chunk=16)
    assert torch.equal(y, want_y) and torch.equal(fin, want_fin)
    y2, _ = ops.ssd(*t, chunk=16, impl="ref")
    assert torch.equal(y2, want_y)
    assert ssd_scan_kernel.launches == before
    with pytest.raises(ValueError, match="unknown impl"):
        ops.ssd(*t, chunk=16, impl="pallas")


def test_ssd_kernel_wrapper_rejects_cpu_tensors():
    t = _torch(_inputs(1, 8, 1, 32, 8, np.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan_kernel(*t, chunk=8)
