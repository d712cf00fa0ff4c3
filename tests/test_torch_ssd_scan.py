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


def _bf16_terms(v, terms):
    """An f32 tensor as ``terms`` bf16 values whose f32 sum approximates
    it: hi = bf16(v), and for two terms also lo = bf16(v - hi)."""
    hi = v.to(torch.bfloat16).float()
    return [hi] if terms == 1 else [hi, (v - hi).to(torch.bfloat16).float()]


def _emulated_kernel(x, dt, A, Bm, Cm, chunk, terms):
    """The CUDA kernel's bf16 body, its precision design in plain PyTorch:
    every product has bf16 operands and f32 sums (a product of two bf16
    values is exact in f32, so f32 einsums over bf16-valued tensors are
    what the tensor cores compute). B, C and x are exact bf16 operands;
    the f32 operands (the chunk-state product's w_t x_t, the entering
    state of the read-out and the gate G) enter as ``terms`` bf16 terms
    (the kernel takes two); the prefix sums, decays and the pass over
    chunks stay f32."""
    b, s, h, p = x.shape
    pad = -s % chunk
    xc, dtc, bc, cc = (torch.nn.functional.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
                       for t in (x, dt, Bm, Cm))
    nc = xc.shape[1] // chunk
    xc = xc.reshape(b, nc, chunk, h, p)
    dtc = dtc.reshape(b, nc, chunk, h)
    bc, cc = bc.reshape(b, nc, chunk, -1), cc.reshape(b, nc, chunk, -1)
    cum = torch.cumsum(dtc * A.float(), dim=2)  # (b, nc, q, h)
    wx = (dtc * torch.exp(cum[:, :, -1:] - cum))[..., None] * xc
    contrib = sum(torch.einsum("bcthp,bctn->bchpn", t, bc) for t in _bf16_terms(wx, terms))
    decay = torch.exp(cum[:, :, -1])  # (b, nc, h)
    carry = torch.zeros_like(contrib[:, 0])
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = contrib[:, c] + decay[:, c, :, None, None] * carry
    entering = torch.stack(entering, dim=1)
    y_off = sum(torch.einsum("bcsn,bchpn->bcshp", cc, t)
                for t in _bf16_terms(entering, terms)) * torch.exp(cum)[..., None]
    scores = torch.einsum("bcsn,bctn->bcst", cc, bc)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nc, s, t, h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))[..., None]
    gate = torch.exp(torch.where(tri, diff, -torch.inf)) * scores[..., None] * dtc[:, :, None]
    y_diag = sum(torch.einsum("bcsth,bcthp->bcshp", t, xc) for t in _bf16_terms(gate, terms))
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), carry


@pytest.mark.parametrize("inputs", ["model's dt", "reference test's dt", "A=-16, dt~1"])
def test_kernel_precision_design_holds_the_smoke_checks(inputs):
    """The bf16 body's precision design, emulated above, against the plain
    version at mamba2-130m's P 64, N 128 and chunk 256 (3 heads, S = 600:
    two whole chunks and a ragged one): the final state within the smoke's
    1e-4 absolute, y within 2^-4 of each row's rms. The same emulation
    with one bf16 term per f32 operand has a state error of 2.0e-3
    (model's dt), 3.3e-4 (reference test's dt) and 2.1e-3 (A = -16,
    dt ~ 1) on these inputs, all over the smoke's 1e-4, against 5.5e-7 to
    4.1e-6 with two terms; the test checks that the second term cuts the
    state error by at least 16x. y's row error is 0.010-0.013 with two
    terms and 0.026-0.031 with one, where G's rounding flips 26-35 % of
    y's bf16 elements (under 0.2 % with two)."""
    b, s, h, p, n, chunk = 1, 600, 3, 64, 128, 256
    rng = np.random.default_rng(6)
    x = rng.normal(size=(b, s, h, p)).astype(ml_dtypes.bfloat16)
    bm, cm = (rng.normal(size=(b, s, n)) / n ** 0.5 for _ in range(2))
    if inputs == "model's dt":
        dt = np.log1p(np.exp(rng.normal(size=(b, s, h))))
        A = -np.linspace(1.0, 16.0, h)
    elif inputs == "reference test's dt":
        dt = rng.uniform(0.01, 0.2, size=(b, s, h))
        A = -np.linspace(1.0, 16.0, h)
    else:
        dt = rng.uniform(0.9, 1.1, size=(b, s, h))
        A = np.full((h,), -16.0)
    args = _torch([x, dt.astype(np.float32), A.astype(np.float32),
                   bm.astype(ml_dtypes.bfloat16), cm.astype(ml_dtypes.bfloat16)])
    want_y, want_fin = ssd_ref(*args, chunk=chunk)
    y, fin = _emulated_kernel(*args, chunk, terms=2)
    _, fin_one = _emulated_kernel(*args, chunk, terms=1)
    err = (fin - want_fin).abs().max().item()
    err_one = (fin_one - want_fin).abs().max().item()
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    assert err <= 1e-4, err
    rms = want_y.float().square().mean(-1).sqrt().clamp_min(1e-6)
    assert ((y.float() - want_y.float()).abs().amax(-1) / rms).max().item() <= 2.0 ** -4
    assert err_one >= 16 * err, (err_one, err)
