"""PyTorch port: ops/householder.py against the JAX package's.

Same inputs (numpy, from a seed) through both engines. Tolerances are
per dtype, elementwise, relative to the largest entry of the JAX result
(the factor's scale): float64/complex128 1e-12 (both run the same
reflector formulas and the same compensated norm tree; only GEMV
summation order differs), float32 2e-5 and complex64 5e-5 (the same
difference at single precision, grown over the column sweep; single
entries of a 110 x 100 complex64 factor move by ~1e-4 of the scale
between two backward-stable runs; the backward error is checked too).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.ops import householder as jhh  # noqa: E402
from dhqr_tpu_torch.ops import householder as thh  # noqa: E402
from dhqr_tpu_torch.ops.solve import apply_q, r_matrix  # noqa: E402

TOL = {np.float64: 1e-12, np.complex128: 1e-12,
       np.float32: 2e-5, np.complex64: 5e-5}
DTYPES = list(TOL)


def _matrix(m, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n))
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal((m, n))
    return x.astype(dtype)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(110, 100), (44, 40)])
def test_householder_qr_matches_jax(shape, dtype):
    A = _matrix(*shape, dtype, seed=shape[0])
    H, alpha = thh.householder_qr(A, device="cpu")
    H0, alpha0 = jhh.householder_qr(jnp.asarray(A))
    assert H.dtype == torch.from_numpy(A).dtype
    _close(H, H0, TOL[dtype])
    _close(alpha, alpha0, TOL[dtype])
    # backward error ||QR - A|| / ||A||: both engines are backward stable
    m, n = shape
    eye = torch.eye(m, n, dtype=H.dtype)
    QR = torch.matmul(apply_q(H, alpha, eye, device="cpu"), r_matrix(H, alpha))
    At = torch.from_numpy(A)
    eps = torch.finfo(H.real.dtype if H.is_complex() else H.dtype).eps
    assert float(torch.linalg.norm(QR - At) / torch.linalg.norm(At)) < 50 * eps


@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_qr_masked_offset_matches_jax(dtype):
    """Offset 3: the reflector of local column jj starts at row 3 + jj and
    rows above it (R entries of earlier panels) are kept bit for bit."""
    P = _matrix(44, 16, dtype, seed=3)
    pf, alpha = thh._panel_qr_masked(torch.from_numpy(P), 3)
    pf0, alpha0 = jhh._panel_qr_masked(jnp.asarray(P), 3)
    _close(pf, pf0, TOL[dtype])
    _close(alpha, alpha0, TOL[dtype])
    assert np.array_equal(pf.numpy()[:3], P[:3])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_panel_qr_recursive_base8_matches_jax(dtype):
    """geqrt3 recursion with base 8 on a 96 x 32 panel: two levels of
    compact-WY applies between masked leaves, at row offset 0 and 2."""
    P = _matrix(96, 32, dtype, seed=8)
    for offset in (0, 2):
        pf, alpha = thh._panel_qr_recursive(torch.from_numpy(P), offset, base=8)
        pf0, alpha0 = jhh._panel_qr_recursive(jnp.asarray(P), offset, base=8)
        _close(pf, pf0, TOL[dtype])
        _close(alpha, alpha0, TOL[dtype])


def test_recursive_equals_masked_loop():
    """Same packed output as the flat loop (up to GEMM rounding)."""
    P = torch.from_numpy(_matrix(80, 24, np.float64, seed=4))
    pf, alpha = thh._panel_qr_recursive(P, 0, base=4)
    pf0, alpha0 = thh._panel_qr_masked(P, 0)
    torch.testing.assert_close(pf, pf0, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(alpha, alpha0, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_alphafactor_matches_jax_incl_zero_pivot(dtype):
    x = np.array([2.5, -1.0, 0.0, -0.0], dtype=dtype)
    if np.issubdtype(dtype, np.complexfloating):
        x = (x + 1j * np.array([1.0, -3.0, 0.0, 0.0])).astype(dtype)
    got = np.stack([thh.alphafactor(t).numpy() for t in torch.from_numpy(x)])
    want = np.stack([np.asarray(jhh.alphafactor(jnp.asarray(v))) for v in x])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[2] == -1  # a zero pivot gives -1, never 0 or NaN


def test_zero_column_stays_finite():
    """A zero column gives alpha = -0 and v = 0, no NaN (denom > 0 guard)."""
    A = _matrix(20, 6, np.float32, seed=1)
    A[:, 2] = 0.0
    A[:, 4] = A[:, 3]  # dependent column: zero below the diagonal later
    H, alpha = thh.householder_qr(A, device="cpu")
    assert torch.isfinite(H).all() and torch.isfinite(alpha).all()
    assert float(alpha[2]) == 0.0


def test_rejects_wide_and_unported_precision():
    from dhqr_tpu_torch.utils.config import NotPortedError

    with pytest.raises(ValueError):
        thh.householder_qr(np.zeros((4, 6)), device="cpu")
    with pytest.raises(NotPortedError):
        thh.householder_qr(np.eye(4), precision="default", device="cpu")
