"""PyTorch port: the reconstruct panel engine (``_lu_nopivot``,
``_explicit_qr_tree``, ``_panel_qr_reconstruct``) against the JAX
package's, on the CPU.

Both call LAPACK's QR on the CPU (``torch.linalg.qr``, ``jnp.linalg.qr``)
and the reconstruction is unique for a given sign rule, so the packed
factors agree to roundoff. Tolerances, relative to the largest entry: 1e-5
for float32 and 1e-12 for float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu.ops import householder as jhh  # noqa: E402
from dhqr_tpu.utils.testing import oracle_residual, random_problem  # noqa: E402
from dhqr_tpu_torch.ops import blocked as tbl  # noqa: E402
from dhqr_tpu_torch.ops import householder as thh  # noqa: E402
from dhqr_tpu_torch.utils.config import NotPortedError  # noqa: E402
from dhqr_tpu_torch.utils.testing import normal_equations_residual  # noqa: E402

TOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
IDS = ["float32", "float64"]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b", [24, 80], ids=["base", "recursive"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_lu_nopivot_matches_jax(dtype, b):
    """On the matrix the engine factors: ``Q1_top - S`` of an orthonormal
    Q1, S = -sign(diag Q1_top)."""
    rng = np.random.default_rng(30 + b)
    Q = np.linalg.qr(rng.standard_normal((3 * b, b)))[0][:b]
    M = (Q + np.diag(np.where(np.diag(Q) >= 0, 1.0, -1.0))).astype(dtype)
    got = thh._lu_nopivot(torch.from_numpy(M))
    want = jhh._lu_nopivot(jnp.asarray(M))
    assert _rel(got.numpy(), want) <= TOL[dtype]
    L = np.tril(got.numpy(), -1) + np.eye(b)
    assert _rel(L @ np.triu(got.numpy()), M) <= 10 * TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_explicit_qr_tree_matches_jax(dtype):
    A = np.random.default_rng(31).standard_normal((300, 16)).astype(dtype)
    Q, R = thh._explicit_qr_tree(torch.from_numpy(A), 64)
    Q0, R0 = jhh._explicit_qr_tree(jnp.asarray(A), 64)
    assert Q.shape == (300, 16) and R.shape == (16, 16)
    assert _rel(Q.numpy(), Q0) <= TOL[dtype]
    assert _rel(R.numpy(), R0) <= TOL[dtype]


@pytest.mark.parametrize("chunk", [0, 48], ids=["direct", "tree"])
@pytest.mark.parametrize("offset", [0, 13])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_panel_qr_reconstruct_matches_jax(dtype, offset, chunk):
    P = np.random.default_rng(32).standard_normal((200, 24)).astype(dtype)
    pf, alpha = thh._panel_qr_reconstruct(torch.from_numpy(P), offset, chunk)
    pf0, alpha0 = jhh._panel_qr_reconstruct(jnp.asarray(P), offset, chunk)
    assert _rel(pf.numpy(), pf0) <= TOL[dtype]
    assert _rel(alpha.numpy(), alpha0) <= TOL[dtype]
    assert np.array_equal(pf.numpy()[:offset], P[:offset])  # R rows kept
    v = pf.numpy()[offset:]
    norms = [np.sum(np.tril(v)[:, j] ** 2) for j in range(24)]
    np.testing.assert_allclose(norms, 2.0, rtol=10 * TOL[dtype])


@pytest.mark.parametrize("impl", ["reconstruct", "reconstruct:128"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_blocked_reconstruct_matches_jax(dtype, impl):
    """300 x 200 at nb = 32: every panel through the reconstruct engine
    (the plain panel path, ``use_pallas="never"``)."""
    A, _ = random_problem(300, 200, dtype, seed=33)
    H, alpha = dt.blocked_householder_qr(A, 32, use_pallas="never",
                                         panel_impl=impl, device="cpu")
    H0, alpha0 = dhqr_tpu.blocked_householder_qr(
        jnp.asarray(A), 32, use_pallas="never", panel_impl=impl)
    assert _rel(H.numpy(), H0) <= TOL[dtype] * 10
    assert _rel(alpha.numpy(), alpha0) <= TOL[dtype] * 10


@pytest.mark.parametrize("impl", ["reconstruct", "reconstruct:512"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_reconstruct_lstsq_meets_reference_criterion(dtype, impl):
    A, b = random_problem(400, 300, dtype, seed=34)
    x = dt.lstsq(A, b, panel_impl=impl, use_pallas="never", device="cpu")
    res = normal_equations_residual(A, x.numpy(), b)
    assert np.isfinite(res) and res <= 8.0 * oracle_residual(A, b)
    fact = dt.qr(A, panel_impl=impl, use_pallas="never", device="cpu")
    np.testing.assert_allclose(fact.solve(b).numpy(), x.numpy(),
                               rtol=0, atol=0)


def test_kernel_panels_ignore_panel_impl():
    """A panel the Hopper kernel takes ignores ``panel_impl``, as the JAX
    package's Pallas path does: with ``use_pallas="always"`` the factors
    are the kernel route's whatever the spelling."""
    A, _ = random_problem(200, 160, np.float32, seed=35)
    H0, alpha0 = dt.blocked_householder_qr(A, 32, use_pallas="always",
                                           device="cpu")
    H, alpha = dt.blocked_householder_qr(A, 32, use_pallas="always",
                                         panel_impl="reconstruct",
                                         device="cpu")
    assert torch.equal(H, H0) and torch.equal(alpha, alpha0)


def test_complex_panel_raises_jax_error():
    A, b = random_problem(60, 40, np.complex64, seed=36)
    with pytest.raises(ValueError) as got:
        dt.qr(A.astype(np.complex128), panel_impl="reconstruct",
              device="cpu")
    with pytest.raises(ValueError) as want:
        dhqr_tpu.qr(jnp.asarray(A.astype(np.complex128)),
                    panel_impl="reconstruct")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="real dtypes only"):
        dt.lstsq(A, b, panel_impl="reconstruct", use_pallas="never",
                 device="cpu")


@pytest.mark.parametrize("spelling", ["reconstruct:", "reconstruct:0",
                                      "reconstruct:x", "reconstruct:-4"])
def test_malformed_spelling_raises_jax_error(spelling):
    A, _ = random_problem(40, 20, np.float32, seed=37)
    with pytest.raises(ValueError) as got:
        dt.qr(A, panel_impl=spelling, device="cpu")
    with pytest.raises(ValueError) as want:
        dhqr_tpu.qr(jnp.asarray(A), panel_impl=spelling)
    assert str(got.value) == str(want.value)
    assert tbl._reconstruct_chunk("reconstruct:96") == 96
    assert tbl._reconstruct_chunk("reconstruct") == 0


def test_reconstruct_refuses_grad():
    A = torch.from_numpy(random_problem(60, 40, np.float64, seed=38)[0])
    with pytest.raises(NotPortedError, match="reconstruct"):
        thh._panel_qr_reconstruct(A.requires_grad_(), 0)
