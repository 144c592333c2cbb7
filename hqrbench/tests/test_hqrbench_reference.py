"""The plain reference against NumPy's LAPACK on small problems."""

import numpy as np
import pytest
import torch

from hqrbench.reference import householder as ref


@pytest.mark.parametrize("m,n,block", [(40, 40, 8), (300, 70, 32),
                                       (513, 130, 128), (64, 1, 128)])
def test_qr_against_lapack(m, n, block):
    rng = np.random.default_rng(m * n)
    A = rng.random((m, n))
    H, alpha = ref.qr(torch.from_numpy(A), block=block)
    R = ref.r_matrix(H, alpha).numpy()
    R_np = np.linalg.qr(A, mode="r")
    # R is unique up to the sign of each row
    np.testing.assert_allclose(np.abs(R), np.abs(R_np), rtol=1e-10,
                               atol=1e-12 * np.abs(R_np).max())
    assert ref.factor_error(torch.from_numpy(A), H, alpha) < 1e-14
    Q = ref.apply_q(H, torch.eye(m, n, dtype=torch.float64), block=block)
    np.testing.assert_allclose(Q.T @ Q, np.eye(n), atol=1e-13)
    QtA = ref.apply_qt(H, torch.from_numpy(A), block=block)
    np.testing.assert_allclose(QtA[:n].numpy(), R, atol=1e-12 * abs(A).sum())


def test_every_reflector_has_norm_root_two():
    A = torch.rand(50, 20, dtype=torch.float64)
    H, _ = ref.qr(A, block=8)
    v = torch.tril(H)
    torch.testing.assert_close(torch.linalg.vector_norm(v, dim=0) ** 2,
                               torch.full((20,), 2.0, dtype=torch.float64))


def test_zero_column_takes_the_identity():
    A = torch.rand(30, 6, dtype=torch.float64)
    A[:, 2] = 0
    H, alpha = ref.qr(A, block=4)
    assert alpha[2] == 0 and not H[2:, 2].any()
    assert ref.factor_error(A, H, alpha) < 1e-14


@pytest.mark.parametrize("m,n", [(200, 200), (1000, 40)])
def test_solve_and_lstsq_against_lapack(m, n):
    rng = np.random.default_rng(7)
    A, b = rng.random((m, n)), rng.random(m)
    x_np = np.linalg.lstsq(A, b, rcond=None)[0]
    x = ref.lstsq(torch.from_numpy(A), torch.from_numpy(b), block=32)
    np.testing.assert_allclose(x.numpy(), x_np,
                               rtol=1e-7 if m == n else 1e-10)
    x_err, fit_err = ref.solution_errors(torch.from_numpy(A), x,
                                         torch.from_numpy(x_np))
    assert fit_err < 1e-14 and x_err < 1e-7


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10, 1 + 3 * 2 ** -11,
                      -1 - 2 ** -12, 3.0e-30])
    y = ref.round_tf32(x)
    # ties to even at the 10th mantissa bit; below half an ulp rounds down
    assert y.tolist()[:5] == [1.0, 1.0, 1 + 2 ** -10, 1 + 2 ** -9, -1.0]
    assert abs(y[5] / x[5] - 1) < 2 ** -11
    z = torch.rand(1000)
    assert ((ref.round_tf32(z) - z).abs() <= z.abs() * 2 ** -11).all()


def test_tf32_control_loses_accuracy():
    A = torch.rand(512, 256)
    H, alpha = ref.qr(A)
    Hc, ac = ref.qr(A, tf32=True)
    A64 = A.double()
    assert ref.factor_error(A64, H, alpha) < 2e-6
    assert ref.factor_error(A64, Hc, ac) > 3e-5
