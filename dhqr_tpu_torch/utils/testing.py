"""The reference's acceptance criterion on the host — the port's own copy
of ``dhqr_tpu/utils/testing.py``'s oracle (numpy + scipy, no JAX).

The metric is the normal-equations residual ``||A^H A x - A^H b||``
against the LAPACK oracle's, with tolerance factor 8 (reference
test/runtests.jl:49-51, 62, 81).
"""

from __future__ import annotations

import numpy as np

TOLERANCE_FACTOR = 8.0


def normal_equations_residual(A, x, b) -> float:
    """||A^H A x - A^H b|| of numpy arrays."""
    A, x, b = np.asarray(A), np.asarray(x), np.asarray(b)
    Ah = A.conj().T
    return float(np.linalg.norm(Ah @ A @ x - Ah @ b))


def lapack_lstsq(A, b):
    """The oracle's solve: unpivoted LAPACK QR (numpy's geqrf-backed
    ``np.linalg.qr``) and back-substitution, as the reference's
    ``qr!(A, NoPivot()) \\ b``."""
    import scipy.linalg

    Q, R = np.linalg.qr(np.asarray(A), mode="reduced")
    return scipy.linalg.solve_triangular(R, Q.conj().T @ np.asarray(b),
                                         lower=False)


def oracle_residual(A, b) -> float:
    """The LAPACK oracle's own normal-equations residual."""
    return normal_equations_residual(A, lapack_lstsq(A, b), b)
