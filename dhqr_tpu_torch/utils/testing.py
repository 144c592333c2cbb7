"""The reference's acceptance criterion on the host — the port's own copy
of ``dhqr_tpu/utils/testing.py``'s oracle and problem maker (numpy +
scipy, no JAX).

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
    # dhqr: ignore[DHQR002] host-side numpy oracle math (LAPACK-backed f64), no policy product
    return float(np.linalg.norm(Ah @ A @ x - Ah @ b))


def lapack_lstsq(A, b):
    """The oracle's solve: unpivoted LAPACK QR (numpy's geqrf-backed
    ``np.linalg.qr``) and back-substitution, as the reference's
    ``qr!(A, NoPivot()) \\ b``."""
    import scipy.linalg

    Q, R = np.linalg.qr(np.asarray(A), mode="reduced")
    # dhqr: ignore[DHQR002] host-side numpy oracle math, no policy product
    return scipy.linalg.solve_triangular(R, Q.conj().T @ np.asarray(b),
                                         lower=False)


def oracle_residual(A, b) -> float:
    """The LAPACK oracle's own normal-equations residual."""
    return normal_equations_residual(A, lapack_lstsq(A, b), b)


def random_problem(m: int, n: int, dtype, seed: int = 0):
    """Random tall least-squares problem, matching runtests.jl:45-46
    shapes: the JAX package's draws in its order, so one seed gives the
    same arrays bit for bit in both packages."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = (rng.random((m, n)) + 1j * rng.random((m, n))).astype(dtype)
        b = (rng.random(m) + 1j * rng.random(m)).astype(dtype)
    else:
        A = rng.random((m, n)).astype(dtype)
        b = rng.random(m).astype(dtype)
    return A, b


def solve_backward_error(A, x, b) -> float:
    """Normwise solve backward error
    ``eta(x) = ||Ax - b|| / (||A||_F ||x|| + ||b||)``, the acceptance
    metric of the precision-policy ladder. Numpy arrays or tensors (a
    tensor is read on the host); the residual is formed in the inputs'
    precision with a full-precision product, as in the JAX package."""
    A, x, b = (np.asarray(v.detach().cpu().numpy()) if hasattr(v, "detach")
               else np.asarray(v) for v in (A, x, b))
    r = A @ x - b  # dhqr: ignore[DHQR002] host numpy in the inputs' precision, as the JAX twin's "highest"
    return float(np.linalg.norm(r)) / (
        float(np.linalg.norm(A)) * float(np.linalg.norm(x))
        + float(np.linalg.norm(b)))
