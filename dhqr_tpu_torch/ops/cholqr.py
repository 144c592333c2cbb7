"""CholeskyQR2 / shifted CholeskyQR3 — port of ``dhqr_tpu/ops/cholqr.py``,
the all-GEMM tall-skinny QR.

    G  = A^H A                (Gram product)
    R1 = chol(G)^H            (upper)
    Q1 = A R1^{-1}            (triangular solve, n x n against m rows)
    ... repeat on Q1 ...      (second pass restores orthogonality)
    R  = R2 R1

One pass loses orthogonality as cond(A)^2 * eps; the second pass repairs it
to O(eps) provided the first Cholesky succeeds, which needs roughly
cond(A) < 1/sqrt(eps) (~3e3 in f32, ~7e7 in f64). Fukaya et al.'s diagonal
shift widens that window; a shifted first pass then needs a third pass.
Outside the window the Cholesky fails and the result is NaN
(:func:`dhqr_tpu_torch.numeric.guards.checked_cholesky`): a loud failure to
catch with :func:`~dhqr_tpu_torch.numeric.guards.any_nonfinite` and route
to the Householder engines or TSQR.
"""

from __future__ import annotations

import math

import torch

from dhqr_tpu_torch.numeric.guards import checked_cholesky
from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.householder import DEFAULT_PRECISION
from dhqr_tpu_torch.ops.solve import as_matrix_rhs
from dhqr_tpu_torch.precision import (
    apply_policy_to_factor_args,
    resolve_policy,
)
from dhqr_tpu_torch.utils.device import as_tensor, check_fp32_matmul


def _real_dtype(dtype):
    return torch.empty((), dtype=dtype).real.dtype


def cholqr_max_cond(dtype, shift: bool = False) -> float:
    """Approximate upper edge of the CholeskyQR conditioning window:
    ``1/sqrt(eps)`` for plain CholeskyQR2, ``0.1/eps`` with the shift.
    Order-of-magnitude guides for classifying a breakdown, not
    guarantees."""
    eps = torch.finfo(_real_dtype(dtype)).eps
    return (0.1 / eps) if shift else 1.0 / math.sqrt(eps)


def _chol_upper(G: torch.Tensor, shift: bool) -> torch.Tensor:
    """Upper-triangular R with R^H R = G (+ Fukaya's stabilizing shift, a
    multiple of eps * trace(G) on the diagonal, repaired by the next
    pass). Breakdown surfaces as NaN rows (``checked_cholesky``)."""
    n = G.shape[0]
    if shift:
        eps = torch.finfo(_real_dtype(G.dtype)).eps
        s = 11.0 * (n + 16) * eps * torch.trace(G).real / n
        G = G + s * torch.eye(n, dtype=G.dtype, device=G.device)
    return checked_cholesky(G).mH


def _cholqr_passes(A, gram, precision, shift):
    """(Q, R) from repeated Gram/Cholesky passes; ``gram(X)`` returns
    X^H X. shift=False: CholeskyQR2. shift=True: shifted CholeskyQR3 (the
    shifted first pass leaves Q1 only O(eps cond) orthogonal, so a third
    pass is required)."""

    def one_pass(X, do_shift):
        R = _chol_upper(gram(X), do_shift)
        # Q = X R^{-1}: solve q R = X for q (right-hand triangular solve)
        return torch.linalg.solve_triangular(R, X, upper=True,
                                             left=False), R

    Q, R = one_pass(A, shift)
    Q, R2 = one_pass(Q, False)
    R = gemm.matmul(R2, R, precision)
    if shift:
        Q, R3 = one_pass(Q, False)
        R = gemm.matmul(R3, R, precision)
    return Q, R


def _cholesky_qr2_impl(A, precision, shift, gram_precision=None):
    # The Gram product holds ~all the flops (the trailing analogue of the
    # Householder engines); its precision may be split away from the
    # n x n composition math. None = no split.
    gp = precision if gram_precision is None else gram_precision
    return _cholqr_passes(A, lambda X: gemm.matmul(X.mH, X, gp), precision,
                          shift)


def cholesky_qr2(A, precision: str = DEFAULT_PRECISION, shift: bool = False,
                 gram_precision: "str | None" = None, policy=None,
                 device=None):
    """Thin QR of a tall matrix via Cholesky passes: ``A = Q R``.

    Returns explicit ``(Q, R)``: Q (m, n) orthonormal, R (n, n) upper with
    a real-positive diagonal (the Householder engines' R differs by the
    alpha sign rule; ``R^H R == A^H A`` either way).

    ``shift=False`` is CholeskyQR2 (cond(A) < ~1/sqrt(eps)); outside that
    window the result is NaN. ``shift=True`` is shifted CholeskyQR3.
    ``gram_precision`` / ``policy`` split the Gram product's precision
    away from the composition math (``policy.trailing`` maps onto it);
    Gram rounding is squared through Cholesky, so a cheaper Gram narrows
    the window. ``policy.apply`` and ``policy.refine`` do not apply here.
    """
    precision, gram_precision = apply_policy_to_factor_args(
        policy, precision, gram_precision,
        default_precision=DEFAULT_PRECISION)
    A = as_tensor(A, device)
    check_fp32_matmul(A.device)
    m, n = A.shape
    if m < n:
        raise ValueError(f"cholesky_qr2 requires m >= n, got {tuple(A.shape)}")
    return _cholesky_qr2_impl(A, precision, bool(shift),
                              gram_precision=gram_precision)


def _cholqr_lstsq_impl(A, b, precision, shift, refine=0, gram_precision=None):
    Q, R = _cholesky_qr2_impl(A, precision, shift,
                              gram_precision=gram_precision)
    B, restore = as_matrix_rhs(b)

    def qr_solve(C):
        W = gemm.matmul(Q.mH, C, precision)
        return torch.linalg.solve_triangular(R, W, upper=True)

    X = qr_solve(B)
    for _ in range(refine):
        # One refinement step reuses Q, R: r = b - A x, x += solve(r).
        # Residual matvec at full precision: its accuracy is the point.
        X = X + qr_solve(B - gemm.matmul(A, X, "highest"))
    return restore(X)


def cholesky_qr_lstsq(A, b, precision: str = DEFAULT_PRECISION,
                      shift: bool = False, refine: int = 0,
                      gram_precision: "str | None" = None, policy=None,
                      device=None):
    """Least squares via CholeskyQR2 — the all-GEMM path for m >> n.

    ``refine`` adds that many iterative-refinement sweeps (one A-matvec at
    full precision + one reuse of the factorization each). It does not
    move the window's NaN boundary: a failed Cholesky stays failed.
    ``gram_precision`` / ``policy`` as in :func:`cholesky_qr2`; a policy
    also supplies ``refine`` (mutually exclusive with passing it).
    """
    if policy is not None:
        pol = resolve_policy(policy)
        if refine:
            raise ValueError(
                "pass either policy= or refine=, not both "
                f"(policy sets refine={pol.refine})")
        refine = pol.refine
    precision, gram_precision = apply_policy_to_factor_args(
        policy, precision, gram_precision,
        default_precision=DEFAULT_PRECISION)
    A = as_tensor(A, device)
    b = as_tensor(b, A.device, A.dtype)
    check_fp32_matmul(A.device)
    if A.shape[0] < A.shape[1]:
        raise ValueError(f"lstsq requires m >= n, got {tuple(A.shape)}")
    if int(refine) < 0:
        raise ValueError(f"refine must be >= 0, got {refine}")
    return _cholqr_lstsq_impl(A, b, precision, bool(shift), int(refine),
                              gram_precision=gram_precision)
