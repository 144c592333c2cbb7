"""The plain reference: blocked Householder QR (each panel by LAPACK's
geqrf, the trailing matrix by compact-WY GEMMs), its solve, and the judge's
measures, in plain PyTorch. It imports nothing of the program under test.

Storage is the one the program returns, so one judge reads both: ``H``
(m, n) holds reflector v_j (||v_j||^2 = 2) in rows j: of column j and R's
strict upper triangle above it; ``alpha`` (n,) is R's diagonal. Each
reflector is ``I - v v^T``; a panel of them, ``Y`` with the v_j as its
columns, is ``H_1 ... H_nb = I - Y T Y^T`` with
``T^{-1} = I + striu(Y^T Y)`` (every tau is 1).

``tf32=True`` computes the GEMMs in TF32 (the control): on a CUDA device
by PyTorch's TF32 switch for the duration of the call, elsewhere by
rounding each GEMM operand to TF32's 10-bit mantissa. The panels (LAPACK
geqrf) and matrix-vector products stay in the input's precision.
"""

from __future__ import annotations

import contextlib

import torch

BLOCK = 128
# Columns of the right-hand side each panel is applied to at once in
# :func:`apply_q` / :func:`apply_qt`: a block at a time
# keeps a float64 pass over a 16384 x 16384 matrix within a few GiB.
COLUMN_BLOCK = 4096


@contextlib.contextmanager
def _precision(tf32: bool, device: torch.device):
    """Full-precision GEMMs (the reference), or TF32 ones (the control)."""
    if device.type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32 and a.device.type != "cuda":
        return round_tf32(a) @ round_tf32(b)
    return a @ b


def _panel(P: torch.Tensor, alpha: torch.Tensor) -> None:
    """Factor the panel P (r, w) in place by LAPACK's geqrf, and store its
    reflectors as this module's: geqrf's v (v[0] = 1) with its tau becomes
    sqrt(tau) v, whose squared norm is 2, since I - tau v v^T is the
    reflector (tau = 0, a column with nothing to reduce, stores 0)."""
    QR, tau = torch.geqrf(P)
    alpha.copy_(QR.diagonal())
    V = torch.tril(QR, diagonal=-1)
    V.diagonal().fill_(1.0)
    V.mul_(tau.sqrt())
    P.copy_(torch.triu(QR, diagonal=1).add_(V))


def _t_inverse(Y: torch.Tensor, tf32: bool) -> torch.Tensor:
    """T^{-1} = I + striu(Y^T Y) of a panel's reflectors."""
    S = _mm(Y.mT, Y, tf32)
    return torch.eye(Y.shape[1], dtype=Y.dtype, device=Y.device) \
        + torch.triu(S, diagonal=1)


def qr(A: torch.Tensor, tf32: bool = False, block: int = BLOCK):
    """Blocked Householder QR of A (m x n, m >= n): ``(H, alpha)``; A is
    not modified."""
    m, n = A.shape
    if m < n:
        raise ValueError(f"the reference factors m >= n, got {(m, n)}")
    H = A.clone()
    alpha = H.new_zeros(n)
    with _precision(tf32, H.device):
        for k in range(0, n, block):
            w = min(block, n - k)
            P = H[k:, k:k + w]
            _panel(P, alpha[k:k + w])
            if k + w < n:
                Y = torch.tril(P)
                C = H[k:, k + w:]
                W = _mm(Y.mT, C, tf32)
                Z = torch.linalg.solve_triangular(
                    _t_inverse(Y, tf32).mT, W, upper=False, unitriangular=True)
                C.sub_(_mm(Y, Z, tf32))
    return H, alpha


def _apply(H: torch.Tensor, X: torch.Tensor, transpose: bool, tf32: bool,
           block: int) -> torch.Tensor:
    """Q X (or Q^T X) for the reflectors of H, on a copy of X (m, k)."""
    m, n = H.shape
    X = X.clone()
    starts = list(range(0, n, block))
    with _precision(tf32, H.device):
        for k in (starts if transpose else reversed(starts)):
            Y = torch.tril(H[k:, k:k + block])
            U = _t_inverse(Y, tf32)
            for c in range(0, X.shape[1], COLUMN_BLOCK):
                C = X[k:, c:c + COLUMN_BLOCK]
                W = _mm(Y.mT, C, tf32)
                Z = torch.linalg.solve_triangular(
                    U.mT if transpose else U, W, upper=not transpose,
                    unitriangular=True)
                C.sub_(_mm(Y, Z, tf32))
    return X


def apply_q(H, X, tf32: bool = False, block: int = BLOCK) -> torch.Tensor:
    """Q X, X of shape (m, k)."""
    return _apply(H, X, False, tf32, block)


def apply_qt(H, X, tf32: bool = False, block: int = BLOCK) -> torch.Tensor:
    """Q^T X, X of shape (m, k)."""
    return _apply(H, X, True, tf32, block)


def r_matrix(H: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    n = H.shape[1]
    return torch.triu(H[:n], diagonal=1) + torch.diag(alpha)


def solve(H, alpha, b, tf32: bool = False, block: int = BLOCK):
    """x = argmin ||A x - b|| from the factorization of A; b of shape (m,)."""
    n = H.shape[1]
    c = apply_qt(H, b[:, None], tf32, block)[:n]
    return torch.linalg.solve_triangular(r_matrix(H, alpha), c,
                                         upper=True)[:, 0]


def lstsq(A, b, tf32: bool = False, block: int = BLOCK):
    H, alpha = qr(A, tf32, block)
    return solve(H, alpha, b, tf32, block)


# -- the judge's measures (float64) -----------------------------------------

def factor_error(A64: torch.Tensor, H, alpha) -> float:
    """||Q R - A||_F / ||A||_F, with Q R formed in float64 from the stored
    reflectors and R."""
    m, n = A64.shape
    H64 = H.to(torch.float64)
    R = torch.zeros_like(A64)
    R[:n] = r_matrix(H64, alpha.to(torch.float64))
    QR = apply_q(H64, R)
    del R
    return float(torch.linalg.matrix_norm(QR.sub_(A64))
                 / torch.linalg.matrix_norm(A64))


def solution_errors(A64: torch.Tensor, x, x_ref: torch.Tensor
                    ) -> "tuple[float, float]":
    """``(x_err, fit_err)`` of a solution against the reference's:
    ||x - x_ref|| / ||x_ref||, and ||A (x - x_ref)|| / (||A||_F ||x_ref||),
    the second free of A's condition number."""
    d = x.to(torch.float64) - x_ref
    xn = torch.linalg.vector_norm(x_ref)
    return (float(torch.linalg.vector_norm(d) / xn),
            float(torch.linalg.vector_norm(A64 @ d)
                  / (torch.linalg.matrix_norm(A64) * xn)))
