"""Solver engine — port of ``dhqr_tpu/ops/solve.py``: apply Q^H to b, then
back-substitute with R (diagonal in ``alpha``, strict upper triangle in H).
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.householder import DEFAULT_PRECISION
from dhqr_tpu_torch.ops.summation import accurate_vdot
from dhqr_tpu_torch.utils.config import check_precision
from dhqr_tpu_torch.utils.device import as_tensor
from dhqr_tpu_torch.utils.profiling import phase


def _reflector_column(H: torch.Tensor, j: int) -> torch.Tensor:
    """Reflector v_j: column j of H with rows < j zeroed."""
    col = H[:, j]
    rows = torch.arange(H.shape[0], device=H.device)
    return torch.where(rows >= j, col, torch.zeros_like(col))


def as_matrix_rhs(b: torch.Tensor):
    """(B, restore): a vector RHS as an (m, 1) block, and the function that
    restores the original rank."""
    if b.ndim == 1:
        return b[:, None], lambda x: x[:, 0]
    return b, lambda x: x


def _apply_reflectors(H, b, order, single_vdot: bool, precision):
    """The reflectors of H applied to b one at a time in ``order``, out of
    place (autograd may follow H or b)."""
    B, restore = as_matrix_rhs(b)
    single = single_vdot and B.shape[1] == 1
    for j in order:
        v = _reflector_column(H, j)
        if single:  # the compensated dot, as the JAX engine
            s = accurate_vdot(v, B[:, 0])[None]
        else:
            s = gemm.matmul(v.conj(), B, precision)
        B = B - v[:, None] * s[None, :]
    return restore(B)


def apply_qt(H, alpha, b, precision: str = DEFAULT_PRECISION, device=None):
    """b <- Q^H b, reflectors j = 0..n-1 in order. A single right-hand side
    takes the compensated dot (:func:`accurate_vdot`); a block (m, k) one
    matvec per reflector, at ``precision``."""
    del alpha  # R's diagonal is not needed to apply Q^H
    check_precision(precision)
    H = as_tensor(H, device)
    b = as_tensor(b, H.device, H.dtype)
    return _apply_reflectors(H, b, range(H.shape[1]), True, precision)


def apply_q(H, alpha, b, precision: str = DEFAULT_PRECISION, device=None):
    """b <- Q b, reflectors in reverse order; ``b`` is (m,) or (m, k)."""
    del alpha
    check_precision(precision)
    H = as_tensor(H, device)
    b = as_tensor(b, H.device, H.dtype)
    return _apply_reflectors(H, b, reversed(range(H.shape[1])), False,
                             precision)


def r_matrix(H: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The n x n upper-triangular R from packed storage (a stack of them
    for a stack H (B, m, n))."""
    n = H.shape[-1]
    return torch.triu(H[..., :n, :], diagonal=1) + torch.diag_embed(alpha)


def _back_substitute(H, alpha, c):
    """Solve R x = c[:n], one ``dhqr.back_substitute`` span; ``c`` is (m,)
    or (m, k), or for a stack H (B, m, n) a (B, m) or (B, m, k) stack."""
    with phase("dhqr.back_substitute"):
        n = H.shape[-1]
        vec = c.ndim == H.ndim - 1
        C = c[..., :n, None] if vec else c[..., :n, :]
        x = torch.linalg.solve_triangular(r_matrix(H, alpha), C, upper=True)
        return x[..., 0] if vec else x


def back_substitute(H, alpha, c, device=None):
    """Solve ``R x = c[:n]`` with R packed as (strict upper of H, alpha);
    ``c`` is (m,) or (m, k)."""
    H = as_tensor(H, device)
    alpha = as_tensor(alpha, H.device)
    return _back_substitute(H, alpha, as_tensor(c, H.device, H.dtype))


def solve_least_squares(H, alpha, b, device=None):
    """x = argmin ||A x - b|| from the packed factorization of A."""
    H = as_tensor(H, device)
    alpha = as_tensor(alpha, H.device)
    return _back_substitute(H, alpha, apply_qt(H, alpha, b, device=H.device))
