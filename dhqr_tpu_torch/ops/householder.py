"""Unblocked Householder QR — port of ``dhqr_tpu/ops/householder.py``.

Same numerics as the JAX engine:

* sign choice ``alpha = s * alphafactor(a_jj)``;
* reflector scale ``f = 1 / sqrt(s * (s + |a_jj|))``, so every stored
  reflector has ``||v||^2 = 2`` and ``H_j = I - v_j v_j^H`` (no tau);
* the reflector overwrites column j's rows ``j:m``; R's strict upper
  triangle stays in H, R's diagonal lives in ``alpha``.

The JAX engine keeps static shapes under ``jit`` by masking whole columns;
eager PyTorch slices instead: the trailing update of a column step runs on
rows ``j:`` and columns right of it only. The skipped entries are the ones
the JAX engine multiplies by structural zeros, so the results agree. The
column norm keeps the JAX engine's masked full-length compensated tree, so
its summation order is the reference's.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch.ops.summation import norm2
from dhqr_tpu_torch.utils.config import SUPPORTED_PRECISION, check_precision
from dhqr_tpu_torch.utils.device import as_tensor

DEFAULT_PRECISION = SUPPORTED_PRECISION
RECURSIVE_BASE_WIDTH = 32


def alphafactor(x: torch.Tensor) -> torch.Tensor:
    """Sign factor for the Householder diagonal shift.

    Real: ``-sign(x)``; complex: ``-x / |x|``. A zero pivot gives ``-1`` in
    both cases, which keeps the factorization finite.
    """
    if x.is_complex():
        mag = x.abs()
        safe = torch.where(mag == 0, torch.ones_like(mag), mag)
        unit = torch.complex(x.real / safe, x.imag / safe)
        return torch.where(mag == 0, -torch.ones_like(x), -unit)
    return torch.where(x >= 0, -torch.ones_like(x), torch.ones_like(x))


def householder_reflector(col: torch.Tensor, j: int, norm: str = "accurate"):
    """One reflector from the full m-vector column ``col`` (rows < j are R
    entries of earlier steps and are masked out). Returns ``(v, alpha_j)``
    with ``v`` zero in rows < j and ``||v||^2 = 2``."""
    m = col.shape[0]
    rows = torch.arange(m, device=col.device)
    colm = torch.where(rows >= j, col, torch.zeros_like(col))
    s = norm2(colm, norm)
    a_jj = col[j]
    alpha_j = s.to(col.dtype) * alphafactor(a_jj)
    denom = s * (s + a_jj.abs())
    # f = 1/sqrt(s(s+|a_jj|)); a zero column gives v = 0. Not rsqrt: its
    # error makes each reflector slightly non-unitary.
    f = torch.where(denom > 0,
                    1.0 / torch.sqrt(torch.where(denom > 0, denom,
                                                 torch.ones_like(denom))),
                    torch.zeros_like(denom))
    shifted = colm - alpha_j * (rows == j).to(col.dtype)
    return shifted * f.to(col.dtype), alpha_j


def _panel_step(jj: int, P: torch.Tensor, alpha: torch.Tensor, offset: int,
                norm: str = "accurate") -> None:
    """One column step on panel ``P``, in place: the reflector of local
    column ``jj`` (diagonal at row ``offset + jj``), then the rank-1 update
    of the columns right of it."""
    j = offset + jj
    v, alpha_j = householder_reflector(P[:, jj], j, norm)
    P[j:, jj] = v[j:]  # rows < j keep R entries
    alpha[jj] = alpha_j
    vj = v[j:]
    w = torch.matmul(vj.conj(), P[j:, jj + 1:])  # partial dots
    P[j:, jj + 1:] -= torch.outer(vj, w)


def _panel_qr_masked(panel: torch.Tensor, offset: int,
                     precision: str = DEFAULT_PRECISION,
                     norm: str = "accurate"):
    """Panel QR with the reflector of local column jj starting at row
    ``offset + jj``; rows above it are preserved. Returns a new
    ``(pf, alpha)``; ``offset=0`` on the whole matrix is the unblocked
    engine."""
    check_precision(precision)
    P = panel.clone()
    alpha = P.new_zeros(P.shape[1])
    for jj in range(P.shape[1]):
        _panel_step(jj, P, alpha, offset, norm)
    return P, alpha


def _panel_qr_recursive(panel: torch.Tensor, offset: int,
                        precision: str = DEFAULT_PRECISION,
                        norm: str = "accurate",
                        base: int = RECURSIVE_BASE_WIDTH, leaf=None):
    """Divide-and-conquer panel QR (the LAPACK geqrt3 recursion): left half
    by recursion, its reflectors applied to the right half as one
    compact-WY transform, right half by recursion at row ``offset + h``.

    ``leaf(panel, offset)`` factors a panel of width <= ``base`` (default:
    :func:`_panel_qr_masked`); the blocked engine passes the Hopper panel
    kernel here.
    """
    b = panel.shape[1]
    if b <= base:
        if leaf is not None:
            return leaf(panel, offset)
        return _panel_qr_masked(panel, offset, precision=precision, norm=norm)
    from dhqr_tpu_torch.ops.blocked import apply_block_reflector_h, shifted_tril

    h = b // 2
    left_f, alpha_l = _panel_qr_recursive(panel[:, :h], offset, precision,
                                          norm, base, leaf)
    right = apply_block_reflector_h(shifted_tril(left_f, offset), panel[:, h:])
    right_f, alpha_r = _panel_qr_recursive(right, offset + h, precision, norm,
                                           base, leaf)
    return torch.cat([left_f, right_f], dim=1), torch.cat([alpha_l, alpha_r])


def householder_qr(A, precision: str = DEFAULT_PRECISION,
                   norm: str = "accurate", device=None):
    """Factor ``A`` (m x n, m >= n): returns ``(H, alpha)`` — reflectors
    (rows j:m of column j, ``||v||^2 = 2``) and R's strict upper triangle in
    ``H``, R's diagonal in ``alpha``."""
    A = as_tensor(A, device)
    m, n = A.shape
    if m < n:
        raise ValueError(f"householder_qr requires m >= n, got {tuple(A.shape)}")
    return _panel_qr_masked(A, 0, precision=precision, norm=norm)
