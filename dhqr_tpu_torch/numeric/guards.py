"""Device-side numerical guards — port of ``dhqr_tpu/numeric/guards.py``.

* **input screen** (:func:`screen_input`): any-non-finite scan over A (and
  b) plus zero-column detection — the checks that must run BEFORE a
  factorization is paid for;
* **output health** (:func:`any_nonfinite`): the breakdown detector —
  CholeskyQR fails loudly (NaN) outside its conditioning window
  (ops/cholqr.py), so finiteness of the result is the cheap, exact
  post-factorization gate;
* **residual probe** (:func:`residual_ratio`): the one-shot 8x-LAPACK
  normal-equations gate, at the cost of one host LAPACK solve.

This module also owns :func:`checked_cholesky`, the port's one route to a
Cholesky factorization: the breakdown contract is written down there.
Each check is a few reductions on the tensor's device and one scalar read
back.
"""

from __future__ import annotations

import math

import torch

from dhqr_tpu_torch.utils.device import as_tensor


def checked_cholesky(G: torch.Tensor) -> torch.Tensor:
    """``L`` (lower) with ``L L^H = G``; NaN where the factorization fails.

    ``torch.linalg.cholesky`` raises on a matrix that is not positive
    definite; the JAX package's ``lax.linalg.cholesky`` returns NaN
    instead, and that NaN is the breakdown signal the engines and
    :func:`any_nonfinite` key on. So this takes ``cholesky_ex`` (which
    does not synchronise with the card) and, where a pivot failed
    (``info > 0``), returns what ``lax.linalg.cholesky`` returns: the
    lower triangle NaN, the upper zero. Never raises on a square input.
    """
    L, info = torch.linalg.cholesky_ex(G)
    failed = (info > 0)[..., None, None]
    return torch.where(failed, torch.full_like(L, float("nan")).tril(), L)


def _nonfinite(x: torch.Tensor) -> torch.Tensor:
    return ~torch.isfinite(torch.view_as_real(x) if x.is_complex() else x).all()


def screen_input(A, b=None, device=None) -> "tuple[bool, bool, bool]":
    """One scan: ``(A_nonfinite, zero_column, b_nonfinite)``.

    A zero column means cond(A) is exactly infinite. Exact equality, not a
    sum of squares: |a|^2 underflows to 0 for finite tiny columns, and the
    screen must never refuse a valid input.
    """
    A = as_tensor(A, device)
    flags = torch.stack([_nonfinite(A), (A == 0).all(dim=0).any()])
    bad_b = False
    if b is not None:
        bad_b = bool(_nonfinite(as_tensor(b, A.device)))
    bad_a, zero_col = flags.tolist()
    return bool(bad_a), bool(zero_col), bad_b


def any_nonfinite(*tensors) -> bool:
    """True when any entry of any given tensor is NaN/Inf — the
    post-factorization breakdown detector."""
    return any(bool(_nonfinite(torch.as_tensor(t))) for t in tensors)


def diag_condition_bound(diag) -> float:
    """Cheap LOWER bound on cond_2 from an R diagonal:
    ``max|r_ii| / min|r_ii|``. Never overestimates; can underestimate
    badly without pivoting (Kahan matrices)."""
    mag = torch.as_tensor(diag).detach().abs()
    return float(mag.max() / mag.min())


def estimate_condition(A, device=None) -> "float | None":
    """Condition LOWER bound for classification on failure paths: one
    blocked Householder QR of A (m >= n, panels on the kernel's default
    route), then the R-diagonal ratio. None when the estimate comes back
    non-finite."""
    from dhqr_tpu_torch.ops import blocked as _blocked

    A = as_tensor(A, device)
    kernel = _blocked._resolve_kernel("auto", A.shape[0], A.dtype, A.device)
    _, alpha = _blocked._blocked_qr_impl(
        A.clone(), min(_blocked.DEFAULT_BLOCK_SIZE, A.shape[1]), kernel=kernel)
    est = diag_condition_bound(alpha)
    return est if math.isfinite(est) else None


def residual_ratio(A, b, x) -> float:
    """This solution's normal-equations residual over the LAPACK oracle's
    own (:mod:`dhqr_tpu_torch.utils.testing`); the gate passes at <= 8.
    Costs one host LAPACK QR solve of (A, b)."""
    from dhqr_tpu_torch.utils.testing import (
        normal_equations_residual,
        oracle_residual,
    )

    A, b, x = (t.detach().resolve_conj().cpu().numpy()
               if isinstance(t, torch.Tensor) else t for t in (A, b, x))
    res = normal_equations_residual(A, x, b)
    ref = oracle_residual(A, b)
    if ref > 0:
        return float(res / ref)
    return 0.0 if res == 0 else float("inf")
