"""Factorization object + public API — port of ``dhqr_tpu/models/qr_model.py``
(single-device tier).

* :class:`QRFactorization` holds the packed factorization ``(H, alpha)``;
* :func:`qr` factors, :meth:`QRFactorization.solve` / :func:`solve` solve;
* :func:`lstsq` is the one-shot least-squares solve (minimum-norm for
  m < n).

Knobs the port does not run yet (mesh, policy, plan, guards, the alternate
engines, lookahead/aggregation, the lower precisions) raise
:class:`~dhqr_tpu_torch.utils.config.NotPortedError` naming the ROADMAP
item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dhqr_tpu_torch.ops import blocked as _blocked
from dhqr_tpu_torch.ops import householder as _hh
from dhqr_tpu_torch.ops import solve as _solve
from dhqr_tpu_torch.utils.config import DHQRConfig, refuse_unported
from dhqr_tpu_torch.utils.device import as_tensor, check_fp32_matmul


@dataclasses.dataclass
class QRFactorization:
    """Packed Householder QR factorization of A (m x n, m >= n).

    Fields (the JAX package's storage):
      H: (m, n) — reflectors v_j (||v_j||^2 = 2) in rows j:m of column j;
         R's strict upper triangle in rows < j.
      alpha: (n,) — R's diagonal.
      block_size: compact-WY panel width used to apply Q/Q^H in solves.
      precision: matmul precision of the solves ("highest").
      refine: iterative-refinement sweeps :meth:`solve` runs by default.
      matrix: the original A, needed only by refinement.
    """

    H: torch.Tensor
    alpha: torch.Tensor
    block_size: int = _blocked.DEFAULT_BLOCK_SIZE
    precision: str = _hh.DEFAULT_PRECISION
    refine: int = 0
    matrix: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return tuple(self.H.shape)

    @property
    def dtype(self):
        return self.H.dtype

    def _rhs(self, b) -> torch.Tensor:
        return as_tensor(b, self.H.device, self.H.dtype)

    def r_matrix(self) -> torch.Tensor:
        """Dense n x n upper-triangular R."""
        return _solve.r_matrix(self.H, self.alpha)

    def q_columns(self, k: Optional[int] = None) -> torch.Tensor:
        """The first k columns of Q (default n) — a test/debug aid."""
        m, n = self.H.shape
        eye = torch.eye(m, n if k is None else k, dtype=self.H.dtype,
                        device=self.H.device)
        return self.matmul_q(eye)

    def condition_estimate(self) -> torch.Tensor:
        """Cheap lower bound on cond_2(A): ``max|r_ii| / min|r_ii|``."""
        d = self.alpha.abs()
        return d.max() / d.min()

    def rank(self, rtol: Optional[float] = None) -> torch.Tensor:
        """Numerical rank estimate ``#{i : |r_ii| > rtol * max|r_ii|}``;
        default rtol = max(m, n) * eps of the dtype."""
        d = self.alpha.abs()
        if rtol is None:
            rtol = max(self.H.shape) * torch.finfo(d.dtype).eps
        return torch.sum(d > rtol * d.max())

    def _solve_once(self, b: torch.Tensor) -> torch.Tensor:
        c = _blocked._apply_qt_impl(self.H, b, self.block_size)
        return _solve._back_substitute(self.H, self.alpha, c)

    def solve(self, b, refine: Optional[int] = None) -> torch.Tensor:
        """Least-squares solve ``x = argmin ||A x - b||``: apply Q^H,
        back-substitute R. ``refine`` sweeps (default: the recorded count)
        of ``x += solve(b - A x)`` need the original ``matrix``."""
        steps = self.refine if refine is None else int(refine)
        b = self._rhs(b)
        x = self._solve_once(b)
        if steps:
            if self.matrix is None:
                raise ValueError(
                    "refinement needs the original matrix: build the "
                    "factorization with matrix=A, or pass refine=0")
            for _ in range(steps):
                x = x + self._solve_once(b - torch.matmul(self.matrix, x))
        return x

    def matmul_q(self, b) -> torch.Tensor:
        """Q @ b (b of length m, or (m, k))."""
        return _blocked._apply_q_impl(self.H, self._rhs(b), self.block_size)

    def matmul_qt(self, b) -> torch.Tensor:
        """Q^H @ b."""
        return _blocked._apply_qt_impl(self.H, self._rhs(b), self.block_size)


def _reject_nonblocked_knobs(cfg: DHQRConfig) -> None:
    if cfg.use_pallas != "auto":
        raise ValueError(
            "use_pallas applies to the blocked engines only "
            f"(got use_pallas={cfg.use_pallas!r} with blocked=False)")


def _resolved(config, overrides, mesh) -> DHQRConfig:
    cfg = dataclasses.replace(config or DHQRConfig(), **overrides)
    refuse_unported(cfg, mesh)
    if cfg.block_size is None:
        cfg = dataclasses.replace(cfg, block_size=_blocked.DEFAULT_BLOCK_SIZE)
    return cfg


def qr(A, config: Optional[DHQRConfig] = None, donate: bool = False,
       mesh=None, device=None, **overrides) -> QRFactorization:
    """Factor A (m x n, m >= n).

    >>> fact = qr(A)                  # blocked compact-WY, panels on the kernel
    >>> fact = qr(A, blocked=False)   # unblocked reference-parity engine
    >>> fact = qr(A, donate=True)     # factors in place in A's storage

    ``device=None`` runs on the CUDA card (inputs are moved there).
    """
    cfg = _resolved(config, overrides, mesh)
    if cfg.refine:
        raise ValueError(
            "refine applies to lstsq() only — qr() returns the raw "
            "factorization; use lstsq(A, b, refine=...)")
    A = as_tensor(A, device)
    check_fp32_matmul(A.device)
    if cfg.blocked:
        H, alpha = _blocked.blocked_householder_qr(
            A, cfg.block_size, donate=donate, use_pallas=cfg.use_pallas,
            norm=cfg.norm, panel_impl=cfg.panel_impl, device=A.device)
    else:
        if donate:
            raise ValueError("donate=True is only supported on the blocked path")
        _reject_nonblocked_knobs(cfg)
        H, alpha = _hh.householder_qr(A, norm=cfg.norm, device=A.device)
    return QRFactorization(H, alpha, block_size=cfg.block_size)


def solve(fact: QRFactorization, b) -> torch.Tensor:
    """Functional form of ``fact.solve(b)``."""
    return fact.solve(b)


def _minimum_norm_impl(A: torch.Tensor, b: torch.Tensor, block_size: int,
                       norm: str = "accurate") -> torch.Tensor:
    """Underdetermined (m < n, full row rank): factor A^H = Q R, then
    ``x = Q R^{-H} b`` is the minimum-norm solution of A x = b."""
    m, n = A.shape
    H, alpha = _blocked._blocked_qr_impl(A.mH.clone(), block_size, norm=norm)
    R = _solve.r_matrix(H, alpha)  # (m, m) upper; A = R^H Q^H
    B = b[:, None] if b.ndim == 1 else b
    Y = torch.linalg.solve_triangular(R.mH, B, upper=False)  # R^H Y = b
    Yp = Y.new_zeros((n,) + tuple(Y.shape[1:]))
    Yp[:m] = Y
    X = _blocked._apply_q_impl(H, Yp, block_size)
    return X[:, 0] if b.ndim == 1 else X


def lstsq(A, b, config: Optional[DHQRConfig] = None, mesh=None, device=None,
          **overrides) -> torch.Tensor:
    """One-shot least squares ``x = argmin ||A x - b||``.

    For m >= n: the blocked factorization (panels on the Hopper kernel by
    default), Q^H b through the compact-WY applies, back-substitution, and
    ``refine`` sweeps ``x += solve(b - A x)`` with the residual in full
    FP32; ``blocked=False`` runs the unblocked engine. For m < n: the
    minimum-norm solution.

    Not differentiable yet: the closed-form derivative (the JAX package's
    ``lstsq_diff`` custom JVP) arrives with ROADMAP Queue A item 8.
    """
    cfg = _resolved(config, overrides, mesh)
    A = as_tensor(A, device)
    b = as_tensor(b, A.device, A.dtype)
    check_fp32_matmul(A.device)
    if cfg.refine < 0:
        raise ValueError(f"refine must be >= 0, got {cfg.refine}")
    m, n = A.shape
    if m < n:
        if not cfg.blocked or cfg.use_pallas != "auto":
            raise ValueError(
                "m < n supports only the default blocked path "
                f"(got blocked={cfg.blocked}, use_pallas={cfg.use_pallas!r})")
        if cfg.refine:
            raise ValueError(
                "refine is not supported for m < n (the minimum-norm solve "
                "is already exact to working precision)")
        return _minimum_norm_impl(A, b, cfg.block_size, norm=cfg.norm)
    if cfg.blocked:
        fact = qr(A, config=dataclasses.replace(cfg, refine=0),
                  device=A.device)
        solve_once = fact._solve_once
    else:
        _reject_nonblocked_knobs(cfg)
        H, alpha = _hh.householder_qr(A, norm=cfg.norm, device=A.device)

        def solve_once(rhs):
            return _solve._back_substitute(
                H, alpha, _solve.apply_qt(H, alpha, rhs, device=A.device))

    x = solve_once(b)
    for _ in range(cfg.refine):
        x = x + solve_once(b - torch.matmul(A, x))
    return x
