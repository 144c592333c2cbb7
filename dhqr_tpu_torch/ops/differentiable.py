"""Differentiable least squares — port of ``dhqr_tpu/ops/differentiable.py``.

The closed-form differential of the full-rank least-squares solution

    x(A, b) = argmin ||A x - b||
    dx = A+ (db - dA x) + (A^H A)^{-1} dA^H r,   r = b - A x,  A+ = R^{-1} Q^H

is registered as a ``torch.autograd.Function``: ``jvp`` is this rule
(forward mode), ``backward`` its adjoint, the closed-form cotangents

    b_bar = Q R^{-H} x_bar;  A_bar = -b_bar x^H + r w^H,  w = R^{-1} R^{-H} x_bar

(reverse mode; for complex inputs in PyTorch's convention, the adjoint
under the real inner product Re<u, v>). Both are built from the packed
factors (H, alpha) of the forward pass: no normal-equations matrix is ever
formed, and autograd never records the factorization's loops.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.blocked import (
    DEFAULT_BLOCK_SIZE,
    _apply_q_impl,
    _apply_qt_impl,
    _blocked_qr_impl,
    _resolve_kernel,
    check_schedule_args,
)
from dhqr_tpu_torch.ops.hopper_panel import _panel_qr_plain_leaf
from dhqr_tpu_torch.ops.householder import DEFAULT_PRECISION
from dhqr_tpu_torch.ops.solve import _back_substitute, as_matrix_rhs, r_matrix
from dhqr_tpu_torch.utils.config import check_precision
from dhqr_tpu_torch.utils.device import as_tensor


def _lstsq_fwd(A, b, block_size, kernel=False, norm="accurate",
               panel_impl="loop", refine=0, precision=DEFAULT_PRECISION,
               trailing_precision=None, apply_precision=None,
               lookahead=False, agg_panels=None, leaf=None, flat=None):
    """The forward pass: blocked factorization (in the schedule that
    ``lookahead`` / ``agg_panels`` pick; ``leaf`` and ``flat`` as in
    ``_blocked_qr_impl``), Q^H b, back-substitution and ``refine`` sweeps
    ``x += A+ (b - A x)`` with the residual at full precision. Returns
    ``(x, H, alpha)``."""
    H, alpha = _blocked_qr_impl(A.clone(), block_size, kernel=kernel,
                                norm=norm, panel_impl=panel_impl,
                                precision=precision,
                                trailing_precision=trailing_precision,
                                lookahead=lookahead, agg_panels=agg_panels,
                                leaf=leaf, flat=flat)
    ap = precision if apply_precision is None else apply_precision

    def qr_solve(rhs):
        return _back_substitute(H, alpha,
                                _apply_qt_impl(H, rhs, block_size, ap))

    x = qr_solve(b)
    for _ in range(refine):
        x = x + qr_solve(b - gemm.matmul(A, x, "highest"))
    return x, H, alpha


class _LstsqDiff(torch.autograd.Function):
    """(x, H, alpha) with x = A+ b and the closed-form derivative rules for
    x; the packed factors come out as non-differentiable outputs so that
    the rules can use them (``torch.func`` transforms need this form).
    ``opts`` is the tuple of :func:`_lstsq_fwd`'s keyword values after
    ``block_size``."""

    @staticmethod
    def forward(A, b, block_size, opts):
        return _lstsq_fwd(A, b, block_size, *opts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, b, block_size, opts = inputs
        x, H, alpha = output
        ctx.mark_non_differentiable(H, alpha)
        ctx.block_size = block_size
        ctx.precision = opts[4]
        ctx.save_for_backward(A, b, H, alpha, x)
        ctx.save_for_forward(A, b, H, alpha, x)

    @staticmethod
    def backward(ctx, x_bar, _H_bar, _alpha_bar):
        A, b, H, alpha, x = ctx.saved_tensors
        nb, prec = ctx.block_size, ctx.precision
        m, n = A.shape
        X, _ = as_matrix_rhs(x)
        Xb, _ = as_matrix_rhs(x_bar)
        R = r_matrix(H, alpha)
        Y = torch.linalg.solve_triangular(R.mH, Xb, upper=False)  # R^{-H} x_bar
        Yp = Y.new_zeros((m, Y.shape[1]))
        Yp[:n] = Y
        b_bar = _apply_q_impl(H, Yp, nb, prec)  # Q R^{-H} x_bar
        A_bar = None
        if ctx.needs_input_grad[0]:
            B, _ = as_matrix_rhs(b)
            r = B - gemm.matmul(A, X, prec)
            w = torch.linalg.solve_triangular(R, Y, upper=True)
            A_bar = -gemm.matmul(b_bar, X.mH, prec) + gemm.matmul(r, w.mH,
                                                                  prec)
        b_bar = b_bar[:, 0] if b.ndim == 1 else b_bar
        return A_bar, b_bar, None, None

    @staticmethod
    def jvp(ctx, dA, db, _nb, _opts):
        A, b, H, alpha, x = ctx.saved_tensors
        nb, prec = ctx.block_size, ctx.precision
        X, restore = as_matrix_rhs(x)
        B, _ = as_matrix_rhs(b)
        dB = as_matrix_rhs(torch.zeros_like(b) if db is None else db)[0]
        dA = torch.zeros_like(A) if dA is None else dA
        R = r_matrix(H, alpha)
        # dx1 = A+ (db - dA x): Q^H through the compact-WY apply, then R^{-1}
        U = dB - gemm.matmul(dA, X, prec)
        dx1 = _back_substitute(H, alpha, _apply_qt_impl(H, U, nb, prec))
        # dx2 = (A^H A)^{-1} dA^H r via two triangular solves with R
        r = B - gemm.matmul(A, X, prec)
        Z = gemm.matmul(dA.mH, r, prec)
        W = torch.linalg.solve_triangular(R.mH, Z, upper=False)
        dx2 = torch.linalg.solve_triangular(R, W, upper=True)
        return restore(dx1 + dx2), None, None


_PALLAS_MODES = {True: "always", False: "never", "auto": "auto"}


def _kernel_mode(pallas, use_pallas) -> str:
    """The ``use_pallas`` spelling of ``pallas`` (True: the Hopper kernel,
    False: the plain panel engine, "auto": the kernel for float32/complex64
    on the card), checked against the keyword-only alias ``use_pallas``."""
    if not (isinstance(pallas, bool) or pallas == "auto"):
        raise ValueError(
            f"pallas must be True, False or 'auto', got {pallas!r}")
    if use_pallas is None:
        return _PALLAS_MODES[pallas]
    if pallas != "auto" and _PALLAS_MODES[pallas] != use_pallas:
        raise ValueError(
            f"pallas={pallas!r} and use_pallas={use_pallas!r} disagree: "
            "pass one of them")
    return use_pallas


def lstsq_diff(A, b, block_size: int = DEFAULT_BLOCK_SIZE,
               precision: str = DEFAULT_PRECISION, pallas="auto",
               pallas_interpret: bool = False, norm: str = "accurate",
               panel_impl: str = "loop", refine: int = 0,
               pallas_flat: "int | None" = None,
               trailing_precision: "str | None" = None,
               lookahead: bool = False, agg_panels: "int | None" = None,
               apply_precision: "str | None" = None, *, device=None,
               use_pallas: "str | None" = None):
    """``x = argmin ||A x - b||`` (m >= n) with closed-form O(1)-memory
    derivatives, in both forward (``torch.func.jvp``, forward AD) and
    reverse mode (``backward``). The parameters are the JAX package's, in
    its order.

    The forward pass is the blocked engine, Q^H b and back-substitution;
    ``b`` may be (m,) or (m, k). ``pallas=True`` puts the panels on the
    Hopper kernel, ``False`` on the plain panel engine, and ``"auto"`` (the
    port's default) on the kernel for float32/complex64 on the card;
    ``use_pallas`` ("auto"/"always"/"never") is a keyword-only alias.
    ``pallas_interpret=True`` runs the kernel's plain version in its place
    (the Pallas interpreter's counterpart), and ``pallas_flat`` caps the
    kernel's leaf width (default: the widest that fits the card). ``refine``
    adds iterative-refinement sweeps reusing the factorization; the
    derivative is that of the exact minimizer, which refinement
    approaches. ``apply_precision`` (default: ``precision``) is the solve
    stage's precision; the derivative rules run at ``precision``.
    ``lookahead`` / ``agg_panels`` pick the forward's factorization
    schedule; the derivative rules do not depend on it.
    """
    mode = _kernel_mode(pallas, use_pallas)
    check_schedule_args(lookahead, agg_panels, None)
    for name in (precision, trailing_precision, apply_precision):
        if name is not None:
            check_precision(name)
    if int(refine) < 0:
        raise ValueError(f"refine must be >= 0, got {refine}")
    if pallas_flat is not None and int(pallas_flat) < 1:
        raise ValueError(f"pallas_flat must be >= 1, got {pallas_flat}")
    A = as_tensor(A, device)
    b = as_tensor(b, A.device, A.dtype)
    m, n = A.shape
    if m < n:
        raise ValueError(f"lstsq_diff requires m >= n, got {tuple(A.shape)}")
    kernel = _resolve_kernel(mode, m, A.dtype, A.device)
    leaf = _panel_qr_plain_leaf if kernel and pallas_interpret else None
    return _LstsqDiff.apply(A, b, int(block_size), (
        kernel, norm, panel_impl, int(refine), precision, trailing_precision,
        apply_precision, bool(lookahead), agg_panels, leaf,
        None if pallas_flat is None else int(pallas_flat)))[0]
