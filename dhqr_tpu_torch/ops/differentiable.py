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

:func:`householder_factor` is the derivative of every other factoring
route: the map A -> (H, alpha) that the unblocked loop, the blocked engine
in every schedule, the reconstruct panels and the Hopper kernel all
compute. Its ``autograd.Function`` runs the engine with grad off and
differentiates the unblocked recurrence (the JAX package differentiates
that recurrence by tracing it): ``jvp`` its tangent over the columns in
order, ``backward`` its adjoint in reverse. Neither keeps a tape; both work
a panel at a time, the columns inside a panel one step at a time
(``householder._panel_jvp`` / ``_panel_vjp``) and the rest of the columns
by compact-WY products (:func:`_wy_jvp` / :func:`_wy_vjp`).
"""

from __future__ import annotations

import dataclasses

import torch

from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.blocked import (
    DEFAULT_BLOCK_SIZE,
    _apply_q_impl,
    _apply_qt_impl,
    _blocked_qr_impl,
    _resolve_kernel,
    apply_block_reflector,
    check_schedule_args,
    wy_upper,
)
from dhqr_tpu_torch.ops.hopper_panel import _panel_qr_plain_leaf
from dhqr_tpu_torch.ops.householder import (
    DEFAULT_PRECISION,
    _panel_jvp,
    _panel_qr_masked,
    _panel_vjp,
)
from dhqr_tpu_torch.ops.solve import _back_substitute, as_matrix_rhs, r_matrix
from dhqr_tpu_torch.utils.config import check_precision, records_grad
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
    False: the plain panel engine, "auto": the kernel for float32, float64
    and complex64 on the card), checked against the keyword-only alias
    ``use_pallas``."""
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
    port's default) on the kernel for float32/float64/complex64 on the card;
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


# -- the differentiable factorization ---------------------------------------

@dataclasses.dataclass(frozen=True)
class FactorOptions:
    """The engine knobs of one factorization (:func:`householder_factor`):
    ``unblocked`` runs ``householder_qr``'s column loop, otherwise the
    blocked engine with the rest (as ``_blocked_qr_impl`` takes them)."""

    unblocked: bool = False
    kernel: bool = False
    norm: str = "accurate"
    panel_impl: str = "loop"
    precision: str = DEFAULT_PRECISION
    trailing_precision: "str | None" = None
    lookahead: bool = False
    agg_panels: "int | None" = None
    leaf: object = None
    flat: "int | None" = None


def _factor(A, block_size, opts: FactorOptions, in_place: bool):
    """The engine call: ``(H, alpha)`` of A, in A's storage when
    ``in_place`` (the blocked engine; the column loop always copies)."""
    if opts.unblocked:
        return _panel_qr_masked(A, 0, precision=opts.precision,
                                norm=opts.norm)
    return _blocked_qr_impl(
        A if in_place else A.clone(), block_size, kernel=opts.kernel,
        norm=opts.norm, panel_impl=opts.panel_impl, precision=opts.precision,
        trailing_precision=opts.trailing_precision, lookahead=opts.lookahead,
        agg_panels=opts.agg_panels, leaf=opts.leaf, flat=opts.flat)


def _wy_jvp(Y, dY, C, dC, precision):
    """Tangent of ``C <- (I - Y T^H Y^H) C`` (a panel's transform applied
    to the columns right of it), in place on ``C`` and ``dC``; with ``U =
    I + triu(Y^H Y, 1)``, ``T^H = U^{-H}``."""
    U = wy_upper(Y, precision)
    W = gemm.matmul(Y.mH, C, precision)
    Z = torch.linalg.solve_triangular(U.mH, W, upper=False,
                                      unitriangular=True)
    dU = torch.triu(gemm.matmul(dY.mH, Y, precision)
                    + gemm.matmul(Y.mH, dY, precision), diagonal=1)
    dW = gemm.matmul(dY.mH, C, precision) + gemm.matmul(Y.mH, dC, precision)
    dZ = torch.linalg.solve_triangular(
        U.mH, dW - gemm.matmul(dU.mH, Z, precision), upper=False,
        unitriangular=True)
    dC -= gemm.matmul(dY, Z, precision) + gemm.matmul(Y, dZ, precision)
    gemm.addmm(C, Y, Z, precision, alpha=-1, inplace=True)


def _wy_vjp(Y, C, O, precision):
    """Adjoint of ``C_out = (I - Y T^H Y^H) C_in``, in place: ``C`` holds
    C_out and ends as C_in (rebuilt, the transform being an involution
    product: ``C_in = (I - Y T Y^H) C_out``), ``O`` holds C_out's cotangent
    and ends as C_in's. Returns Y's cotangent."""
    U = wy_upper(Y, precision)
    apply_block_reflector(Y, C, precision, inplace=True)
    Z = torch.linalg.solve_triangular(U.mH, gemm.matmul(Y.mH, C, precision),
                                      upper=False, unitriangular=True)
    W_bar = torch.linalg.solve_triangular(
        U, -gemm.matmul(Y.mH, O, precision), upper=True, unitriangular=True)
    S_bar = torch.triu(-gemm.matmul(Z, W_bar.mH, precision), diagonal=1)
    Y_bar = gemm.matmul(Y, S_bar + S_bar.mH, precision) \
        + gemm.matmul(C, W_bar.mH, precision) \
        - gemm.matmul(O, Z.mH, precision)
    gemm.addmm(O, Y, W_bar, precision, alpha=1, inplace=True)
    return Y_bar


def _factor_jvp(A, H, alpha, dA, nb, precision):
    """``(dH, dalpha)``: the tangent of the unblocked recurrence, a panel
    of ``nb`` columns at a time in order, replaying the states from A with
    the forward pass's reflectors."""
    n = A.shape[1]
    S, dS = A.clone(), dA.clone()
    dalpha = torch.zeros_like(alpha)
    for k in range(0, n, nb):
        b = min(nb, n - k)
        dalpha[k:k + b] = _panel_jvp(S[k:, k:k + b], dS[k:, k:k + b],
                                     H[k:, k:k + b], alpha[k:k + b],
                                     precision)
        if k + b < n:
            _wy_jvp(torch.tril(H[k:, k:k + b]), torch.tril(dS[k:, k:k + b]),
                    S[k:, k + b:], dS[k:, k + b:], precision)
    return dS, dalpha


def _factor_vjp(H, alpha, H_bar, alpha_bar, nb, precision):
    """A's cotangent: the adjoint of the unblocked recurrence, a panel of
    ``nb`` columns at a time in reverse, rebuilding each state from
    ``(H, alpha)`` alone (O(m n) memory, no tape)."""
    n = H.shape[1]
    S = H.clone()
    G = torch.zeros_like(H) if H_bar is None else H_bar.clone()
    a_bar = torch.zeros_like(alpha) if alpha_bar is None else alpha_bar
    for k in reversed(range(0, n, nb)):
        b = min(nb, n - k)
        if k + b < n:
            G[k:, k:k + b] += torch.tril(_wy_vjp(
                torch.tril(H[k:, k:k + b]), S[k:, k + b:], G[k:, k + b:],
                precision))
        _panel_vjp(S[k:, k:k + b], G[k:, k:k + b], alpha[k:k + b],
                   a_bar[k:k + b], precision)
    return G


class _HouseholderQR(torch.autograd.Function):
    """(H, alpha) of A by the engine that ``opts`` names, with the
    derivative of the unblocked recurrence. Saves (H, alpha) for
    ``backward`` (and A for ``jvp``): no per-column state."""

    @staticmethod
    def forward(A, block_size, opts):
        return _factor(A, block_size, opts, in_place=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, block_size, opts = inputs
        ctx.nb = max(1, min(block_size, A.shape[1]))
        ctx.precision = opts.precision
        ctx.save_for_backward(*output)
        ctx.save_for_forward(A, *output)

    @staticmethod
    def backward(ctx, H_bar, alpha_bar):
        H, alpha = ctx.saved_tensors
        return (_factor_vjp(H, alpha, H_bar, alpha_bar, ctx.nb,
                            ctx.precision), None, None)

    @staticmethod
    def jvp(ctx, dA, _block_size, _opts):
        A, H, alpha = ctx.saved_tensors
        return _factor_jvp(A, H, alpha, dA, ctx.nb, ctx.precision)


def householder_factor(A: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE,
                       *, in_place: bool = False, **options):
    """``(H, alpha)`` of A (m x n, m >= n) by the engine ``options`` names
    (the fields of :class:`FactorOptions`), differentiable in reverse and
    forward mode: every public factorization calls it.

    When autograd does not follow A, this is the engine call itself, in
    A's storage if ``in_place`` (the caller's scratch copy). When it does,
    the same engine call runs inside :class:`_HouseholderQR` on a copy,
    with grad off: its output is the same bit for bit, with the same kernel
    launches. ``block_size`` is the blocked engine's panel width and the
    derivative's (the unblocked loop's derivative takes it too)."""
    opts = FactorOptions(**options)
    if not records_grad(A):
        return _factor(A, block_size, opts, in_place)
    return _HouseholderQR.apply(A, int(block_size), opts)
