"""Typed numerical-failure taxonomy — port of ``dhqr_tpu/numeric/errors.py``.

The failure modes that arrive inside the matrices rather than around them:
a NaN-bearing input, a CholeskyQR breakdown past its conditioning window
(``cond(A) >~ 1/sqrt(eps)`` — ops/cholqr.py), a rank-deficient problem, a
solution that came back finite but missed the 8x-LAPACK residual criterion.

Every type carries the state for the caller's next decision: which
``engine`` observed the failure, the cheap ``cond_estimate`` lower bound
when one was computed, and — for failures raised after a fallback ladder
ran dry — the per-rung ``attempts`` record. All subclass ``RuntimeError``.
"""

from __future__ import annotations


class NumericalError(RuntimeError):
    """Base of every typed numerical failure.

    Attributes:
      engine: the engine family that observed the failure ("cholqr2",
        "tsqr", "householder", ...) or None when the failure precedes
        engine selection (input screening).
      cond_estimate: cheap LOWER bound on cond_2(A) when one was computed
        (``max|r_ii| / min|r_ii|``); None when no estimate was available.
        ``float("inf")`` for structurally singular inputs (a zero column).
      attempts: a fallback ladder's per-rung record for failures raised
        after escalation ran dry; ``()`` otherwise.
    """

    def __init__(self, message: str, engine: "str | None" = None,
                 cond_estimate: "float | None" = None,
                 attempts: tuple = ()) -> None:
        super().__init__(message)
        self.engine = engine
        self.cond_estimate = (None if cond_estimate is None
                              else float(cond_estimate))
        self.attempts = tuple(attempts)


class NonFiniteInput(NumericalError):
    """The input matrix (or right-hand side) carries NaN/Inf entries: no
    engine, however stable, recovers a poisoned input."""


class Breakdown(NumericalError):
    """A factorization broke down: the engine returned non-finite factors
    or a non-finite solution from a finite input — the loud CholeskyQR
    failure mode (a non-positive-definite Gram pass). The condition
    estimate, when present, did NOT implicate conditioning (see
    :class:`IllConditioned` for the case where it did)."""


class IllConditioned(NumericalError):
    """The problem's conditioning exceeds what the (remaining) engines can
    handle: a structurally singular input (zero column — ``cond_estimate``
    is inf), or a breakdown whose cheap condition lower bound already
    exceeds the failing engine's window
    (:func:`dhqr_tpu_torch.ops.cholqr.cholqr_max_cond`)."""


class ResidualGateFailed(NumericalError):
    """A FINITE solution that still missed the 8x-LAPACK normal-equations
    criterion. The worst observed ratio rides in ``residual_ratio``
    (residual / oracle residual; the gate is 8.0)."""

    def __init__(self, message: str, engine: "str | None" = None,
                 cond_estimate: "float | None" = None,
                 attempts: tuple = (),
                 residual_ratio: "float | None" = None) -> None:
        super().__init__(message, engine=engine,
                         cond_estimate=cond_estimate, attempts=attempts)
        self.residual_ratio = (None if residual_ratio is None
                               else float(residual_ratio))
