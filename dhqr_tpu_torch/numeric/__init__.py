"""Numerical guards of the port: the typed failure taxonomy
(:mod:`~dhqr_tpu_torch.numeric.errors`), the device-side checks
(:mod:`~dhqr_tpu_torch.numeric.guards`) and the guarded entry points with
their engine ladder (:mod:`~dhqr_tpu_torch.numeric.ladder`)."""

from dhqr_tpu_torch.numeric.errors import (
    Breakdown,
    IllConditioned,
    NonFiniteInput,
    NumericalError,
    ResidualGateFailed,
)
from dhqr_tpu_torch.numeric.guards import (
    any_nonfinite,
    checked_cholesky,
    diag_condition_bound,
    estimate_condition,
    residual_ratio,
    screen_input,
)
from dhqr_tpu_torch.numeric.ladder import (
    ENGINE_LADDER,
    GUARD_MODES,
    Attempt,
    GuardedResult,
    guarded_lstsq,
    guarded_qr,
)

__all__ = [
    "Attempt",
    "Breakdown",
    "ENGINE_LADDER",
    "GUARD_MODES",
    "GuardedResult",
    "IllConditioned",
    "NonFiniteInput",
    "NumericalError",
    "ResidualGateFailed",
    "any_nonfinite",
    "checked_cholesky",
    "diag_condition_bound",
    "estimate_condition",
    "guarded_lstsq",
    "guarded_qr",
    "residual_ratio",
    "screen_input",
]
