"""Numerical guards of the port: the typed failure taxonomy
(:mod:`~dhqr_tpu_torch.numeric.errors`) and the device-side checks
(:mod:`~dhqr_tpu_torch.numeric.guards`)."""

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

__all__ = [
    "Breakdown",
    "IllConditioned",
    "NonFiniteInput",
    "NumericalError",
    "ResidualGateFailed",
    "any_nonfinite",
    "checked_cholesky",
    "diag_condition_bound",
    "estimate_condition",
    "residual_ratio",
    "screen_input",
]
