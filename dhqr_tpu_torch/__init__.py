"""dhqr_tpu_torch — the PyTorch/CUDA port of ``dhqr_tpu`` for NVIDIA Hopper.

Same packed Householder storage as the JAX package (reflectors with
||v||^2 = 2 below the diagonal, R's strict upper triangle in ``H``, R's
diagonal in ``alpha``), same public names. GEMMs and triangular solves go
to PyTorch (cuBLAS on the card); the fused panel factorization — a Pallas
kernel in the JAX package — is a CUDA C++ kernel written for ``sm_90a``
(``csrc/panel_qr.cu``), built with nvcc at first use.

    >>> fact = dhqr_tpu_torch.qr(A)          # on the CUDA card by default
    >>> x = fact.solve(b)
    >>> x = dhqr_tpu_torch.lstsq(A, b)
    >>> x = dhqr_tpu_torch.lstsq(A, b, device="cpu")   # plain PyTorch path

This package imports neither ``jax`` nor ``dhqr_tpu``.
"""

from dhqr_tpu_torch.models.qr_model import QRFactorization, lstsq, qr, solve
from dhqr_tpu_torch.ops.blocked import blocked_householder_qr
from dhqr_tpu_torch.ops.householder import alphafactor, householder_qr
from dhqr_tpu_torch.ops.solve import (
    apply_q,
    apply_qt,
    back_substitute,
    solve_least_squares,
)
from dhqr_tpu_torch.utils.config import DHQRConfig, NotPortedError

__version__ = "0.1.0"

__all__ = [
    "DHQRConfig",
    "NotPortedError",
    "QRFactorization",
    "alphafactor",
    "apply_q",
    "apply_qt",
    "back_substitute",
    "blocked_householder_qr",
    "householder_qr",
    "lstsq",
    "qr",
    "solve",
    "solve_least_squares",
    "__version__",
]
