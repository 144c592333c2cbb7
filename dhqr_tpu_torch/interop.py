"""State carried between the JAX package and the port.

The packed storage is the same on both sides — reflectors with
||v||^2 = 2 and R's strict upper triangle in ``H``, R's diagonal in
``alpha`` — so a factorization made by either package solves in the other.
Only numpy arrays and plain values cross; this module imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from dhqr_tpu_torch.models.qr_model import QRFactorization
from dhqr_tpu_torch.utils.config import DHQRConfig, check_precision
from dhqr_tpu_torch.utils.device import as_tensor


def factorization_from_numpy(H, alpha, *, block_size: int,
                             precision: str = "highest",
                             device=None) -> QRFactorization:
    """The port's :class:`QRFactorization` of a packed ``(H, alpha)`` pair
    (numpy arrays, e.g. ``np.asarray`` of a JAX factorization's fields)."""
    check_precision(precision)
    H = as_tensor(H, device)
    return QRFactorization(H, as_tensor(alpha, H.device, H.dtype),
                           block_size=int(block_size), precision=precision)


def config_from_fields(**fields) -> DHQRConfig:
    """The port's :class:`DHQRConfig` from the JAX config's field values
    (``dataclasses.asdict`` of it); unported values are refused at the
    entry points, not here."""
    return DHQRConfig(**fields)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor (any device) as a numpy array."""
    return t.detach().resolve_conj().cpu().numpy()
