"""State carried between the JAX package and the port.

The packed storage is the same on both sides — reflectors with
||v||^2 = 2 and R's strict upper triangle in ``H``, R's diagonal in
``alpha`` — so a factorization made by either package solves in the other.
Only numpy arrays and plain values cross; this module imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dhqr_tpu_torch.models.qr_model import QRFactorization
from dhqr_tpu_torch.precision import PrecisionPolicy
from dhqr_tpu_torch.utils.config import DHQRConfig, SketchConfig, check_precision
from dhqr_tpu_torch.utils.device import as_tensor


def factorization_from_numpy(H, alpha, *, block_size: int,
                             precision: str = "highest", refine: int = 0,
                             matrix=None, device=None) -> QRFactorization:
    """The port's :class:`QRFactorization` of a packed ``(H, alpha)`` pair
    (numpy arrays, e.g. ``np.asarray`` of a JAX factorization's fields),
    with the JAX factorization's solve precision (a policy's ``apply``),
    ``refine`` count and, when it refines, its ``matrix``."""
    check_precision(precision)
    if refine and matrix is None:
        raise ValueError("a refining factorization needs its matrix")
    H = as_tensor(H, device)
    return QRFactorization(
        H, as_tensor(alpha, H.device, H.dtype), block_size=int(block_size),
        precision=precision, refine=int(refine),
        matrix=None if matrix is None else as_tensor(matrix, H.device,
                                                     H.dtype))


def config_from_fields(**fields) -> DHQRConfig:
    """The port's :class:`DHQRConfig` from the JAX config's field values
    (``dataclasses.asdict`` of it). A ``policy`` field that holds the JAX
    package's ``PrecisionPolicy`` (``asdict`` turns it into a dict of its
    fields) becomes the port's :class:`PrecisionPolicy`; unported values are
    refused at the entry points, not here."""
    policy = fields.get("policy")
    if dataclasses.is_dataclass(policy) and not isinstance(policy, type):
        policy = dataclasses.asdict(policy)
    if isinstance(policy, dict):
        fields = dict(fields, policy=PrecisionPolicy(**policy))
    return DHQRConfig(**fields)


def sketch_config_from_fields(**fields) -> SketchConfig:
    """The port's :class:`SketchConfig` from the JAX ``SketchConfig``'s
    field values (``dataclasses.asdict`` of it); same fields, same checks."""
    return SketchConfig(**fields)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor (any device) as a numpy array."""
    return t.detach().resolve_conj().cpu().numpy()


def factorization_to_numpy(fact: QRFactorization):
    """``(H, alpha)`` of a factorization as numpy arrays, H in natural
    column order — the JAX factorization's fields. A mesh factorization's
    blocks are all-gathered (``fact.natural_H()``), so every rank of its
    mesh must call this."""
    return to_numpy(fact.natural_H()), to_numpy(fact.alpha)
