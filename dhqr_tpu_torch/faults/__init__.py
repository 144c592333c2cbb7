"""Deterministic fault injection (``dhqr_tpu_torch.faults``) — port of
``dhqr_tpu.faults``.

    >>> from dhqr_tpu_torch import faults
    >>> from dhqr_tpu_torch.utils.config import FaultConfig
    >>> cfg = FaultConfig(sites=(("numeric.breakdown", 1.0, 1),), seed=0)
    >>> with faults.injected(cfg) as harness:
    ...     res = guarded_lstsq(A, b)   # rung 0 "breaks down", rung 1 answers
    >>> harness.stats()["numeric.breakdown"]["fired"]
    1

Environment arming: ``DHQR_FAULTS="numeric.breakdown:1.0:1"`` (+
``DHQR_FAULTS_SEED`` / ``DHQR_FAULTS_LATENCY_MS``), then
``faults.install()``. With nothing armed, every injection point is one
module-global ``None`` check (``faults/harness.py``).
"""

from dhqr_tpu_torch.faults.harness import (
    SITES,
    FaultHarness,
    FaultInjected,
    active,
    epoch,
    fire,
    injected,
    install,
    latency,
    suspended,
    uninstall,
    wire_sites_armed,
)

__all__ = [
    "SITES",
    "FaultHarness",
    "FaultInjected",
    "active",
    "epoch",
    "fire",
    "injected",
    "install",
    "latency",
    "suspended",
    "uninstall",
    "wire_sites_armed",
]
