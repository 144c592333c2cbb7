"""The observability seam of the port (``dhqr_tpu_torch.obs``): request-
scoped tracing and the flight recorder, ported from ``dhqr_tpu.obs``.

    >>> from dhqr_tpu_torch import obs
    >>> from dhqr_tpu_torch.utils.config import ObsConfig
    >>> obs.arm(ObsConfig(enabled=True))        # or DHQR_OBS=1 + obs.arm()
    >>> res = guarded_lstsq(A, b)               # res.trace_id is minted
    >>> obs.flight_dump(res.trace_id)["spans"]  # submit, screen, rung, ...

* ``obs.trace`` — trace ids and spans in a bounded ring buffer;
* ``obs.recorder`` — the flight recorder: typed errors carry their trace
  id(s), :func:`flight_dump_error` reconstructs the path, and the
  ``on_error`` hook (``ObsConfig.auto_dump``) persists it;
* ``obs.pulse`` and ``obs.netmodel`` — the collective profiler of the mesh
  dispatches (``ObsConfig(pulse=True)``: a :class:`PulseReport` per
  label) and its network model.

Disarmed (the default), every instrumentation point is one module-global
``None`` check. The metrics registry, xray and the regression gate wait
for ROADMAP Queue A item 16.
"""

from __future__ import annotations

from dhqr_tpu_torch.obs import netmodel, pulse, recorder
from dhqr_tpu_torch.obs.pulse import PulseReport
from dhqr_tpu_torch.obs.trace import (
    Span,
    TraceRecorder,
    active,
    arm,
    disarm,
    event,
    mint,
    observed,
)
from dhqr_tpu_torch.utils.config import ObsConfig


def flight_dump(trace_id: int) -> dict:
    """The armed recorder's flight dump for one trace id (empty span list
    when disarmed — the dump API never raises on a cold stack)."""
    armed = active()
    if armed is None:
        return {"trace_id": trace_id, "spans": []}
    return armed.dump(trace_id)


def flight_dump_error(exc: BaseException) -> "list[dict]":
    """Flight dumps for every trace id a typed error carries."""
    return recorder.dump_error(exc)


__all__ = [
    "ObsConfig",
    "PulseReport",
    "Span",
    "TraceRecorder",
    "active",
    "arm",
    "disarm",
    "event",
    "flight_dump",
    "flight_dump_error",
    "mint",
    "netmodel",
    "observed",
    "pulse",
    "recorder",
]
