"""Typed transport-failure taxonomy — port of ``dhqr_tpu/armor/errors.py``.

The third population of failures beside the numeric ones
(:class:`~dhqr_tpu_torch.numeric.errors.NumericalError`): a corrupted
collective payload or a lost shard contribution on the mesh tier. Both
types are ``NumericalError`` subclasses (they arrive as wrong numbers, and
the guarded ladder escalates past them as it does past a breakdown), and
they carry the transport's provenance: which collective label, which
shard, the trace id of the dispatch that caught them, and the recovery
rungs tried. :func:`dhqr_tpu_torch.armor.checked_dispatch` raises them
when its recovery ladder runs dry.
"""

from __future__ import annotations

from dhqr_tpu_torch.numeric.errors import NumericalError


class ArmorError(NumericalError):
    """Base of the armor taxonomy: a mesh-tier result whose invariants
    failed verification, after the recovery ladder ran dry.

    Attributes (beyond :class:`NumericalError`'s ``engine`` /
    ``cond_estimate`` / ``attempts``):
      label: the collective dispatch label of the checked entry point
        (e.g. ``"blocked_qr[P=4,64x32,nb=8,block]"``).
      shard_index: the shard the discrepancy localizes to, or None.
      trace_id: the obs trace id of the checked dispatch (None when
        tracing was disarmed).
      recovery: the recovery rungs tried before the refusal, in order
        (e.g. ``("redispatch", "degrade")``).
    """

    def __init__(self, message: str, engine: "str | None" = None,
                 label: "str | None" = None,
                 shard_index: "int | None" = None,
                 trace_id: "int | None" = None,
                 recovery: tuple = ()) -> None:
        super().__init__(message, engine=engine)
        self.label = label
        self.shard_index = (None if shard_index is None
                            else int(shard_index))
        self.trace_id = trace_id
        self.recovery = tuple(recovery)


class CorruptionDetected(ArmorError):
    """A collective payload arrived corrupted (an integrity tag mismatch,
    or a non-finite or checksum-breaking factor) and neither a re-dispatch
    nor the f32 wire produced a verifiable result. The matrix itself
    screened clean: the failure tracks the data path."""


class ShardFailure(ArmorError):
    """A shard's contribution is missing or wrong as a unit (the
    discrepancy localizes to one shard's columns) and recovery could not
    buy it back. Presumed transient infrastructure: a scheduler retries
    it like a failed dispatch."""
