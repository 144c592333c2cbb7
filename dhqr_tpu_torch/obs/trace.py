"""Request-scoped tracing: trace ids, spans and the bounded ring buffer —
port of ``dhqr_tpu/obs/trace.py``.

A **trace id** is minted at the top of a guarded call (``guarded_lstsq``,
``guarded_qr``) and every hop of its path — the input screen, each ladder
rung, the resolve or the typed refusal — is recorded as a :class:`Span` in
one process-wide bounded ring buffer. Design constraints, as in the JAX
package:

* **Zero overhead when disarmed.** Every instrumentation point reads one
  module global and checks it against ``None`` (:func:`active` /
  :func:`mint` / :func:`event`).
* **Out of the compute.** Trace ids live on host-side records (results,
  exceptions) only; no tensor and no kernel launch depends on them.
* **Deterministic under injected clocks.** The recorder takes an
  injectable ``clock``.
* **Bounded.** The ring holds ``ObsConfig.buffer_spans`` spans; the
  oldest fall off (counted in :meth:`TraceRecorder.stats`). The flight
  recorder (``obs.recorder``) snapshots a request's spans at error time.

This module imports nothing it observes. The xray and
pulse subsystems that the JAX package's ``arm`` also arms wait for ROADMAP
Queue A item 16.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Iterator, NamedTuple, Optional

from dhqr_tpu_torch.utils import lockwitness as _lockwitness
from dhqr_tpu_torch.utils.config import ObsConfig


class Span(NamedTuple):
    """One recorded hop of one request's path.

    ``trace_id`` groups spans into a request; ``seq`` is the global
    recording order (stable tiebreak for same-timestamp spans); ``t``
    is the *instrumenting subsystem's* clock reading (the scheduler's
    injectable clock, not necessarily wall time); ``name`` is the hop
    ("submit", "flush", "dispatch", "retry", "bisect", "rung",
    "resolve", ...); ``attrs`` carries the hop's JSON-ready details
    (cause, backoff, bucket, engine, outcome...)."""

    trace_id: int
    seq: int
    t: float
    name: str
    attrs: dict

    def to_json(self) -> dict:
        return {"trace_id": self.trace_id, "seq": self.seq,
                "t": round(self.t, 6), "name": self.name, **self.attrs}


class TraceRecorder:
    """One armed tracing session: mints trace ids, records spans into a
    bounded ring, and hosts the ``on_error`` auto-dump hook. Normally
    managed through the module globals (:func:`arm` / :func:`observed`);
    constructed directly only by tests probing determinism.

    ``clock`` is the fallback timestamp source for spans recorded
    without an explicit ``t`` (instrumented subsystems with their own
    injectable clock pass ``t=`` and never consult it).
    """

    def __init__(self, config: "ObsConfig | None" = None,
                 clock=time.monotonic) -> None:
        self.config = config or ObsConfig(enabled=True)
        self._clock = clock
        self._lock = _lockwitness.make_lock("TraceRecorder._lock")
        # guarded by: _lock
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=self.config.buffer_spans)
        # Per-trace index over the SAME bounded span set: flight dumps
        # read O(path length) instead of copying the whole ring — a
        # burst of auto-dumps must not hold the recorder lock for
        # O(buffer_spans) copies while admission threads (which record
        # their submit span under the scheduler lock) queue behind it.
        # Eviction keeps the two views exact: the globally-oldest span
        # is, within its own trace, also the oldest — deque head (a
        # deque per trace so eviction is O(1) even when one long trace
        # dominates the ring).
        self._by_trace: "dict[int, collections.deque[Span]]" = {}  # guarded by: _lock
        self._next_trace = 0
        self._next_seq = 0
        self._minted = 0
        self._recorded = 0
        self._dropped = 0
        self._error_dumps = 0

    # ------------------------------------------------------------- recording

    def mint(self) -> int:
        """A fresh trace id (monotonic per recorder; the arm/observed
        module layer additionally floors successive ARMED recorders past
        each other's high-water mark, so a re-arm mid-flight can never
        re-issue an id a still-in-flight request is recording under —
        directly-constructed recorders keep deterministic ids from 1)."""
        with self._lock:
            self._next_trace += 1
            self._minted += 1
            return self._next_trace

    def id_high_water(self) -> int:
        """The highest trace id minted so far (0 when none)."""
        with self._lock:
            return self._next_trace

    def advance_past(self, floor: int) -> None:
        """Ensure future mints exceed ``floor`` (the arm/observed
        hand-off: the successor recorder starts past its predecessor)."""
        with self._lock:
            self._next_trace = max(self._next_trace, floor)

    def event(self, trace_id: "int | None", name: str,
              t: "float | None" = None, **attrs) -> None:
        """Record one span. No-op for ``trace_id=None`` (a request
        admitted while tracing was disarmed keeps costing nothing)."""
        if trace_id is None:
            return
        if t is None:
            t = self._clock()
        with self._lock:
            self._next_seq += 1
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
                evicted = self._spans[0]
                per_trace = self._by_trace.get(evicted.trace_id)
                if per_trace:
                    per_trace.popleft()
                    if not per_trace:
                        del self._by_trace[evicted.trace_id]
            self._recorded += 1
            span = Span(trace_id, self._next_seq, float(t), name, attrs)
            self._spans.append(span)
            self._by_trace.setdefault(
                trace_id, collections.deque()).append(span)

    # ------------------------------------------------------------- reading

    def spans_for(self, trace_id: int) -> "list[Span]":
        """The request's span path, in recording order (a consistent
        snapshot, O(path length) via the per-trace index)."""
        with self._lock:
            return list(self._by_trace.get(trace_id, ()))

    def dump(self, trace_id: int) -> dict:
        """JSON-ready flight dump of one request's span path."""
        return {
            "trace_id": trace_id,
            "spans": [s.to_json() for s in self.spans_for(trace_id)],
        }

    def trace_ids(self) -> "list[int]":
        """Distinct trace ids still (partially) resident in the ring,
        oldest-resident first."""
        with self._lock:
            return list(self._by_trace)

    def stats(self) -> dict:
        """JSON-ready recorder accounting (also the ``obs.*`` metrics
        the registry exports)."""
        with self._lock:
            return {
                "minted": self._minted,
                "spans": len(self._spans),
                "recorded": self._recorded,
                "dropped": self._dropped,
                "capacity": self._spans.maxlen,
                "error_dumps": self._error_dumps,
            }

    # --------------------------------------------------------- error hook

    def attach(self, exc: BaseException, trace_id: "int | None") -> None:
        """Stamp a typed error with its request's trace id(s).

        One exception object can resolve several futures (a quarantined
        batch fails everyone with the same ``Quarantined``), so the
        error accumulates ``trace_ids`` (every affected request) while
        ``trace_id`` keeps first-writer-wins for the common
        single-request case."""
        if trace_id is None:
            return
        if getattr(exc, "trace_id", None) is None:
            exc.trace_id = trace_id
        ids = getattr(exc, "trace_ids", ())
        if trace_id not in ids:
            exc.trace_ids = tuple(ids) + (trace_id,)

    def on_error(self, exc: BaseException,
                 trace_id: "int | None" = None) -> None:
        """The auto-dump hook: when ``ObsConfig.auto_dump`` is set,
        persist (or print) the failing request's span path at the
        moment the typed error resolves — before later traffic can
        evict it from the ring. Never raises: a broken dump path must
        not turn a typed failure into a recorder crash."""
        self.attach(exc, trace_id)
        if self.config.auto_dump is None or trace_id is None:
            return
        from dhqr_tpu_torch.obs import recorder as _recorder

        try:
            # Only THIS request's path: one error object can resolve a
            # whole batch of futures (each future's _fail calls the
            # hook with its own id), and dumping every accumulated id
            # per call would duplicate the batchmates' dumps.
            _recorder.write_error_dump(self, exc, (trace_id,),
                                       self.config.auto_dump)
            with self._lock:
                self._error_dumps += 1
        # dhqr: ignore[DHQR006] best-effort telemetry: a full disk or bad dump dir must never mask the typed error the caller is about to receive
        except Exception:
            pass


# The one armed recorder (or None — the fast path). Assignment is atomic
# under the GIL; instrumentation points read it exactly once per visit.
_ACTIVE: "TraceRecorder | None" = None
_ARM_LOCK = _lockwitness.make_lock("trace._ARM_LOCK")
# Trace-id floor across ARMED recorders: instrumentation records spans
# into whatever recorder is active AT SPAN TIME, so a request minted by
# recorder A and still in flight when recorder B arms will record its
# remaining hops into B under A's id — if B could re-mint that id, two
# unrelated requests would merge into one flight dump. Flooring every
# newly armed recorder past its predecessor's high-water mark makes the
# stale spans harmless orphans instead (they never collide with an id B
# hands out). Maintained under _ARM_LOCK.
_ID_FLOOR = 0


def _swap_active_locked(recorder: "TraceRecorder | None") -> None:
    """Replace _ACTIVE (caller holds _ARM_LOCK): bank the outgoing
    recorder's id high-water into the floor and start the incoming one
    past it."""
    global _ACTIVE, _ID_FLOOR
    if _ACTIVE is not None:
        _ID_FLOOR = max(_ID_FLOOR, _ACTIVE.id_high_water())
    if recorder is not None:
        recorder.advance_past(_ID_FLOOR)
    _ACTIVE = recorder


def arm(config: "ObsConfig | None" = None,
        clock=time.monotonic) -> "TraceRecorder | None":
    """Arm process-wide tracing from ``config`` (default: the
    environment's ``DHQR_OBS*``), declaratively: tracing iff
    ``config.enabled``, so ``obs.arm()`` with no variable set is a no-op,
    as ``faults.install()`` with no sites is. A config that asks for
    xray or pulse raises :class:`~dhqr_tpu_torch.utils.config.
    NotPortedError` before anything is armed. Returns the armed recorder,
    or None when tracing is left disarmed."""
    cfg = config if config is not None else ObsConfig.from_env()
    cfg.refuse_unported()
    recorder = TraceRecorder(cfg, clock=clock) if cfg.enabled else None
    with _ARM_LOCK:
        _swap_active_locked(recorder)
    return recorder


def disarm() -> None:
    """Back to the zero-overhead path (the ring and its spans are
    dropped with the recorder)."""
    with _ARM_LOCK:
        _swap_active_locked(None)


def active() -> Optional[TraceRecorder]:
    """The armed recorder, or None. THE hot-path read: instrumented
    batch loops call this once and skip everything when disarmed."""
    return _ACTIVE


@contextlib.contextmanager
def observed(config: "ObsConfig | None" = None,
             clock=time.monotonic) -> Iterator[TraceRecorder]:
    """Scope a tracing session: arm on entry, restore whatever was
    armed before on exit (scopes nest). Yields the recorder even when
    ``config.enabled`` is falsy-armed off — tests always get an object
    to read."""
    cfg = config or ObsConfig(enabled=True)
    recorder = TraceRecorder(cfg, clock=clock)
    # One lock acquisition for capture AND swap: reading ``previous``
    # separately would let a concurrent arm() land in the gap and be
    # silently clobbered by this scope's exit restoration.
    with _ARM_LOCK:
        previous = _ACTIVE
        _swap_active_locked(recorder if cfg.enabled else None)
    try:
        yield recorder
    finally:
        with _ARM_LOCK:
            _swap_active_locked(previous)


def mint() -> "int | None":
    """Mint a trace id, or None when disarmed — the instrumentation
    points carry that None all the way (every downstream hop is a
    no-op on it), so a disarmed stack never branches again."""
    recorder = _ACTIVE
    if recorder is None:
        return None
    return recorder.mint()


def event(trace_id: "int | None", name: str, t: "float | None" = None,
          **attrs) -> None:
    """Record one span against ``trace_id``; no-op when disarmed or
    when the id is None."""
    recorder = _ACTIVE
    if recorder is None or trace_id is None:
        return
    recorder.event(trace_id, name, t=t, **attrs)
