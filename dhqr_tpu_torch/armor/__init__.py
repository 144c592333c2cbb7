"""The armor seam — ABFT detection and typed self-healing for the
sharded tier; port of ``dhqr_tpu/armor/__init__.py``.

* **Detection** — checksum verification (:mod:`dhqr_tpu_torch.armor.
  checks`): every armored sharded dispatch is followed by an O(mn)
  weighted-checksum invariant over the factors it produced (``u^H A`` vs
  ``(Q^H u)^H R``; the normal-equations identity for solves), plus
  integrity tags on COMPRESSED collectives at the ``parallel/wire.py``
  seam (a mismatch poisons the payload NaN-loud).
* **Injection** — the ``parallel.collective.{corrupt,nan,drop}`` fault
  sites fire inside the wire seam, one visit per executed collective
  (the JAX package counts traced ones; the two agree where its engines
  unroll their panel loop).
* **Recovery** — a typed ladder: verify -> re-dispatch -> degrade
  ``comms`` to the f32 passthrough for the offending label -> typed
  :class:`CorruptionDetected` / :class:`ShardFailure` (carrying engine,
  collective label, shard index, trace id), which the guarded ladder
  escalates past and the async scheduler routes. Repeated trips on a
  compressed dispatch strip ``comms`` from the key's stored plans in
  ``tune.resolve_plan``.

``DHQR_ARMOR*`` configure (:class:`~dhqr_tpu_torch.utils.config.
ArmorConfig`); only :func:`arm` / :func:`armored` arm. Disarmed, every
sharded dispatch pays one module-global ``None`` check and launches what
it launched before. A re-dispatch runs the same eager program again: an
exhausted fault schedule then finds every collective clean, which is
what makes single re-dispatch recovery replayable.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

from dhqr_tpu_torch.armor.errors import (
    ArmorError,
    CorruptionDetected,
    ShardFailure,
)
from dhqr_tpu_torch.armor import checks
from dhqr_tpu_torch.faults import harness as _faults
from dhqr_tpu_torch.obs import trace as _obs
from dhqr_tpu_torch.utils import lockwitness as _lockwitness
from dhqr_tpu_torch.utils.config import ArmorConfig
from dhqr_tpu_torch.utils.profiling import Counters

__all__ = [
    "ArmorConfig",
    "ArmorError",
    "ArmorState",
    "CorruptionDetected",
    "ShardFailure",
    "active",
    "arm",
    "armored",
    "checked_dispatch",
    "checks",
    "degraded_labels",
    "disarm",
    "effective_comms",
    "reset_wire_trips",
    "seam_token",
    "wire_demoted",
    "wire_tags_armed",
    "wire_trips",
]


#: Checksum tolerance for COMPRESSED dispatches: wire rounding puts an
#: honest compressed invariant at ~1e-3..1e-2 (the JAX package's
#: measurement on its CPU grid; blocked-qr factor gaps the worst at
#: ~9e-3), while corruption lands at O(1)+. One decade each way.
WIRE_RTOL = 0.1


class ArmorState:
    """One armed verification seam (config + accounting). Managed via
    :func:`arm` / :func:`disarm` / :func:`armored`; the counters are
    exported process-wide as ``armor.*`` by ``dhqr_tpu_torch.obs.metrics``."""

    _GEN = [0]

    def __init__(self, config: ArmorConfig) -> None:
        self.config = config
        self.counters = Counters()
        ArmorState._GEN[0] += 1
        #: arm generation — seam-token material.
        self.epoch = ArmorState._GEN[0]

    def metrics_snapshot(self) -> dict:
        out = {name: 0 for name in (
            "verifications", "detections", "recovered_redispatch",
            "recovered_degrade", "typed_failures")}
        out.update(self.counters.snapshot())
        # Under the lock: a concurrent trip inserting a NEW key while
        # sum() iterates would raise "dict changed size during
        # iteration" — telemetry must never take the caller down.
        with _TRIP_LOCK:
            out["degraded_labels"] = len(_DEGRADED)
            out["wire_trips"] = sum(_WIRE_TRIPS.values())
        return out


_ACTIVE: "ArmorState | None" = None
_ARM_LOCK = _lockwitness.make_lock("armor._ARM_LOCK")

# Persistent (module-lifetime, like tune's gate failures) transport
# health memory: labels degraded to the f32 wire, and per-plan-key
# verification-trip counts feeding tune's compressed-plan demotion.
_DEGRADED: "set[str]" = set()
_WIRE_TRIPS: "dict[tuple, int]" = {}
_TRIP_LOCK = _lockwitness.make_lock("armor._TRIP_LOCK")

# Bumped before every recovery re-dispatch (seam-token material, as in
# the JAX package, where it re-keys the traced engine builds so that an
# injected schedule re-draws; the port's eager engines consult the fault
# sites on every executed collective and need no re-keying).
_NONCE = [0]


def arm(config: "ArmorConfig | None" = None) -> "ArmorState | None":
    """Arm the process-wide verification seam from ``config`` (default:
    the environment's ``DHQR_ARMOR*``). Returns the state, or None when
    the config says disabled (mirrors ``obs.arm``)."""
    global _ACTIVE
    cfg = config if config is not None else ArmorConfig.from_env()
    with _ARM_LOCK:
        _ACTIVE = ArmorState(cfg) if cfg.enabled else None
    return _ACTIVE


def disarm() -> None:
    """Back to the zero-overhead path (the degrade/trip memory is kept —
    transport health outlives one armed scope; ``reset_wire_trips``
    clears it)."""
    global _ACTIVE
    with _ARM_LOCK:
        _ACTIVE = None


def active() -> Optional[ArmorState]:
    """The armed state, or None — THE one read every disarmed sharded
    dispatch pays."""
    return _ACTIVE


@contextlib.contextmanager
def armored(config: "ArmorConfig | None" = None) -> Iterator[ArmorState]:
    """Scope the verification seam: arm on entry, restore on exit."""
    global _ACTIVE
    with _ARM_LOCK:
        previous = _ACTIVE
    state = arm(config if config is not None
                else ArmorConfig(enabled=True))
    try:
        yield state
    finally:
        with _ARM_LOCK:
            _ACTIVE = previous


def wire_tags_armed() -> bool:
    """Whether the wire seam adds integrity tags to compressed payloads
    (armed AND ``ArmorConfig.wire_tags``) — read per collective by
    ``parallel/wire.py``."""
    state = _ACTIVE
    return state is not None and state.config.wire_tags


def seam_token(comms: "str | None" = None):
    """The JAX package's build-cache key material, for parity: None
    when no wire fault site is armed and no tag is in play on a compressed
    wire; else ``(fault epoch, recovery nonce, arm epoch)``. The port's
    eager engines key no cache on it."""
    f_ep = _faults.epoch() if _faults.wire_sites_armed() else 0
    state = _ACTIVE
    a_ep = state.epoch if (state is not None and comms is not None
                           and state.config.wire_tags) else 0
    if not f_ep and not a_ep:
        return None
    return (f_ep, _NONCE[0] if f_ep else 0, a_ep)


def effective_comms(label: str, comms: "str | None") -> "str | None":
    """The wire format ``label`` should actually dispatch with: the
    caller's ``comms`` unless the recovery ladder degraded this label
    to the f32 passthrough (then None, until the process restarts or
    :func:`reset_wire_trips` clears the memory). Disarmed, the caller's
    value passes through untouched."""
    if comms is None or _ACTIVE is None:
        return comms
    with _TRIP_LOCK:
        return None if label in _DEGRADED else comms


def degraded_labels() -> "tuple[str, ...]":
    with _TRIP_LOCK:
        return tuple(sorted(_DEGRADED))


def _trip_key(kind, m, n, dtype, nproc) -> tuple:
    from dhqr_tpu_torch.utils.device import dtype_name

    return (str(kind), int(m), int(n), dtype_name(dtype), int(nproc))


def note_wire_trip(kind: str, m: int, n: int, dtype, nproc: int) -> int:
    """Record one verification trip of a COMPRESSED dispatch against
    the (kind, shape, dtype, nproc) key; returns the running count.
    ``dhqr_tpu_torch.tune.resolve_plan`` consults :func:`wire_demoted` and
    strips ``comms`` from stored plans once the count reaches the
    demotion threshold — compressed plans whose labels keep tripping
    verification stop being offered."""
    key = _trip_key(kind, m, n, dtype, nproc)
    with _TRIP_LOCK:
        _WIRE_TRIPS[key] = _WIRE_TRIPS.get(key, 0) + 1
        return _WIRE_TRIPS[key]


def wire_trips(kind: str, m: int, n: int, dtype, nproc: int) -> int:
    key = _trip_key(kind, m, n, dtype, nproc)
    with _TRIP_LOCK:
        return _WIRE_TRIPS.get(key, 0)


def wire_demoted(kind: str, m: int, n: int, dtype, nproc: int) -> bool:
    """Whether the key's compressed plans are demoted (trips >= tune's
    ``PLAN_DEMOTE_AFTER`` — one threshold for both demotion flavors)."""
    from dhqr_tpu_torch.tune.search import PLAN_DEMOTE_AFTER

    return wire_trips(kind, m, n, dtype, nproc) >= PLAN_DEMOTE_AFTER


def export_wire_trips() -> "dict[str, int]":
    """Wire-trip counts in the shared-fleet-state spelling (round 22):
    ``"kind|m|n|dtype|nproc" -> count``. The flat string key crosses
    process/JSON boundaries losslessly (the JAX package's spelling);
    :func:`adopt_wire_trips` parses it back."""
    with _TRIP_LOCK:
        return {"|".join(str(part) for part in key): count
                for key, count in _WIRE_TRIPS.items()}


def adopt_wire_trips(trips: "dict[str, int]") -> None:
    """Inherit another replica's wire-trip counts, merged by MAX per
    key (monotone evidence, like tune's gate-failure adoption): a key
    at/over the demotion threshold after adoption answers
    :func:`wire_demoted` True immediately, so replica N+1 stops
    offering the tripped compressed plans without re-tripping them
    against live traffic. Malformed entries are skipped — the state
    file is loaded tolerantly end to end."""
    with _TRIP_LOCK:
        for key_str, count in trips.items():
            parts = str(key_str).split("|")
            if len(parts) != 5:
                continue
            try:
                key = (parts[0], int(parts[1]), int(parts[2]), parts[3],
                       int(parts[4]))
                count = int(count)
            except (TypeError, ValueError):
                continue
            if count > _WIRE_TRIPS.get(key, 0):
                _WIRE_TRIPS[key] = count


def reset_wire_trips() -> None:
    """Clear the degrade/trip memory (tests; or after a link repair)."""
    with _TRIP_LOCK:
        _WIRE_TRIPS.clear()
        _DEGRADED.clear()


def _bump_nonce() -> None:
    _NONCE[0] += 1


def _classify(gap: float):
    """NaN-loud detections (inf gap — wire-tag poisoning, an injected
    NaN) are payload corruption; a finite over-threshold gap is a
    shard's contribution arriving wrong/missing as a unit."""
    return CorruptionDetected if gap == float("inf") else ShardFailure


def checked_dispatch(
    label: str,
    dispatch: Callable[[], object],
    verify: Callable[[object], "tuple[float, int | None]"],
    *,
    engine: str,
    comms: "str | None" = None,
    degrade: "Callable[[], object] | None" = None,
    shard_of: "Callable[[int], int | None] | None" = None,
    plan_shape: "tuple | None" = None,
) -> object:
    """The armored dispatch seam: run ``dispatch``, verify its result
    against the checksum invariant, and on detection walk the recovery
    ladder — re-dispatch (``ArmorConfig.redispatch`` times), degrade
    the label's wire to the f32 passthrough (compressed dispatches
    only; the degrade sticks for the label and feeds tune's
    compressed-plan demotion), then raise typed.

    ``verify(result) -> (gap, worst_col)`` returns the relative
    checksum gap (inf = NaN-loud) and the localizing column (None when
    the invariant does not localize); ``shard_of(worst_col)`` maps it
    to the mesh position. ``plan_shape = (kind, m, n, dtype, nproc)``
    keys the wire-trip accounting. Callers guard with :func:`active`.
    On a mesh every rank runs the ladder in step: each rank's gap is
    computed from results every rank holds alike, so every rank takes
    the same branch and a re-dispatch's collectives stay matched.
    """
    state = _ACTIVE
    if state is None:       # disarmed between the caller's check and now
        return dispatch()
    cfg = state.config
    rec = _obs.active()
    tid = rec.mint() if rec is not None else None
    if rec is not None:
        rec.event(tid, "submit", kind="armor", label=label, engine=engine,
                  comms=comms or "f32")

    last_tol = [cfg.rtol]

    def _verify(out, stage: str, wire: "str | None"):
        # Per-STAGE tolerance: compressed dispatches carry honest
        # wire-rounding in their invariants (~1e-3..1e-2 measured),
        # so they verify against WIRE_RTOL; the degrade stage runs the
        # f32 passthrough and drops back to the tight cfg.rtol.
        tol = cfg.rtol if wire is None else max(cfg.rtol, WIRE_RTOL)
        last_tol[0] = tol
        state.counters.bump("verifications")
        gap, worst = verify(out)
        ok = gap <= tol
        if rec is not None:
            rec.event(tid, "verify", stage=stage, ok=bool(ok),
                      rtol=tol,
                      gap=(round(gap, 8) if gap != float("inf")
                           else "inf"))
        return ok, gap, worst

    out = dispatch()
    ok, gap, worst = _verify(out, "dispatch", comms)
    if ok:
        if rec is not None:
            rec.event(tid, "resolve", outcome="ok")
        return out

    state.counters.bump("detections")
    first_cls = _classify(gap)
    shard = shard_of(worst) if (shard_of is not None
                                and worst is not None
                                and gap != float("inf")) else None
    if comms is not None and plan_shape is not None:
        note_wire_trip(*plan_shape)
    recovery: "list[str]" = []

    for attempt in range(cfg.redispatch):
        recovery.append("redispatch")
        _bump_nonce()
        if rec is not None:
            rec.event(tid, "redispatch", attempt=attempt + 1)
        out = dispatch()
        ok, gap, worst = _verify(out, f"redispatch{attempt + 1}", comms)
        if ok:
            state.counters.bump("recovered_redispatch")
            if rec is not None:
                rec.event(tid, "resolve", outcome="ok",
                          recovery="redispatch")
            return out

    if comms is not None and degrade is not None:
        recovery.append("degrade")
        with _TRIP_LOCK:
            _DEGRADED.add(label)
        _bump_nonce()
        if rec is not None:
            rec.event(tid, "degrade", label=label, from_comms=comms)
        out = degrade()
        ok, gap, worst = _verify(out, "degrade", None)
        if ok:
            state.counters.bump("recovered_degrade")
            if rec is not None:
                rec.event(tid, "resolve", outcome="ok",
                          recovery="degrade")
            return out

    state.counters.bump("typed_failures")
    cls = _classify(gap) if gap == float("inf") else first_cls
    noun = ("corrupted collective payload"
            if cls is CorruptionDetected else "shard contribution lost")
    err = cls(
        f"{noun} at {label!r}: checksum invariant failed "
        f"(gap {gap:.3e} > rtol {last_tol[0]:.0e}) and recovery "
        f"({' -> '.join(recovery) or 'none configured'}) did not "
        "produce a verifiable result",
        engine=engine, label=label, shard_index=shard, trace_id=tid,
        recovery=tuple(recovery))
    if rec is not None:
        rec.attach(err, tid)
        rec.event(tid, "resolve", outcome=type(err).__name__,
                  error=str(err)[:200])
        rec.on_error(err, tid)
    raise err


def checked_solve(label: str, dispatch: Callable[[object], object], A, b,
                  *, engine: str, comms: "str | None",
                  plan_shape: tuple) -> object:
    """The solve engines' seam (the row engines and ``sharded_lstsq``):
    ``dispatch(comms)`` as it is while disarmed; armed, through
    :func:`checked_dispatch` with the normal-equations checksum of its x
    against ``A`` and ``b``, degrading to ``dispatch(None)`` (the f32
    wire) when ``comms`` compresses."""
    if _ACTIVE is None:
        return dispatch(comms)
    return checked_dispatch(
        label, lambda: dispatch(comms),
        lambda x: (checks.lstsq_gap(A, b, x), None),
        engine=engine, comms=comms,
        degrade=(lambda: dispatch(None)) if comms else None,
        plan_shape=plan_shape)
