"""Runtime lock-witness — the port's copy of ``dhqr_tpu/utils/lockwitness.py``
(same semantics; that module imports no JAX, but the port imports nothing
of the JAX package).

Instrumented locks that record what actually happened: every shared lock
of the port's seams (the fault harness, the trace recorder) is made by
:func:`make_lock` / :func:`make_rlock`, and while a witness is armed each
successful acquisition records

* the **acquisition-order edge** from every lock the acquiring thread
  already holds to the one it just took (named edges, e.g.
  ``harness._INSTALL_LOCK -> FaultHarness._lock``), and
* **held-set violations**: re-acquiring a non-reentrant lock the thread
  already holds (a guaranteed self-deadlock — the witness raises it as a
  ``RuntimeError`` instead of hanging the test), and nesting two distinct
  instances under the same name (recorded as a ``name -> name``
  self-edge: instance locks of one class have no defined order).

Arming discipline, as for the fault harness and the trace recorder:

* **Disarmed is the default and costs one module-global read + None
  check per acquire** (``_ACTIVE is None``). No allocation, no
  thread-local touch, no accounting.
* ``DHQR_LOCKWITNESS=1`` in the environment arms a process-wide witness
  at first import; tests scope one with :func:`witnessing`.
* This module imports nothing but stdlib ``threading``/``os``/
  ``contextlib``.

The witness's own internal lock is a plain ``threading.Lock`` held only
for set/list updates while user locks are held — a leaf by construction,
and invisible to its own graph.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, Optional


class LockWitness:
    """One armed witnessing session: the edge set, the violation list,
    and the per-thread held stack. Normally managed through the module
    globals (:func:`arm` / :func:`witnessing`); constructed directly
    only by tests probing determinism."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._edges: "set[tuple[str, str]]" = set()   # guarded by: _lock
        self._violations: "list[dict]" = []           # guarded by: _lock
        self._acquires = 0
        self._held = threading.local()

    # ------------------------------------------------------------- recording

    def _stack(self) -> list:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    def note_acquiring(self, name: str, obj: object,
                       reentrant: bool) -> bool:
        """Pre-acquire check on the CALLING thread. Returns True when
        this is a reentrant re-entry (the post-acquire bump happens in
        :meth:`note_acquired`); raises ``RuntimeError`` on a
        non-reentrant re-acquire — the witness turns a guaranteed
        self-deadlock into a loud failure instead of a hung test."""
        for entry in self._stack():
            if entry[1] is obj:
                if reentrant:
                    return True
                violation = {
                    "kind": "reacquire-nonreentrant", "lock": name,
                    "thread": threading.current_thread().name,
                }
                with self._lock:
                    self._violations.append(violation)
                raise RuntimeError(
                    f"lock-witness: thread "
                    f"{violation['thread']!r} re-acquired non-reentrant "
                    f"lock {name!r} it already holds (self-deadlock)")
        return False

    def note_acquired(self, name: str, obj: object) -> None:
        """Post-acquire: push the held entry and record order edges
        from every lock this thread already holds. Two distinct
        instances under one name record the ``name -> name`` self-edge
        (rejected by the acyclicity gate — instance locks of one class
        have no defined order)."""
        stack = self._stack()
        for entry in stack:
            if entry[1] is obj:
                entry[2] += 1
                return
        new_edges = set()
        for held_name, held_obj, _count in stack:
            if held_name != name or held_obj is not obj:
                new_edges.add((held_name, name))
        stack.append([name, obj, 1])
        with self._lock:
            self._acquires += 1
            self._edges |= new_edges

    def note_released(self, obj: object) -> None:
        """Pop (or decrement) the held entry. A release of an object
        the witness never saw acquired (armed mid-critical-section) is
        silently ignored — arming must be safe at any moment."""
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][1] is obj:
                stack[i][2] -= 1
                if stack[i][2] <= 0:
                    del stack[i]
                return

    # --------------------------------------------------------------- reading

    def edges(self) -> "list[tuple[str, str]]":
        """The witnessed acquisition-order edges, sorted (deterministic
        across interleavings: the SET of edges depends only on which
        nestings occurred, not on when)."""
        with self._lock:
            return sorted(self._edges)

    def violations(self) -> "list[dict]":
        with self._lock:
            return list(self._violations)

    def stats(self) -> dict:
        with self._lock:
            return {
                "acquires": self._acquires,
                "edges": len(self._edges),
                "violations": len(self._violations),
            }


class _WitnessLock:
    """A named lock whose successful acquisitions are reported to the
    armed witness. Duck-types the ``threading.Lock`` surface the stack
    uses (``acquire``/``release``/context manager/``locked``), so
    ``threading.Condition(make_lock(...))`` works unchanged — the
    Condition's enter/exit/wait all route through this wrapper and the
    witness sees wait's release/reacquire correctly."""

    _REENTRANT = False
    __slots__ = ("name", "_inner", "_owner")

    def __init__(self, name: str, inner) -> None:
        self.name = str(name)
        self._inner = inner
        self._owner: "int | None" = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        witness = _ACTIVE
        if witness is None:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._owner = threading.get_ident()
            return got
        witness.note_acquiring(self.name, self, self._REENTRANT)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            # Deliberately the witness read BEFORE blocking: if a swap
            # happened while we waited, the acquire lands in the witness
            # that pre-checked it, never half in each.
            witness.note_acquired(self.name, self)
        return got

    def release(self) -> None:
        self._owner = None
        self._inner.release()
        witness = _ACTIVE
        if witness is not None:
            witness.note_released(self)

    def _is_owned(self) -> bool:
        # threading.Condition consults this when present. Without it,
        # Condition falls back to an acquire(False) PROBE — which the
        # armed witness would see as a self-deadlocking re-acquire.
        return self._owner == threading.get_ident()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} {self._inner!r}>"


class _WitnessRLock(_WitnessLock):
    __slots__ = ()
    _REENTRANT = True

    def _is_owned(self) -> bool:
        # threading.Condition consults this when present; the C RLock's
        # answer is authoritative (the acquire(0)-probe default is
        # wrong for reentrant locks).
        return self._inner._is_owned()


def make_lock(name: str) -> _WitnessLock:
    """A named non-reentrant lock (the seam every thread-shared class
    and module routes its ``threading.Lock()`` through)."""
    return _WitnessLock(name, threading.Lock())


def make_rlock(name: str) -> _WitnessRLock:
    """A named reentrant lock (same-thread re-entry bumps the held
    count, records no edge, and is never a violation)."""
    return _WitnessRLock(name, threading.RLock())


@contextlib.contextmanager
def witness_region(name: str) -> Iterator[None]:
    """Witness a lock-like region that is not a ``threading`` primitive
    — an advisory ``flock`` window, say. Each
    entry is a distinct witnessed object under ``name``, so nesting two
    flock windows records the rejected self-edge, exactly like two
    instance locks."""
    witness = _ACTIVE
    if witness is None:
        yield
        return
    token = object()
    witness.note_acquiring(name, token, False)
    witness.note_acquired(name, token)
    try:
        yield
    finally:
        witness.note_released(token)


# The one armed witness (or None — the fast path). Assignment is atomic
# under the GIL; every instrumented acquire reads it exactly once.
_ACTIVE: "LockWitness | None" = None
_ARM_LOCK = threading.Lock()


def arm(witness: "LockWitness | None" = None) -> LockWitness:
    """Arm a process-wide witness (a fresh one unless given). Replaces
    any previously armed witness; its recordings are dropped with it."""
    new = witness if witness is not None else LockWitness()
    global _ACTIVE
    with _ARM_LOCK:
        _ACTIVE = new
    return new


def disarm() -> None:
    """Back to the one-None-check path."""
    global _ACTIVE
    with _ARM_LOCK:
        _ACTIVE = None


def active() -> Optional[LockWitness]:
    """The armed witness, or None — THE hot-path read."""
    return _ACTIVE


@contextlib.contextmanager
def witnessing() -> Iterator[LockWitness]:
    """Scope a witnessing session: arm on entry, restore whatever was
    armed before on exit (scopes nest)."""
    witness = LockWitness()
    global _ACTIVE
    with _ARM_LOCK:
        previous = _ACTIVE
        _ACTIVE = witness
    try:
        yield witness
    finally:
        with _ARM_LOCK:
            _ACTIVE = previous


# CI arming: DHQR_LOCKWITNESS=1 in the environment arms one process-wide
# witness at first import — before any seam lock is acquired, since every
# instrumented module imports this one.
if os.environ.get("DHQR_LOCKWITNESS") == "1":  # pragma: no cover
    arm()
