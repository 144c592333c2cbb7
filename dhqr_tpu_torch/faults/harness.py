"""Deterministic, seedable fault injection — port of
``dhqr_tpu/faults/harness.py``.

A small registry of named injection points, armed by a
:class:`~dhqr_tpu_torch.utils.config.FaultConfig` (``DHQR_FAULTS`` in the
environment and :func:`install`, or the :func:`injected` scope):

* **Zero overhead when disarmed.** Every injection point is one
  module-global read and a ``None`` check (:func:`fire` / :func:`latency`).
* **Deterministic.** Each site draws from its own ``random.Random`` stream
  seeded by (config seed, site name) through ``crc32``, so a schedule
  string fires on the same visits in this package and in the JAX one, and
  one site's visits never shift another's schedule.
* **Accounted.** ``fired_<site>`` / ``visits_<site>`` counters, read by
  :meth:`FaultHarness.stats`.

The site table is the JAX package's, name for name, so that one schedule
string parses the same in both packages. The sites whose code the port
runs are ``numeric.nan`` (the guarded entry points' input screen,
``numeric/ladder.py``) and ``numeric.breakdown`` (each rung of the guarded
ladder, and each rank-1 step of ``solvers/update.py``). The serving
sites (``serve.*``) and the collective sites (``parallel.collective.*``,
consulted through :func:`wire_sites_armed`) belong to code that is not
ported yet: they parse and arm, and never fire.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
import zlib
from typing import Iterator, Optional

from dhqr_tpu_torch.utils import lockwitness as _lockwitness
from dhqr_tpu_torch.utils.config import FaultConfig
from dhqr_tpu_torch.utils.profiling import Counters

# site name -> action kind. "raise" sites throw FaultInjected when they
# trigger; "sleep" sites block for FaultConfig.latency_ms; "wire" sites
# are payload mutators of the collective seam (parallel/wire.py), one
# visit per collective, once the compressed wire and armor are ported.
SITES = {
    "serve.compile": "raise",
    "serve.dispatch": "raise",
    "serve.worker": "raise",
    "serve.store": "raise",
    "serve.latency": "sleep",
    "numeric.nan": "raise",
    "numeric.breakdown": "raise",
    "parallel.collective.corrupt": "wire",
    "parallel.collective.nan": "wire",
    "parallel.collective.drop": "wire",
}


class FaultInjected(RuntimeError):
    """The exception a triggered ``raise``-kind site throws. Carries the
    site name so downstream classification (and tests) can tell an
    injected failure from an organic one."""

    def __init__(self, site: str) -> None:
        super().__init__(f"injected fault at {site!r}")
        self.site = site


class _SiteState:
    __slots__ = ("prob", "remaining", "rng", "from_visit", "visits")

    def __init__(self, prob: float, max_triggers: "int | None",
                 rng: random.Random,
                 from_visit: "int | None" = None) -> None:
        self.prob = prob
        self.remaining = max_triggers  # None = unbounded
        self.rng = rng
        # Fire-on-kth-visit schedules (the :k config segment):
        # the first from_visit - 1 visits never trigger; prob/count
        # apply from visit from_visit onward. None = from the first.
        self.from_visit = from_visit
        self.visits = 0


class FaultHarness:
    """One armed fault schedule. Normally managed through the module
    globals (:func:`install` / :func:`injected`); constructed directly
    only by tests that probe determinism.

    ``sleeper`` is injectable so latency-site tests don't wall-clock
    sleep.
    """

    def __init__(self, config: FaultConfig,
                 sleeper=time.sleep) -> None:
        self.config = config
        self.counters = Counters()
        self._sleep = sleeper
        self._lock = _lockwitness.make_lock("FaultHarness._lock")
        # Dict SHAPE is frozen after __init__ (sites never appear or
        # vanish); the per-site _SiteState fields mutate under _lock.
        self._sites: "dict[str, _SiteState]" = {}  # guarded by: frozen
        for entry in config.sites:
            site, prob, count = entry[0], entry[1], entry[2]
            from_visit = entry[3] if len(entry) == 4 else None
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; registered sites: "
                    f"{', '.join(sorted(SITES))}")
            # One independent stream per site, derived stably from
            # (seed, site): crc32 rather than hash() so the schedule
            # survives PYTHONHASHSEED randomization.
            rng = random.Random(
                (config.seed << 32) ^ zlib.crc32(site.encode("utf-8")))
            self._sites[site] = _SiteState(prob, count, rng, from_visit)

    def should_fire(self, site: str) -> bool:
        """Draw the site's next decision (and account the visit)."""
        state = self._sites.get(site)
        if state is None:
            return False
        with self._lock:
            self.counters.bump(f"visits_{site}")
            state.visits += 1
            if state.from_visit is not None \
                    and state.visits < state.from_visit:
                return False    # the :k segment: silent before visit k
            if state.remaining is not None and state.remaining <= 0:
                return False
            if state.prob < 1.0 and state.rng.random() >= state.prob:
                return False
            if state.remaining is not None:
                state.remaining -= 1
            self.counters.bump(f"fired_{site}")
            return True

    def fire(self, site: str) -> None:
        """Raise :class:`FaultInjected` if the site triggers this visit."""
        if SITES.get(site) != "raise":
            raise ValueError(f"{site!r} is not a raise-kind fault site")
        if self.should_fire(site):
            raise FaultInjected(site)

    def latency(self, site: str) -> None:
        """Sleep ``latency_ms`` if the site triggers this visit."""
        if SITES.get(site) != "sleep":
            raise ValueError(f"{site!r} is not a sleep-kind fault site")
        if self.should_fire(site) and self.config.latency_ms > 0:
            self._sleep(self.config.latency_ms / 1e3)

    def stats(self) -> dict:
        """JSON-ready visit/trigger counts per configured site."""
        snap = self.counters.snapshot()
        return {
            site: {
                "visits": int(snap.get(f"visits_{site}", 0)),
                "fired": int(snap.get(f"fired_{site}", 0)),
            }
            for site in self._sites
        }


# The one armed harness (or None — the fast path). Assignment is atomic
# under the GIL; injection points read it exactly once per visit.
_ACTIVE: "FaultHarness | None" = None
_INSTALL_LOCK = _lockwitness.make_lock("harness._INSTALL_LOCK")
# Monotone arm/disarm generation: key material for anything that caches
# a decision taken under an armed schedule (the armor seam's token).
_EPOCH = 0


def epoch() -> int:
    """The harness arm/disarm generation — bumped by every
    :func:`install` / :func:`uninstall` (and :func:`injected` scope
    exit), never reset. Cache-key material for armed seams."""
    return _EPOCH


def wire_sites_armed() -> bool:
    """Whether the armed harness (if any) configures a
    ``parallel.collective.*`` site — the wire seam's one-read guard."""
    harness = _ACTIVE
    return harness is not None and any(
        site.startswith("parallel.collective.")
        for site in harness._sites)


def install(config: "FaultConfig | None" = None,
            sleeper=time.sleep) -> FaultHarness:
    """Arm the process-wide harness from ``config`` (default: the
    environment's ``DHQR_FAULTS*``). Replaces any previously armed
    harness. Returns the harness so callers can read its stats."""
    global _ACTIVE, _EPOCH
    cfg = config if config is not None else FaultConfig.from_env()
    harness = FaultHarness(cfg, sleeper=sleeper)
    with _INSTALL_LOCK:
        _ACTIVE = harness if cfg.enabled else None
        _EPOCH += 1
    return harness


def uninstall() -> None:
    """Disarm: every injection point reverts to the zero-overhead path."""
    global _ACTIVE, _EPOCH
    with _INSTALL_LOCK:
        _ACTIVE = None
        _EPOCH += 1


# Suspension depth: while the CALLING thread's depth > 0, active() reads
# None so no injection point fires OR accounts a visit (a measurement
# that re-runs a path must not consume the schedule's visits).
# THREAD-local, not process-global: another thread running a real armed
# call keeps its schedule firing and its visit indices intact.
_SUSPEND = threading.local()


@contextlib.contextmanager
def suspended() -> Iterator[None]:
    """Scope during which every injection point on THIS thread is inert
    and unvisited (nests; other threads' schedules are untouched)."""
    _SUSPEND.depth = getattr(_SUSPEND, "depth", 0) + 1
    try:
        yield
    finally:
        _SUSPEND.depth -= 1


def active() -> Optional[FaultHarness]:
    """The currently armed harness, or None (also None inside the
    calling thread's :func:`suspended` scope)."""
    if getattr(_SUSPEND, "depth", 0):
        return None
    return _ACTIVE


@contextlib.contextmanager
def injected(config: FaultConfig, sleeper=time.sleep) -> Iterator[FaultHarness]:
    """Scope a fault schedule: arm on entry, disarm on exit (restoring
    whatever was armed before — scopes nest)."""
    global _ACTIVE, _EPOCH
    with _INSTALL_LOCK:
        previous = _ACTIVE
    harness = install(config, sleeper=sleeper)
    try:
        yield harness
    finally:
        with _INSTALL_LOCK:
            _ACTIVE = previous
            _EPOCH += 1


def fire(site: str) -> None:
    """Injection point for ``raise``-kind sites: no-op unless a harness
    is armed AND the site triggers, in which case :class:`FaultInjected`
    propagates. THE hot-path entry — one :func:`active` read when
    disarmed (which honors :func:`suspended`: a suspended scope must
    silence raise/sleep sites too, not just the wire kind)."""
    harness = active()
    if harness is not None:
        harness.fire(site)


def latency(site: str = "serve.latency") -> None:
    """Injection point for ``sleep``-kind sites: no-op unless armed and
    triggered (inert inside a :func:`suspended` scope), in which case
    the configured latency is slept."""
    harness = active()
    if harness is not None:
        harness.latency(site)
