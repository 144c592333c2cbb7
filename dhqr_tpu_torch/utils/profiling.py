"""Named counters — the port's copy of ``Counters`` from
``dhqr_tpu/utils/profiling.py`` (the rest of that module waits for the
observability slice)."""

from __future__ import annotations

import threading
from typing import Dict


class Counters:
    """Monotonic named counters (int or float increments), thread-safe:
    ``bump`` and ``snapshot`` take one lock, so a snapshot is one
    consistent cut."""

    def __init__(self) -> None:
        self._counts: Dict[str, float] = {}
        self._lock = threading.Lock()

    def bump(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, float]:
        """A point-in-time copy — subtract two snapshots for a delta."""
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
