"""Tracing and profiling — port of ``dhqr_tpu/utils/profiling.py``.

* :func:`phase` — a named region of the profiler's timeline while a
  profiler runs, one shared no-op context otherwise (a flag check per
  span). The single-device main path names its steps with it:
  ``dhqr.qr``, ``dhqr.lstsq`` and ``dhqr.solve`` around the entry
  points, ``dhqr.factor`` around the blocked engine, ``dhqr.panel``
  around each panel step (the kernel's launches and the geqrt3
  recursion), ``dhqr.trailing`` around each trailing update,
  ``dhqr.apply_qt`` around Q^H b and ``dhqr.back_substitute`` around
  R x = c;
* :func:`sync` — a device fence on the card(s) the given tensors live on
  (``torch.cuda.synchronize``), a no-op for CPU tensors;
* :class:`PhaseTimer` — wall-clock per-phase timing that fences on the
  tensors the body registered;
* :class:`Counters`, :class:`Ewma`, :class:`LatencyHistogram` — the
  serving tier's thread-safe accounting (the executable cache's counters
  and compile seconds, per-bucket dispatch time, latency percentiles);
* :func:`trace` — a ``torch.profiler`` session over a region that writes
  a Chrome trace into a directory (the JAX module's ``jax.profiler``
  session), the reader of ``ObsConfig.profile_dir``.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()
# The profiler's light span: recorded as an operator, so a kernel launched
# in it with no ATen op of its own (the panel kernel, through ctypes) is
# linked to it in the trace; a ``record_function`` span is a user
# annotation, which the profiler does not link kernels to.
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def phase(name: str):
    """Name a region in the profiler timeline: ``with phase(name): ...``.

    While no profiler runs this is one flag check and a shared no-op
    context: a span then adds no op to the program and enters no
    ``record_function``. Under ``torch.profiler`` (:func:`trace`) the
    region is recorded on the profiler's clock, in the same trace as the
    device's kernels, and each kernel launched in it outside any ATen op
    is linked to it."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast(name)


def _tensors(tree) -> "list[torch.Tensor]":
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for leaf in tree for t in _tensors(leaf)]
    if dataclass_fields := getattr(tree, "__dataclass_fields__", None):
        return [t for name in dataclass_fields
                for t in _tensors(getattr(tree, name))]
    return []


def sync(tree) -> None:
    """Fence on the device work behind every tensor in ``tree`` (nested
    lists, tuples, dicts and dataclasses): one ``torch.cuda.synchronize``
    per card they live on; CPU tensors need none."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Wall-clock per-phase timing.

    >>> timer = PhaseTimer()
    >>> with timer.measure("panel_factor"):
    ...     out = engine(A)          # the context syncs on ``out`` at exit
    ...     timer.observe(out)
    >>> timer.report()               # {'panel_factor': [0.0123]}

    Timings include device execution because ``measure`` fences with
    :func:`sync` on every tensor the body registered via ``observe``. The
    record list is guarded, so a reader on another thread (the serve
    cache's ``total("aot_compile")``) sees whole records; ``measure``
    itself is serialized by its caller.
    """

    def __init__(self) -> None:
        self._records: List[Tuple[str, float]] = []
        self._pending: list = []
        self._lock = threading.Lock()

    def observe(self, tree) -> None:
        """Register outputs for the end-of-phase device fence."""
        self._pending.append(tree)

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        self._pending = []
        # dhqr: ignore[DHQR008] PhaseTimer MEASURES real wall seconds (device time) — a fake clock here would be the bug
        t0 = time.perf_counter()
        try:
            with phase(name):
                yield
                if self._pending:
                    sync(self._pending)
            # dhqr: ignore[DHQR008] same measurement, closing read
            dt = time.perf_counter() - t0
            with self._lock:
                self._records.append((name, dt))
        finally:
            # a failed phase records nothing and keeps no stale tensors
            self._pending = []

    def report(self) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {}
        with self._lock:
            records = list(self._records)
        for name, dt in records:
            out.setdefault(name, []).append(dt)
        return out

    def total(self, name: str) -> float:
        with self._lock:
            return sum(dt for n, dt in self._records if n == name)

    def reset(self) -> None:
        with self._lock:
            self._records.clear()


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


class Ewma:
    """Exponentially weighted moving average, thread-safe; ``value`` is
    None until the first ``update``."""

    def __init__(self, alpha: float = 0.3) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._value: "float | None" = None
        self._lock = threading.Lock()

    def update(self, x: float) -> float:
        with self._lock:
            if self._value is None:
                self._value = float(x)
            else:
                self._value += self.alpha * (float(x) - self._value)
            return self._value

    @property
    def value(self) -> "float | None":
        with self._lock:
            return self._value


class LatencyHistogram:
    """Bounded log-bucketed latency histogram, thread-safe, fixed memory:
    buckets geometric from 1 us with ratio 2^(1/4) (124 of them reach
    ~1000 s, plus one overflow bucket); a percentile is the upper edge of
    the bucket holding it, biased high by at most one bucket (~19%). The
    JAX package's histogram, edge for edge."""

    _RATIO = 2.0 ** 0.25
    _FLOOR = 1e-6
    _NBUCKETS = 124
    _EDGES = [1e-6 * (2.0 ** 0.25) ** i for i in range(124)]

    def __init__(self) -> None:
        self._counts = [0] * (self._NBUCKETS + 1)
        self._total = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        idx = bisect.bisect_left(self._EDGES, float(seconds))
        with self._lock:
            self._counts[idx] += 1
            self._total += 1
            self._sum += float(seconds)

    @property
    def count(self) -> int:
        with self._lock:
            return self._total

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._total if self._total else 0.0

    def _percentile_locked(self, p: float) -> float:
        if not self._total:
            return 0.0
        target = max(1, int(-(-p * self._total // 1)))  # ceil(p*total)
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target:
                return self._EDGES[min(i, self._NBUCKETS - 1)]
        return self._EDGES[-1]  # pragma: no cover - unreachable

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-quantile (0 <= p <= 1);
        0.0 when empty."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        with self._lock:
            return self._percentile_locked(p)

    def snapshot(self) -> Dict[str, float]:
        """JSON-ready summary in milliseconds, one consistent cut."""
        with self._lock:
            return {
                "count": self._total,
                "mean_ms": round(
                    (self._sum / self._total if self._total else 0.0) * 1e3,
                    3),
                "p50_ms": round(self._percentile_locked(0.50) * 1e3, 3),
                "p99_ms": round(self._percentile_locked(0.99) * 1e3, 3),
            }



@contextlib.contextmanager
def trace(log_dir: "str | None" = None) -> Iterator[None]:
    """Profile the region with ``torch.profiler`` (the CPU, and the card
    when CUDA is present) and write its Chrome trace to
    ``<log_dir>/dhqr_trace_<pid>_<ns>.json`` — the ``@profilehtml``
    analogue. ``log_dir=None`` reads ``ObsConfig.profile_dir``
    (``DHQR_OBS_PROFILE``). View the file in perfetto or
    ``chrome://tracing``.

    >>> with trace("/tmp/dhqr_trace"):
    ...     x = lstsq(A, b)
    ...     sync(x)
    """
    if log_dir is None:
        from dhqr_tpu_torch.utils.config import ObsConfig

        log_dir = ObsConfig.from_env().profile_dir
        if log_dir is None:
            raise ValueError("trace() needs a directory: pass log_dir or "
                             "set DHQR_OBS_PROFILE")
    os.makedirs(str(log_dir), exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        # dhqr: ignore[DHQR008] a unique trace file name, not a timing decision
        str(log_dir), f"dhqr_trace_{os.getpid()}_{time.time_ns()}.json"))
