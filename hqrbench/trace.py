"""Reduction of a profiler trace to what the per-layer readers read.

:func:`from_profiler` turns ``torch.profiler``'s raw events into plain
:class:`Event` records; :class:`TraceView` holds the traced window's
device operations (kernels, copies, fills), the benchmark's own spans
(``hqrbench.*``) and the host's operations, and attributes every device
operation to the span whose host interval holds its launch.

Device busy time is the union of the device operations' intervals: a sum
of their durations counts twice whatever two streams run at once.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from pathlib import Path

SPAN_PREFIX = "hqrbench."
CLASSES_DIR = Path(__file__).resolve().parent / "kernel_classes"
OTHER = "other"
DEVICE_KINDS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_KINDS = frozenset({"cuda_runtime", "cuda_driver"})
# The device-side copy of a host annotation: neither device work nor a span.
DEVICE_ANNOTATIONS = frozenset({"gpu_user_annotation"})
# Host operations looked at before an idle gap is put down to the span.
_NEAR = 64


@dataclasses.dataclass(frozen=True)
class Event:
    """One profiler event. ``kind`` is the profiler's activity type
    ("kernel", "gpu_memcpy", "gpu_memset" are device work; "cuda_runtime"
    and "cuda_driver" launch it; "cpu_op", "user_annotation" are host
    work); times in ns on one clock; ``corr`` the id shared by a launch and
    what it launched, ``linked`` the host operation a device event belongs
    to (0 when unknown)."""

    name: str
    kind: str
    start: int
    end: int
    corr: int = 0
    linked: int = 0

    @property
    def on_device(self) -> bool:
        return self.kind in DEVICE_KINDS

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


def union_ns(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: int, end: int) -> "list[tuple[int, int]]":
    """The stretches of ``[start, end)`` that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def load_classes(directory: Path = CLASSES_DIR) -> "list[tuple[str, re.Pattern]]":
    """``[(class, pattern), ...]`` from ``kernel_classes/<class>.json``
    (``{"patterns": [regex, ...]}``), in file-name order; the first class
    whose pattern matches a name takes it."""
    out = []
    for path in sorted(directory.glob("*.json")):
        for pat in json.loads(path.read_text())["patterns"]:
            out.append((path.stem, re.compile(pat)))
    return out


def classify(name: str, classes) -> str:
    for cls, pat in classes:
        if pat.search(name):
            return cls
    return OTHER


_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def _kind(e) -> str:
    """The activity type of a raw profiler event, from its device, its
    annotation flag and its name (the raw events carry no type of their
    own)."""
    from torch.autograd import DeviceType

    name = e.name()
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if e.device_type() == DeviceType.CPU:
        if annotation:
            return "user_annotation"
        return "cuda_runtime" if _RUNTIME.match(name) else "cpu_op"
    if annotation or name.startswith(SPAN_PREFIX):
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def from_profiler(prof) -> "list[Event]":
    """The raw events of a stopped ``torch.profiler.profile``, without the
    profiler's own tree building (which takes minutes on a long trace)."""
    return [Event(name=e.name(), kind=_kind(e), start=e.start_ns(),
                  end=e.end_ns(), corr=e.correlation_id(),
                  linked=e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events()]


class _Intervals:
    """Host intervals sorted by start, for "which one holds time t"."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e.start)
        self.starts = [e.start for e in self.events]

    def innermost(self, t: int, near: "int | None" = None):
        """The latest-starting interval that holds ``t``, looking back at
        most ``near`` intervals (None: all)."""
        i = bisect.bisect_right(self.starts, t) - 1
        stop = -1 if near is None else max(-1, i - near)
        while i > stop:
            if self.events[i].end >= t:
                return self.events[i]
            i -= 1
        return None


class TraceView:
    """The traced window: ``events`` from :func:`from_profiler` (or made by
    hand), ``calls`` the number of whole calls in it, ``ctx`` what the
    readers need of the cell (``m``, ``n``, ``item``, ``peak``).
    The window runs from the first benchmark span's start to the last
    one's end: the spans cover each call from its draw to its wait, on the
    trace's own clock.

    Each device operation is attributed to the benchmark span that held
    its launch: the runtime call with its correlation id, else the host
    operation it is linked to. The spans do not nest."""

    def __init__(self, events, calls: int, ctx: dict, classes=None):
        self.calls = calls
        self.ctx = ctx
        classes = load_classes() if classes is None else classes
        host = [e for e in events if not e.on_device
                and e.kind not in DEVICE_ANNOTATIONS]
        self.spans = _Intervals(e for e in host
                                if e.name.startswith(SPAN_PREFIX))
        if not self.spans.events:
            raise ValueError("the trace holds no benchmark span")
        w0 = self.spans.events[0].start
        w1 = max(e.end for e in self.spans.events)
        self.window = (w0, w1)
        self.host = _Intervals(e for e in host
                               if not e.name.startswith(SPAN_PREFIX)
                               and e.kind not in LAUNCH_KINDS
                               and e.end > w0 and e.start < w1)
        launch_at = {e.corr: e.start for e in host
                     if e.kind in LAUNCH_KINDS and e.corr}
        op_at = {e.corr: e.start for e in host
                 if e.kind not in LAUNCH_KINDS and e.corr}
        self.unattributed = 0
        self.ops = []
        for e in events:
            if not e.on_device or e.end <= w0 or e.start >= w1:
                continue
            t = launch_at.get(e.corr)
            if t is None:
                t = op_at.get(e.linked)
            span = None
            if t is None:
                self.unattributed += 1
            else:
                s = self.spans.innermost(t, 1)
                span = None if s is None else s.name
            self.ops.append((e, classify(e.name, classes), span))

    def window_seconds(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def _clipped(self, e: Event) -> "tuple[int, int]":
        return max(e.start, self.window[0]), min(e.end, self.window[1])

    def busy_seconds(self) -> float:
        """Union of every device operation's interval inside the window."""
        return union_ns(self._clipped(e) for e, _, _ in self.ops) * 1e-9

    def device_seconds(self, classes=None, spans=None) -> float:
        """Summed durations of the device operations of ``classes`` (None:
        all) attributed to ``spans`` (None: any)."""
        return sum(e.seconds for e, cls, span in self.ops
                   if (classes is None or cls in classes)
                   and (spans is None or span in spans))

    def count(self, classes=None, spans=None) -> int:
        return sum(1 for _, cls, span in self.ops
                   if (classes is None or cls in classes)
                   and (spans is None or span in spans))

    def span_seconds(self, names) -> "list[float]":
        """Durations of the benchmark spans named ``names`` in the window."""
        w0, w1 = self.window
        return [s.seconds for s in self.spans.events
                if s.name in names and s.start >= w0 and s.end <= w1]

    def span_class_seconds(self) -> "dict[str, dict[str, float]]":
        """Device seconds by span, then by class."""
        by = {}
        for e, cls, span in self.ops:
            row = by.setdefault(str(span), {})
            row[cls] = row.get(cls, 0.0) + e.seconds
        return by

    def top_device_ops(self, k: int = 10) -> "list[list]":
        """The device operations that took most time, by class and name."""
        by = {}
        for e, cls, _ in self.ops:
            key = f"[{cls}] {e.name[:120]}"
            by[key] = by.get(key, 0.0) + e.seconds
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> "list[list]":
        """Device idle time in the window, summed by the innermost host
        operation running at each gap's middle (the benchmark span when
        none is near), longest first."""
        by = {}
        for s, e in gaps([self._clipped(o) for o, _, _ in self.ops],
                         *self.window):
            mid = (s + e) // 2
            h = (self.host.innermost(mid, _NEAR)
                 or self.spans.innermost(mid, 1))
            name = "(no host op)" if h is None else h.name[:120]
            by[name] = by.get(name, 0.0) + (e - s) * 1e-9
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]
