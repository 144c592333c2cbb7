"""The program's own spans in a trace, read from a :class:`TraceView`.

While a profiler runs, ``dhqr_tpu_torch`` names the steps of its
single-device main path with host spans on the profiler's clock:

* ``dhqr.qr``, ``dhqr.lstsq``, ``dhqr.solve``: the entry points, whole;
* ``dhqr.factor``: the blocked engine, whole;
* ``dhqr.panel``: one panel step (the kernel's launches, the geqrt3
  recursion's GEMMs and copies, the write-back);
* ``dhqr.trailing``: one trailing update (``tril``, the T factor, the two
  GEMMs, the triangular solve);
* ``dhqr.apply_qt``: Q^H b over every panel;
* ``dhqr.back_substitute``: R x = c.

They are the host events of ``view.host`` named ``dhqr.*``. Each device
operation of ``view.ops`` goes to the innermost span that holds the start
of the host operation it is linked to (the device event's ``linked`` is
that operation's ``corr``: the aten op behind a cuBLAS or elementwise
kernel, the enclosing span behind a kernel launched through ``ctypes``).
A device operation whose linked host operation the trace lacks is counted
as unattributed. A span's self time is its duration less the union of
its ``dhqr.*`` children. Uses only what the view holds; a trace with no
``dhqr.*`` span (a program without them) reads as empty, and every reader
built on it returns None.
"""

from __future__ import annotations

import bisect
import weakref

from hqrbench.trace import gaps

PREFIX = "dhqr."
API_SPANS = ("dhqr.qr", "dhqr.lstsq", "dhqr.solve")

_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class Program:
    """The ``dhqr.*`` spans of one view, nested, and the view's device
    operations attributed to them."""

    def __init__(self, view):
        self.view = view
        w0, w1 = view.window
        spans = sorted((e for e in view.host.events
                        if e.name.startswith(PREFIX)
                        and e.start >= w0 and e.end <= w1),
                       key=lambda e: (e.start, -e.end))
        self.spans = spans
        self._starts = [s.start for s in spans]
        # the innermost span holding each span, by a sweep over the starts
        self.parent: "list[int | None]" = []
        children: "list[list[int]]" = [[] for _ in spans]
        stack: "list[int]" = []
        for i, s in enumerate(spans):
            while stack and spans[stack[-1]].end < s.end:
                stack.pop()
            p = stack[-1] if stack else None
            self.parent.append(p)
            if p is not None:
                children[p].append(i)
            stack.append(i)
        self.children = children

        host_at = {e.corr: e.start for e in view.host.events if e.corr}
        # per device operation: the index of its span (None: outside every
        # span), and whether its linked host operation is in the trace
        self.op_span: "list[int | None]" = []
        self.linked: "list[bool]" = []
        for e, _, _ in view.ops:
            t = host_at.get(e.linked)
            self.op_span.append(None if t is None else self.innermost(t))
            self.linked.append(t is not None)

    def innermost(self, t: int) -> "int | None":
        """Index of the innermost span holding time ``t``, or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i is not None and i >= 0:
            if self.spans[i].end >= t:
                return i
            i = self.parent[i]
        return None

    def named(self, names) -> "list[int]":
        return [i for i, s in enumerate(self.spans) if s.name in names]

    def count(self, names) -> int:
        return len(self.named(names))

    def self_intervals(self, i: int) -> "list[tuple[int, int]]":
        """Span ``i``'s interval less its children's, as disjoint pieces."""
        s = self.spans[i]
        return gaps([(self.spans[c].start, self.spans[c].end)
                     for c in self.children[i]], s.start, s.end)

    def self_seconds(self, names) -> float:
        return sum(s1 - s0 for i in self.named(names)
                   for s0, s1 in self.self_intervals(i)) * 1e-9

    def device_seconds(self, names) -> float:
        """Summed durations of the device operations attributed to spans
        named ``names``."""
        return sum(e.seconds for (e, _, _), i in zip(self.view.ops,
                                                     self.op_span)
                   if i is not None and self.spans[i].name in names)

    def entry_shares(self, entry_spans) -> "dict[str, float]":
        """Device seconds whose launch the view puts in ``entry_spans``
        (the benchmark's spans around each call): attributed to a
        ``dhqr.*`` span, linked to a host operation outside every span,
        and unattributed."""
        out = {"dhqr": 0.0, "outside": 0.0, "unattributed": 0.0}
        for (e, _, span), i, linked in zip(self.view.ops, self.op_span,
                                           self.linked):
            if span in entry_spans:
                key = "dhqr" if i is not None else \
                    "outside" if linked else "unattributed"
                out[key] += e.seconds
        return out

    def unattributed_seconds(self) -> float:
        return sum(e.seconds for (e, _, _), linked in zip(self.view.ops,
                                                          self.linked)
                   if not linked)

    def idle_seconds(self, names) -> float:
        """Device-idle time (no device operation running, inside the
        window) that falls in the self time of the spans named ``names``."""
        w0, w1 = self.view.window
        idle = gaps([(max(e.start, w0), min(e.end, w1))
                     for e, _, _ in self.view.ops], w0, w1)
        mine = sorted(p for i in self.named(names)
                      for p in self.self_intervals(i))
        total, j = 0, 0
        for g0, g1 in idle:
            while j < len(mine) and mine[j][1] <= g0:
                j += 1
            k = j
            while k < len(mine) and mine[k][0] < g1:
                total += min(g1, mine[k][1]) - max(g0, mine[k][0])
                k += 1
        return total * 1e-9

    def whole_per_call(self, name: str) -> "int | None":
        """Spans named ``name`` per traced call, None unless every call
        holds the same count (or there are none)."""
        calls = self.view.calls
        count = self.count((name,))
        if not calls or not count or count % calls:
            return None
        return count // calls


def of(view) -> Program:
    """The :class:`Program` of ``view``, made once per view."""
    prog = _CACHE.get(view)
    if prog is None:
        prog = _CACHE[view] = Program(view)
    return prog
