"""enqueue_ms: the host's time inside the benchmark's spans around the
entry (from the call to its return, before the benchmark's synchronize),
per call, mean over the traced calls. A host synchronisation inside the
call shows as enqueue close to the call's whole time."""

ENTRY_SPANS = ("hqrbench.lstsq", "hqrbench.factor", "hqrbench.solve")


def read(view):
    spans = view.span_seconds(ENTRY_SPANS)
    if not spans or not view.calls:
        return None
    return 1e3 * sum(spans) / view.calls
