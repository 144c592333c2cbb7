"""Flight recorder: persist and render a failed request's span path —
port of ``dhqr_tpu/obs/recorder.py``.

A typed error carries its trace id (``exc.trace_id`` / ``exc.trace_ids``,
stamped by :meth:`~dhqr_tpu_torch.obs.trace.TraceRecorder.attach`), the
ring buffer still holds the request's spans, and this module turns the
two into evidence:

* :func:`dump_error` — every affected trace id's span path, JSON-ready;
* :func:`write_error_dump` — the ``on_error`` auto-dump hook's writer
  (``ObsConfig.auto_dump``): formatted to stderr, or appended as JSONL to
  ``<dir>/flight_<pid>.jsonl``;
* :func:`format_dump` — the human rendering of one dump;
* :func:`read_dump_file` — parse a flight JSONL file.

It reads no tensor: rendering a dump from a crashed run needs no device.
"""

from __future__ import annotations

import json
import os
from typing import Iterable


def dump_error(exc: BaseException, recorder=None) -> "list[dict]":
    """Flight dumps for every trace id a typed error carries (empty
    when the error was raised untraced). ``recorder`` defaults to the
    armed one."""
    if recorder is None:
        from dhqr_tpu_torch.obs import trace as _trace

        recorder = _trace.active()
    if recorder is None:
        return []
    tids = getattr(exc, "trace_ids", None) or ()
    if not tids and getattr(exc, "trace_id", None) is not None:
        tids = (exc.trace_id,)
    return [_error_record(recorder, exc, tid) for tid in tids]


def _error_record(recorder, exc: BaseException, trace_id: int) -> dict:
    rec = recorder.dump(trace_id)
    rec["error"] = type(exc).__name__
    rec["message"] = str(exc)[:500]
    return rec


def format_dump(record: dict) -> str:
    """One flight dump as readable lines: the error header, then the
    span path with per-hop deltas relative to the first span.

    >>> trace 3: IllConditioned: input has an exactly-zero column ...
    >>>   +0.000s submit      kind=guarded_lstsq engine=householder ...
    >>>   +0.004s resolve     outcome=IllConditioned error=input has ...
    """
    spans = record.get("spans", [])
    header = f"trace {record.get('trace_id', '?')}"
    if record.get("error"):
        header += f": {record['error']}: {record.get('message', '')}"
    lines = [header]
    if not spans:
        lines.append("  (no spans resident — evicted from the ring, or "
                     "the request ran untraced)")
        return "\n".join(lines)
    t0 = spans[0].get("t", 0.0)
    for span in spans:
        attrs = " ".join(
            f"{k}={_compact(v)}" for k, v in span.items()
            if k not in ("trace_id", "seq", "t", "name"))
        lines.append(f"  +{span.get('t', t0) - t0:.3f}s "
                     f"{span.get('name', '?'):<12} {attrs}".rstrip())
    return "\n".join(lines)


def _compact(value) -> str:
    if isinstance(value, float):
        return f"{value:.4g}"
    text = str(value)
    return text if len(text) <= 120 else text[:117] + "..."


def write_error_dump(recorder, exc: BaseException,
                     trace_ids: Iterable[int], destination: str) -> None:
    """The ``on_error`` hook's writer: ``destination="stderr"`` prints
    the formatted path(s); anything else is a directory receiving one
    JSONL line per dump in ``flight_<pid>.jsonl`` (the file
    :func:`read_dump_file` reads)."""
    records = [_error_record(recorder, exc, tid) for tid in trace_ids]
    if destination == "stderr":
        import sys

        for rec in records:
            print(format_dump(rec), file=sys.stderr, flush=True)
        return
    os.makedirs(destination, exist_ok=True)
    path = os.path.join(destination, f"flight_{os.getpid()}.jsonl")
    with open(path, "a", encoding="utf-8") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")


def read_dump_file(path: str) -> "list[dict]":
    """Parse a flight JSONL file; malformed lines are skipped with a
    count rather than failing the whole read (a dump cut off by a
    crash is still evidence)."""
    records, skipped = [], 0
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                skipped += 1
    if skipped:
        records.append({"trace_id": None, "spans": [],
                        "error": "DumpTruncated",
                        "message": f"{skipped} unparseable line(s) skipped"})
    return records
