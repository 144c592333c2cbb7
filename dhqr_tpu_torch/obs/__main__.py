"""``python -m dhqr_tpu_torch.obs <dump|xray|pulse|regress> ...`` — port of
``dhqr_tpu/obs/__main__.py``.

* ``dump [FILE ...] [--trace-id N] [--tenant T] [--bucket B] [--json]``
  — render flight-recorder dump files (the JSONL the ``on_error`` hook
  writes when ``ObsConfig.auto_dump`` names a directory). With no FILE,
  every ``flight_*.jsonl`` under ``DHQR_OBS_DUMP`` is rendered, newest
  first; ``--tenant`` / ``--bucket`` keep only traces whose span path
  carries the attribute.
* ``xray [FILE ...] [--json]`` — the per-cache-key table of xray reports
  found in artifact rows or ``XrayStore.export_jsonl`` files.
* ``pulse [FILE ...] [--json]`` — the per-label runtime-comms table of
  pulse reports found in artifact rows or ``PulseStore.export_jsonl``
  files.
* ``regress [--rules FILE] [--waivers FILE] [--repo DIR] [--json]
  [--prune-waivers]`` — the perf-regression gate over the committed
  bench trajectory (:mod:`dhqr_tpu_torch.obs.regress`): exit 0 green, 1
  on regressions, 2 on malformed inputs.

``--json`` on the table commands prints one JSON object per row instead
of the aligned table.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from dhqr_tpu_torch.obs.recorder import format_dump, read_dump_file


def _default_files() -> "list[str]":
    dest = os.environ.get("DHQR_OBS_DUMP", "").strip()
    if not dest or dest == "stderr" or not os.path.isdir(dest):
        return []
    files = glob.glob(os.path.join(dest, "flight_*.jsonl"))
    return sorted(files, key=os.path.getmtime, reverse=True)


def _span_attr_match(record: dict, attr: str, wanted: str) -> bool:
    """Does any span in the record carry ``attr == wanted``? The
    recorder indexes per-trace; tenant/bucket live as span attributes
    (submit stamps the tenant, flush/dispatch the bucket label), so a
    CLI filter is a walk over the span path."""
    return any(str(span.get(attr)) == wanted
               for span in record.get("spans", [])
               if isinstance(span, dict) and attr in span)


def _cmd_dump(args) -> int:
    files = args.files or _default_files()
    if not files:
        print("no dump files given and none found under DHQR_OBS_DUMP",
              file=sys.stderr)
        return 2
    shown = 0
    for path in files:
        try:
            records = read_dump_file(path)
        except OSError as e:
            print(f"cannot read {path}: {e}", file=sys.stderr)
            return 2
        for rec in records:
            if args.trace_id is not None \
                    and rec.get("trace_id") != args.trace_id:
                continue
            if args.tenant is not None \
                    and not _span_attr_match(rec, "tenant", args.tenant):
                continue
            if args.bucket is not None \
                    and not _span_attr_match(rec, "bucket", args.bucket):
                continue
            shown += 1
            if args.json:
                print(json.dumps(rec))
            else:
                print(format_dump(rec))
                print()
    if not shown:
        filters = [f"trace id {args.trace_id}"
                   if args.trace_id is not None else None,
                   f"tenant {args.tenant!r}"
                   if args.tenant is not None else None,
                   f"bucket {args.bucket!r}"
                   if args.bucket is not None else None]
        which = ", ".join(f for f in filters if f) or "records"
        print(f"no {which} found in {len(files)} file(s)", file=sys.stderr)
        return 1
    return 0


def _parse_records(path: str) -> "list[dict]":
    """Bench summary JSON (one object, possibly with stage rows inside)
    or a JSONL artifact: every parseable JSON object found."""
    records = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
    except OSError as e:
        print(f"cannot read {path}: {e}", file=sys.stderr)
        return records
    try:
        whole = json.loads(text)
        return whole if isinstance(whole, list) else [whole]
    # dhqr: ignore[DHQR006] format sniffing, not error handling: a file that is not ONE json document is parsed as JSONL below
    except ValueError:
        pass
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return records


def _cmd_table(args, kind: str) -> int:
    """Shared body of the ``xray`` and ``pulse`` table commands: parse
    the named files, extract the blocks, render the aligned table or
    (``--json``) one JSON object per row."""
    if kind == "xray":
        from dhqr_tpu_torch.obs.xray import format_table, rows_from_json
    else:
        from dhqr_tpu_torch.obs.pulse import format_table, rows_from_json

    if not args.files:
        print(f"obs {kind}: name the file(s) to render — a bench "
              "summary JSON, an artifact *.jsonl, or a store export",
              file=sys.stderr)
        return 2
    rows = []
    for path in args.files:
        rows.extend(rows_from_json(_parse_records(path)))
    if not rows:
        print(f"no {kind} blocks found in {len(args.files)} file(s)",
              file=sys.stderr)
        return 1
    if args.json:
        for row in rows:
            print(json.dumps(row))
    else:
        print(format_table(rows))
    return 0


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dhqr_tpu_torch.obs",
        description="Observability CLIs (dhqr-obs): flight dumps, the "
        "xray cost/memory table, the perf-regression gate.")
    sub = parser.add_subparsers(dest="command")

    dump = sub.add_parser(
        "dump", help="render flight dump files as span paths")
    dump.add_argument("files", nargs="*", metavar="FILE",
                      help="flight JSONL file(s); default: every "
                      "flight_*.jsonl under $DHQR_OBS_DUMP")
    dump.add_argument("--trace-id", type=int, default=None,
                      help="only this trace id")
    dump.add_argument("--tenant", default=None,
                      help="only traces whose span path names this "
                      "tenant (the submit span's tenant attribute)")
    dump.add_argument("--bucket", default=None,
                      help="only traces whose span path touches this "
                      "bucket label (e.g. 64x16:float32)")
    dump.add_argument("--json", action="store_true",
                      help="raw JSON records instead of formatted paths")

    xray = sub.add_parser(
        "xray", help="render the per-cache-key cost/memory table from "
        "bench summaries / artifact rows / XrayStore exports")
    xray.add_argument("files", nargs="*", metavar="FILE")
    xray.add_argument("--json", action="store_true",
                      help="one JSON row per key instead of the table")

    pulse = sub.add_parser(
        "pulse", help="render the per-label runtime-comms table "
        "(measured collectives, shard skew, DHQR306) from artifact "
        "rows / PulseStore exports")
    pulse.add_argument("files", nargs="*", metavar="FILE")
    pulse.add_argument("--json", action="store_true",
                       help="one JSON row per label instead of the table")

    regress = sub.add_parser(
        "regress", help="perf-regression gate over the committed bench "
        "trajectory (exit 1 on regressions)")
    regress.add_argument("--repo", default=None)
    regress.add_argument("--rules", default=None)
    regress.add_argument("--waivers", default=None)
    regress.add_argument("--json", action="store_true")
    regress.add_argument("--prune-waivers", action="store_true",
                         help="rewrite the waivers file dropping stale "
                         "entries (matching no current failure), then "
                         "gate against the pruned file")

    args = parser.parse_args(argv)
    if args.command == "dump":
        return _cmd_dump(args)
    if args.command in ("xray", "pulse"):
        return _cmd_table(args, args.command)
    if args.command == "regress":
        from dhqr_tpu_torch.obs import regress as _regress

        argv2 = []
        for flag in ("repo", "rules", "waivers"):
            if getattr(args, flag):
                argv2 += [f"--{flag}", getattr(args, flag)]
        if args.json:
            argv2.append("--json")
        if args.prune_waivers:
            argv2.append("--prune-waivers")
        return _regress.main(argv2)
    parser.error("a command is required (dump | xray | pulse | regress)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
