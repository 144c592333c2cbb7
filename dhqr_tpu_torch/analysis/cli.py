"""dhqr-lint CLI for the port: ``python -m dhqr_tpu_torch.analysis check
[paths] ...`` — the twin of ``dhqr_tpu/analysis/cli.py``.

Exit status 0 iff no unsuppressed, un-baselined findings; 1 on findings;
2 on a usage error (a lint target that does not exist, ``--prune-baseline``
without ``--baseline``) — the JAX package's codes. The AST pass runs on
every named path (default: ``dhqr_tpu_torch``, ``chip_smoke.py`` and
``tests/test_torch_*.py``); the API-consistency check and the
lock-discipline & deadlock-order pass (dhqr-warden,
``analysis/concurrency_pass.py``, DHQR601-DHQR604) run whenever the
``dhqr_tpu_torch`` package itself is among the scan targets, unless
disabled with ``--no-api`` / ``--no-concurrency``. ``--fast`` skips the
API check and the concurrency pass's runtime lock-witness burst (its
static half still runs). The witness burst runs on ``--device`` (default
the card; ``--device cpu`` on a host without one).

The graph passes wait for ROADMAP item 18b: asking for one (``--jaxpr``,
``--comms``, ``--atlas``, ``--xray``, ``--pulse``, or the ``comms``
command) raises ``NotPortedError`` naming the item, never a silent skip.
``--format {text,json}`` selects the output shape (``--json`` is the
legacy alias). ``--list-rules`` prints the rule catalogue of the ported
passes.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from dhqr_tpu_torch.analysis._pending import by_design

#: The graph passes of the JAX CLI, and the stub module each waits in.
PENDING_PASSES = ("jaxpr", "comms", "atlas", "xray", "pulse")


def _repo_root() -> str:
    import dhqr_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        dhqr_tpu_torch.__file__)))


def default_paths() -> "list[str]":
    """The default scan: the package, the card's smoke run and the
    port's test files."""
    root = _repo_root()
    paths = [os.path.join(root, "dhqr_tpu_torch")]
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.exists(smoke):
        paths.append(smoke)
    paths += sorted(glob.glob(os.path.join(root, "tests",
                                           "test_torch_*.py")))
    return paths


def _scans_package(paths) -> bool:
    """Do the scan targets cover the dhqr_tpu_torch package — by name, or
    as an ancestor directory ('.', the repo root)? The API check and the
    concurrency pass validate the package itself, so they run for any
    target that contains it."""
    import dhqr_tpu_torch

    pkg = os.path.realpath(os.path.dirname(os.path.abspath(
        dhqr_tpu_torch.__file__)))
    for p in paths:
        rp = os.path.realpath(p)
        if rp == pkg or (os.path.isdir(rp)
                         and pkg.startswith(rp + os.sep)):
            return True
    return False


def rule_catalogue() -> "list[tuple[str, str, str]]":
    """(rule id, one-line summary, pass) for every rule of the ported
    passes — THE list ``--list-rules`` prints. Each pass module owns its
    ``RULES`` tuple; this function only assembles them."""
    from dhqr_tpu_torch.analysis import api_check, concurrency_pass
    from dhqr_tpu_torch.analysis.ast_rules import AST_RULES

    rows = [("DHQR000", "source file failed to parse, or a suppression "
             "directive carries no reason (warn-only)", "ast")]
    rows += [(r.id, r.title, "ast") for r in AST_RULES]
    for mod in (api_check, concurrency_pass):
        rows += list(mod.RULES)
    return sorted(rows, key=lambda row: row[0])


def _raise_pending(name: str) -> None:
    """Raise the 18b stub of the graph pass ``name``."""
    from dhqr_tpu_torch.analysis import (
        atlas,
        comms_pass,
        jaxpr_pass,
        pulse_smoke,
        xray_smoke,
    )

    {"jaxpr": jaxpr_pass.run_jaxpr_pass,
     "comms": comms_pass.run_comms_pass,
     "atlas": atlas.run_atlas_pass,
     "xray": xray_smoke.run_xray_smoke,
     "pulse": pulse_smoke.run_pulse_smoke}[name]()


#: The JAX CLI's multi-device CPU topology (ROADMAP "Not ported by
#: design").
_force_multidevice_env = by_design(
    "cli", "_force_multidevice_env",
    "it sets XLA_FLAGS for a forced multi-device CPU backend; the port's "
    "ranks are processes over torch.distributed")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dhqr_tpu_torch.analysis",
        description="dhqr-lint for the port: AST rules, the API check and "
        "the lock-discipline pass over dhqr_tpu_torch.",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue of the ported passes (ID, summary, "
        "pass) and exit",
    )
    sub = parser.add_subparsers(dest="command")
    check = sub.add_parser("check", help="run the lint passes")
    check.add_argument(
        "paths", nargs="*", default=None,
        help="files/directories to scan (default: dhqr_tpu_torch, "
        "chip_smoke.py, tests/test_torch_*.py)",
    )
    check.add_argument("--json", action="store_true",
                       help="emit findings as JSON (alias for "
                       "--format json)")
    check.add_argument("--format", choices=("text", "json"), default=None,
                       help="output format (default text)")
    check.add_argument(
        "--fast", action="store_true",
        help="skip the API check and the runtime lock-witness burst (the "
        "concurrency pass's static half still runs)",
    )
    check.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="accepted-findings file: matching fingerprints do not fail "
        "the run (shipped: dhqr_tpu_torch/analysis/lint_baseline.json, "
        "empty)",
    )
    check.add_argument(
        "--write-baseline", default=None, metavar="FILE",
        help="write the current unsuppressed findings as a new baseline "
        "and exit 0",
    )
    check.add_argument(
        "--prune-baseline", action="store_true",
        help="rewrite --baseline dropping fingerprints that no longer "
        "match any current finding, then gate against the pruned file",
    )
    check.add_argument("--no-api", action="store_true",
                       help="skip the public-API consistency check")
    check.add_argument("--no-concurrency", action="store_true",
                       help="skip the lock-discipline & deadlock-order "
                       "pass (DHQR601-DHQR604)")
    check.add_argument(
        "--device", default=None,
        help="the device of the lock-witness burst (default the card; "
        "'cpu' without one)",
    )
    for name in PENDING_PASSES:
        check.add_argument(
            f"--{name}", action="store_true",
            help=f"the {name} pass: not ported yet (ROADMAP item 18b; "
            "raises)")
    sub.add_parser("comms", help="the comms-contract audit: not ported "
                   "yet (ROADMAP item 18b; raises)")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, summary, pass_name in rule_catalogue():
            print(f"{rule}  {pass_name:<5}  {summary}")
        return 0
    if not args.command:
        parser.error("a command is required (check) unless --list-rules "
                     "is given")
    if args.command == "comms":
        _raise_pending("comms")
    for name in PENDING_PASSES:
        if getattr(args, name):
            _raise_pending(name)

    from dhqr_tpu_torch.analysis.ast_rules import scan_paths
    from dhqr_tpu_torch.analysis.findings import (
        load_baseline,
        prune_baseline,
        write_baseline,
    )

    paths = args.paths or default_paths()
    if args.fast:
        args.no_api = True
    try:
        findings = scan_paths(paths, rel_to=_repo_root())
    except FileNotFoundError as e:
        print(f"dhqr-lint: {e}", file=sys.stderr)
        return 2

    if _scans_package(paths) and not args.no_api:
        from dhqr_tpu_torch.analysis.api_check import check_api

        findings.extend(check_api())
    if _scans_package(paths) and not args.no_concurrency:
        from dhqr_tpu_torch.analysis.concurrency_pass import (
            run_concurrency_pass,
        )

        findings.extend(run_concurrency_pass(witness=not args.fast,
                                             device=args.device))

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"baseline written: {args.write_baseline} "
              f"({sum(1 for f in findings if not f.suppressed)} findings)")
        return 0

    if args.prune_baseline:
        if not args.baseline:
            print("dhqr-lint: --prune-baseline requires --baseline FILE",
                  file=sys.stderr)
            return 2
        kept, removed = prune_baseline(args.baseline, findings)
        print(f"dhqr-lint: baseline pruned — {removed} stale "
              f"entr{'y' if removed == 1 else 'ies'} removed, "
              f"{kept} kept", file=sys.stderr)

    baseline = dict(load_baseline(args.baseline)) if args.baseline else {}
    active, baselined = [], []
    suppressed = [f for f in findings if f.suppressed]
    for f in findings:
        if f.suppressed:
            continue
        fp = f.fingerprint()
        if baseline.get(fp, 0) > 0:  # multiset: each accepted occurrence
            baseline[fp] -= 1        # absorbs exactly one finding
            baselined.append(f)
        else:
            active.append(f)

    # Warn-only findings (the missing-reason DHQR000) are reported — and
    # baseline-able above — but never gate the exit code on their own.
    errors = [f for f in active if f.severity != "warning"]
    warnings = [f for f in active if f.severity == "warning"]

    if args.json or args.format == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in errors],
            "warnings": [f.to_json() for f in warnings],
            "suppressed": [f.to_json() for f in suppressed],
            "baselined": [f.to_json() for f in baselined],
        }, indent=2))
    else:
        for f in errors:
            print(f.render())
        for f in warnings:
            print(f.render())
        print(f"dhqr-lint: {len(errors)} finding(s), "
              f"{len(warnings)} warning(s), "
              f"{len(suppressed)} suppressed, {len(baselined)} baselined",
              file=sys.stderr)
    return 1 if errors else 0
