"""dhqr-lint CLI for the port: ``python -m dhqr_tpu_torch.analysis check
[paths] ...`` — the twin of ``dhqr_tpu/analysis/cli.py``.

Exit status 0 iff no unsuppressed, un-baselined findings; 1 on findings;
2 on a usage error (a lint target that does not exist, ``--prune-baseline``
without ``--baseline``) — the JAX package's codes. The AST pass runs on
every named path (default: ``dhqr_tpu_torch``, ``chip_smoke.py`` and
``tests/test_torch_*.py``). Whenever the ``dhqr_tpu_torch`` package itself
is among the scan targets, every other pass runs too, as in the JAX CLI:
the op-log sanitizer (``analysis/jaxpr_pass.py``, DHQR101-104), the
API-consistency check, the multi-rank comms-contract audit (dhqr-audit,
``analysis/comms_pass.py``, DHQR301-305), the xray and pulse smokes
(DHQR401/402), the route-registry drift audit (dhqr-atlas,
``analysis/atlas.py``, DHQR501-505) and the lock-discipline &
deadlock-order pass (dhqr-warden, ``analysis/concurrency_pass.py``,
DHQR601-604) — unless disabled with ``--no-jaxpr`` / ``--no-api`` /
``--no-comms`` / ``--no-xray`` / ``--no-pulse`` / ``--no-atlas`` /
``--no-concurrency``, or all at once with ``--fast`` (AST-only; the
concurrency pass's static half still runs, its lock-witness burst does
not). The passes that run code run it on ``--device`` (default the card;
``--device cpu`` on a host without one); ``--preset`` and ``--devices``
restrict the jaxpr/comms presets and the comms audit's rank counts
(default 2, 4 and 8). ``comms`` is the audit alone. ``--format
{text,json}`` selects the output shape (``--json`` is the legacy alias).
``--list-rules`` prints the rule catalogue of every pass.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from dhqr_tpu_torch.analysis._pending import by_design


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
    as an ancestor directory ('.', the repo root)? The passes beyond the
    AST rules validate the package itself, so they run for any target
    that contains it."""
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
    """(rule id, one-line summary, pass) for every rule — THE list
    ``--list-rules`` prints. Each pass module owns its ``RULES`` tuple;
    this function only assembles them."""
    from dhqr_tpu_torch.analysis import (
        api_check,
        atlas,
        comms_pass,
        concurrency_pass,
        jaxpr_pass,
        pulse_smoke,
        xray_smoke,
    )
    from dhqr_tpu_torch.analysis.ast_rules import AST_RULES

    rows = [("DHQR000", "source file failed to parse, or a suppression "
             "directive carries no reason (warn-only)", "ast")]
    rows += [(r.id, r.title, "ast") for r in AST_RULES]
    for mod in (jaxpr_pass, api_check, comms_pass, pulse_smoke,
                xray_smoke, atlas, concurrency_pass):
        rows += list(mod.RULES)
    return sorted(rows, key=lambda row: row[0])


#: The JAX CLI's multi-device CPU topology (ROADMAP "Not ported by
#: design").
_force_multidevice_env = by_design(
    "cli", "_force_multidevice_env",
    "it sets XLA_FLAGS for a forced multi-device CPU backend; the port's "
    "ranks are processes over torch.distributed")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dhqr_tpu_torch.analysis",
        description="dhqr-lint for the port: AST rules, the op-log and "
        "comms-contract passes, the smokes, the route atlas, the API check "
        "and the lock-discipline pass over dhqr_tpu_torch.",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue (ID, summary, pass) and exit",
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
        help="AST-only lint: skip every pass that runs code (jaxpr, api, "
        "comms, xray, pulse, atlas, the lock-witness burst; the "
        "concurrency pass's static half still runs) — seconds, for edit "
        "loops",
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
    check.add_argument("--no-jaxpr", action="store_true",
                       help="skip the op-log sanitizer pass")
    check.add_argument("--no-api", action="store_true",
                       help="skip the public-API consistency check")
    check.add_argument("--no-comms", action="store_true",
                       help="skip the multi-rank comms-contract audit")
    check.add_argument("--no-xray", action="store_true",
                       help="skip the xray introspection smoke (DHQR401)")
    check.add_argument("--no-pulse", action="store_true",
                       help="skip the pulse runtime-comms smoke (DHQR402)")
    check.add_argument("--no-atlas", action="store_true",
                       help="skip the route-registry drift audit "
                       "(DHQR501-DHQR505)")
    check.add_argument("--no-concurrency", action="store_true",
                       help="skip the lock-discipline & deadlock-order "
                       "pass (DHQR601-DHQR604)")
    comms = sub.add_parser(
        "comms", help="run only the comms-contract audit (dhqr-audit)")
    comms.add_argument("--json", action="store_true",
                       help="emit findings as JSON")
    for p in (check, comms):
        p.add_argument(
            "--device", default=None,
            help="where the passes run code (default the card; 'cpu' "
            "without one)")
        p.add_argument(
            "--preset", action="append", default=None,
            help="restrict the jaxpr/comms passes to these policy presets "
            "(repeatable; default: all)")
        p.add_argument(
            "--devices", action="append", type=int, default=None,
            metavar="P",
            help="comms-audit rank counts (repeatable; default: 2 4 8)")
        p.add_argument(
            "--contracts", default=None, metavar="FILE",
            help="comms-contract file (default: the committed "
            "analysis/comms_contracts.json)")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, summary, pass_name in rule_catalogue():
            print(f"{rule}  {pass_name:<5}  {summary}")
        return 0
    if not args.command:
        parser.error("a command is required (check, comms) unless "
                     "--list-rules is given")

    from dhqr_tpu_torch.analysis.comms_pass import (
        DEFAULT_DEVICE_COUNTS,
        run_comms_pass_auto,
    )

    device_counts = tuple(args.devices) if args.devices \
        else DEFAULT_DEVICE_COUNTS

    if args.command == "comms":
        findings = run_comms_pass_auto(
            presets=args.preset, device_counts=device_counts,
            contracts_path=args.contracts, device=args.device)
        active = [f for f in findings if not f.suppressed]
        if args.json:
            print(json.dumps({"findings": [f.to_json() for f in active],
                              "suppressed": [f.to_json() for f in findings
                                             if f.suppressed]}, indent=2))
        else:
            for f in findings:
                print(f.render())
            print(f"dhqr-audit: {len(active)} finding(s), "
                  f"{len(findings) - len(active)} suppressed",
                  file=sys.stderr)
        return 1 if active else 0

    from dhqr_tpu_torch.analysis.ast_rules import scan_paths
    from dhqr_tpu_torch.analysis.findings import (
        load_baseline,
        prune_baseline,
        write_baseline,
    )

    paths = args.paths or default_paths()
    if args.fast:
        args.no_jaxpr = args.no_api = args.no_comms = True
        args.no_xray = args.no_pulse = args.no_atlas = True
    try:
        findings = scan_paths(paths, rel_to=_repo_root())
    except FileNotFoundError as e:
        print(f"dhqr-lint: {e}", file=sys.stderr)
        return 2

    package = _scans_package(paths)
    if package and not args.no_jaxpr:
        from dhqr_tpu_torch.analysis.jaxpr_pass import run_jaxpr_pass

        findings.extend(run_jaxpr_pass(presets=args.preset,
                                       device=args.device))
    if package and not args.no_api:
        from dhqr_tpu_torch.analysis.api_check import check_api

        findings.extend(check_api())
    if package and not args.no_comms:
        findings.extend(run_comms_pass_auto(
            presets=args.preset, device_counts=device_counts,
            contracts_path=args.contracts, device=args.device))
    if package and not args.no_xray:
        from dhqr_tpu_torch.analysis.xray_smoke import run_xray_smoke

        findings.extend(run_xray_smoke(device=args.device))
    if package and not args.no_pulse:
        from dhqr_tpu_torch.analysis.pulse_smoke import run_pulse_smoke

        findings.extend(run_pulse_smoke(device=args.device))
    if package and not args.no_atlas:
        from dhqr_tpu_torch.analysis.atlas import run_atlas_pass

        findings.extend(run_atlas_pass(device=args.device))
    if package and not args.no_concurrency:
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
