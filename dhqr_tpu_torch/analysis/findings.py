"""Finding records, inline suppressions, and the committed baseline — the
port's copy of ``dhqr_tpu/analysis/findings.py`` (same grammar and file
format; that module imports no JAX, but the port imports nothing of the
JAX package).

One Finding type serves every pass (the AST rules, the concurrency pass,
the API check) so the CLI, the baseline file and the tier-1 self-scan all
speak the same shape. Fingerprints are line-number-independent (rule +
path + source snippet) so a baseline survives unrelated edits above a
finding. Both packages keep one suppression grammar:
``# dhqr: ignore[RULE] reason``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re

# ``# dhqr: ignore[DHQR002] reason`` — one or more rule IDs, comma
# separated; the reason is free text, required by policy (README.md, the
# port's lint section). The parser still tolerates its absence — the
# suppression takes effect so the author's intent is honored — but a
# reason-less directive is no longer silent: it reports as a warn-only
# DHQR000 finding (:func:`missing_reason_findings`), so the policy is
# machine-checked instead of review-checked.
_SUPPRESS_RE = re.compile(
    r"#\s*dhqr:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*(.*?)\s*$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location (or traced entry point).

    ``path`` is the display path (posix, repo-relative where possible);
    ``line`` is 1-based (0 for whole-file / traced-program findings);
    ``snippet`` is the stripped source line, used for the baseline
    fingerprint; ``suppressed``/``reason`` record an inline
    ``# dhqr: ignore[...]`` that matched this finding. ``severity`` is
    ``"error"`` (gates the lint exit code) or ``"warning"`` (reported,
    baseline-able, never red on its own — the missing-reason DHQR000).
    """

    rule: str
    path: str
    line: int
    message: str
    snippet: str = ""
    suppressed: bool = False
    reason: str = ""
    severity: str = "error"

    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.snippet or self.message}"
        return hashlib.sha1(key.encode("utf-8")).hexdigest()[:16]

    def render(self) -> str:
        sup = f"  [suppressed: {self.reason or 'no reason given'}]" \
            if self.suppressed else ""
        sev = " (warning)" if self.severity == "warning" else ""
        return (f"{self.path}:{self.line}: {self.rule}{sev} "
                f"{self.message}{sup}")

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "snippet": self.snippet,
            "suppressed": self.suppressed,
            "reason": self.reason,
            "severity": self.severity,
            "fingerprint": self.fingerprint(),
        }


def parse_suppressions(lines: "list[str]") -> "dict[int, tuple[set, str]]":
    """Map 1-based line number -> (rule ids, reason) for every inline
    ``# dhqr: ignore[...]`` directive in ``lines``."""
    out = {}
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            rules = {r.strip().upper() for r in m.group(1).split(",")
                     if r.strip()}
            out[i] = (rules, m.group(2).strip())
    return out


def missing_reason_findings(lines: "list[str]",
                            path: str) -> "list[Finding]":
    """Warn-only DHQR000 for every ``# dhqr: ignore[...]`` directive
    whose reason parsed to the empty string: the suppression still works,
    but the "reason required" policy is machine-checked. Callers
    (ast_rules.scan_source) run this AFTER :func:`apply_suppressions` —
    a reason-less ``ignore[DHQR000]`` must not suppress its own
    missing-reason report."""
    out = []
    for line, (rules, reason) in parse_suppressions(lines).items():
        if reason:
            continue
        out.append(Finding(
            "DHQR000", path, line,
            f"suppression directive for {', '.join(sorted(rules))} "
            "carries no reason: the suppression still applies, but "
            "every inline ignore must say why — append the "
            "justification after the bracket",
            snippet=lines[line - 1].strip(),
            severity="warning",
        ))
    return out


def apply_suppressions(findings, suppressions) -> "list[Finding]":
    """Mark findings suppressed when the directive sits on the finding's
    line or the line immediately above (multi-line calls report the call's
    first line, so a directive above the statement also matches)."""
    out = []
    for f in findings:
        sup = None
        for ln in (f.line, f.line - 1):
            entry = suppressions.get(ln)
            if entry and f.rule in entry[0]:
                sup = entry
                break
        if sup is not None:
            f = dataclasses.replace(f, suppressed=True, reason=sup[1])
        out.append(f)
    return out


def load_baseline(path) -> "dict[str, int]":
    """Accepted fingerprints -> occurrence count. A multiset, not a set:
    two identical violation lines in one file share a fingerprint, and
    baselining one must not silently accept a later second one."""
    import collections

    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return collections.Counter(
        entry["fingerprint"] for entry in data.get("findings", []))


def prune_baseline(path, findings) -> "tuple[int, int]":
    """Rewrite the baseline at ``path`` keeping only entries whose
    fingerprint still matches a current finding — multiset-aware, like
    :func:`load_baseline`: N accepted occurrences survive only while N
    current findings still match. Returns ``(kept, removed)`` so the CLI
    can report how many stale entries were dropped. The file's own
    structure (comment, per-entry rule/path/snippet context) is
    preserved for the surviving entries."""
    import collections

    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    current = collections.Counter(
        f.fingerprint() for f in findings if not f.suppressed)
    kept, removed = [], 0
    for entry in data.get("findings", []):
        fp = entry.get("fingerprint")
        if current.get(fp, 0) > 0:
            current[fp] -= 1
            kept.append(entry)
        else:
            removed += 1
    if removed:
        data["findings"] = kept
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=2, sort_keys=True)
            fh.write("\n")
    return len(kept), removed


def write_baseline(path, findings) -> None:
    """Write the unsuppressed findings as the new accepted baseline."""
    payload = {
        "comment": (
            "dhqr-lint baseline: accepted pre-existing findings, keyed by "
            "line-independent fingerprint. Regenerate with "
            "`python -m dhqr_tpu_torch.analysis check ... "
            "--write-baseline <file>`. The shipped baseline is EMPTY by "
            "policy: new findings are fixed or inline-suppressed with a "
            "reason, not baselined."
        ),
        "findings": [
            {
                "fingerprint": f.fingerprint(),
                "rule": f.rule,
                "path": f.path,
                "snippet": f.snippet or f.message,
            }
            for f in findings
            if not f.suppressed
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


#: The port's shipped baseline; its ``graph_suppressions`` list holds the
#: graph passes' accepted findings, each with its reason.
SHIPPED_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "lint_baseline.json")


def load_graph_suppressions(path=None) -> "list[dict]":
    """The graph findings the eager engines make by design: entries
    ``{"rule", "snippet", "reason"}`` of the baseline's
    ``graph_suppressions`` list (a ``label`` key, when present, limits an
    entry to the entry points it matches, ``*`` matching any text). A graph finding has no source line
    to carry an inline ``# dhqr: ignore``; this list is its twin, and
    every entry must say why."""
    with open(path or SHIPPED_BASELINE, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return list(data.get("graph_suppressions", []))


def apply_graph_suppressions(findings, entries=None) -> "list[Finding]":
    """Mark the findings an entry of :func:`load_graph_suppressions`
    matches (same rule and snippet, and label when the entry names one)
    suppressed, with the entry's reason."""
    entries = load_graph_suppressions() if entries is None else entries
    out = []
    for f in findings:
        for e in entries:
            if e["rule"] == f.rule and e["snippet"] == f.snippet \
                    and _label_match(e.get("label", "*"), f.path):
                f = dataclasses.replace(f, suppressed=True,
                                        reason=e["reason"])
                break
        out.append(f)
    return out


def _label_match(pattern: str, label: str) -> bool:
    """``*`` matches any text; everything else (brackets too) literally."""
    rx = ".*".join(re.escape(part) for part in pattern.split("*"))
    return re.fullmatch(rx, label) is not None
