"""Public-API consistency check (DHQR201/DHQR202) over the port: the twin
of ``dhqr_tpu/analysis/api_check.py``.

Everything ``dhqr_tpu_torch.__all__`` promises must (a) import cleanly —
``getattr`` succeeds on a fresh import — and (b) appear in the port's own
public-API table: the ``### Public API`` subsection of README.md's
``## PyTorch/CUDA port`` section (the JAX package's table in
docs/DESIGN.md documents the reference, not the port). A name that fails
(a) is a broken export; a name that fails (b) is an undocumented surface
users will find only by reading source.
"""

from __future__ import annotations

import os
import re

from dhqr_tpu_torch.analysis.findings import Finding

_INIT_PATH = "dhqr_tpu_torch/__init__.py"
_PORT_SECTION = "## PyTorch/CUDA port"
_API_SECTION = "### Public API"

#: This pass's rule-catalogue rows (assembled by analysis/cli.py).
RULES = (
    ("DHQR201", "__all__ export does not import cleanly", "api"),
    ("DHQR202", "public name missing from README.md's port API table",
     "api"),
)


def _api_table(doc: str) -> "str | None":
    """The text of the port section's ``### Public API`` subsection, or
    None. Only that table counts: common names (qr, solve) occur all over
    the prose, so a whole-document match would accept a table with the
    entry deleted."""
    port = re.search(rf"^{re.escape(_PORT_SECTION)}.*?$(.*?)(?=^## |\Z)",
                     doc, re.MULTILINE | re.DOTALL)
    if not port:
        return None
    table = re.search(rf"^{re.escape(_API_SECTION)}.*?$(.*?)(?=^##|\Z)",
                      port.group(1), re.MULTILINE | re.DOTALL)
    return table.group(1) if table else None


def check_api(readme: "str | None" = None) -> "list[Finding]":
    """Validate ``dhqr_tpu_torch.__all__`` against the import surface and
    the port's API table. ``readme`` defaults to README.md at the
    package's repo root."""
    import dhqr_tpu_torch

    if readme is None:
        repo = os.path.dirname(os.path.dirname(
            os.path.abspath(dhqr_tpu_torch.__file__)))
        readme = os.path.join(repo, "README.md")
    findings = []
    try:
        with open(readme, "r", encoding="utf-8") as fh:
            doc = fh.read()
    except OSError as e:
        return [Finding("DHQR202", _INIT_PATH, 0,
                        f"cannot read {readme}: {e}")]
    table = _api_table(doc)
    if table is None:
        findings.append(Finding(
            "DHQR202", _INIT_PATH, 0,
            f"README.md has no '{_API_SECTION}' subsection under "
            f"'{_PORT_SECTION}' — the API table the consistency check "
            "validates against is missing",
        ))
        table = ""
    for name in dhqr_tpu_torch.__all__:
        if name.startswith("__"):  # dunders (__version__) are metadata
            continue
        try:
            getattr(dhqr_tpu_torch, name)
        except Exception as e:
            findings.append(Finding(
                "DHQR201", _INIT_PATH, 0,
                f"__all__ entry {name!r} does not import cleanly: "
                f"{type(e).__name__}: {e}",
                snippet=name,
            ))
            continue
        if not re.search(rf"\b{re.escape(name)}\b", table):
            findings.append(Finding(
                "DHQR202", _INIT_PATH, 0,
                f"__all__ entry {name!r} is absent from README.md's "
                f"'{_API_SECTION}' table of the port — add it",
                snippet=name,
            ))
    return findings
