"""Plan-database keys — the part of ``dhqr_tpu/tune/db.py`` the port runs:
:func:`policy_tag`. The plan database itself waits for ROADMAP Queue A
item 14."""

from __future__ import annotations


def policy_tag(pol) -> str:
    """Canonical tag for the policy component of a key ("-" = no policy):
    the RESOLVED precision tuple, not the preset name, so two spellings of
    one tuple share a tag. A comms wire format appends ``/w<mode>`` only
    when set. The JAX package's spelling, character for character."""
    if pol is None:
        return "-"
    return (f"{pol.panel}/{pol.trailing or '-'}/"
            f"{pol.apply or '-'}/r{pol.refine}"
            + (f"/w{pol.comms}" if getattr(pol, "comms", None) else ""))
