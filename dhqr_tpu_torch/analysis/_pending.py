"""The graph passes of dhqr-lint that wait for ROADMAP item 18b.

Each public name of the JAX package's ``jaxpr_pass``, ``comms_pass``,
``cost_model``, ``atlas``, ``pulse_smoke`` and ``xray_smoke`` has a twin
at its path that raises :class:`NotPortedError` naming the item, so a
request for one of those passes is never skipped silently.
"""

from __future__ import annotations

from dhqr_tpu_torch.utils.config import NotPortedError

#: The ROADMAP item the graph passes arrive with.
ITEM = "Queue A item 18b (the graph passes of analysis/)"


def pending(module: str, name: str):
    """A stub for the JAX package's ``analysis.<module>.<name>``."""

    def stub(*args, **kwargs):
        raise NotPortedError(f"analysis.{module}.{name}", ITEM)

    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = (f"The JAX package's ``analysis.{module}.{name}``: not "
                    f"ported yet (ROADMAP.md {ITEM}).")
    return stub


def by_design(module: str, name: str, reason: str):
    """A stub for a name that has no counterpart in the port."""

    def stub(*args, **kwargs):
        raise NotPortedError(f"analysis.{module}.{name}",
                             "Queue A item 18a, not ported by design",
                             reason)

    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = (f"The JAX package's ``analysis.{module}.{name}``: no "
                    f"counterpart in the port ({reason}).")
    return stub
