"""Stubs for the names of the JAX package's ``analysis`` that have no
counterpart in the port, by design (ROADMAP.md "Not ported by design").

Each raises :class:`NotPortedError` with the reason, so a request for one
is never skipped silently.
"""

from __future__ import annotations

from dhqr_tpu_torch.utils.config import NotPortedError


def by_design(module: str, name: str, reason: str):
    """A stub for a name that has no counterpart in the port."""

    def stub(*args, **kwargs):
        raise NotPortedError(f"analysis.{module}.{name}",
                             "Queue A item 18, not ported by design",
                             reason)

    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = (f"The JAX package's ``analysis.{module}.{name}``: no "
                    f"counterpart in the port ({reason}).")
    return stub
