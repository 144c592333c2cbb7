"""Axis resolution for the port's 1-D mesh — the single-tier part of
``dhqr_tpu/parallel/topology.py`` (``resolve_axis``, ``axis_size``).
``axis_label`` builds only the labels of the armor and pulse seams, and
waits with them.

The JAX package's two-tier ``(dcn, ici)`` pod mesh (``TierAxes``,
``pod_mesh``) exists to run the hierarchical, compressed collectives of
its wire; neither is ported, so a two-tier axis spelling raises
:class:`~dhqr_tpu_torch.utils.config.NotPortedError`.
"""

from __future__ import annotations

from dhqr_tpu_torch.utils.config import NotPortedError

POD_ITEM = ("Queue A item 11 (the two-tier pod mesh, with the compressed "
            "wire)")


def resolve_axis(mesh, axis_name):
    """The engine entry points' resolution of ``axis_name`` on ``mesh``: a
    string naming the mesh's axis passes through; anything else (a
    ``TierAxes``-style two-tier spelling) raises ``NotPortedError``."""
    if not isinstance(axis_name, str):
        raise NotPortedError(f"the two-tier axis {axis_name!r}", POD_ITEM)
    names = tuple(mesh.axis_names)
    if axis_name in names:
        return axis_name
    raise KeyError(f"axis {axis_name!r} not in mesh axes {names}")


def axis_size(mesh, axis) -> int:
    """Ranks along ``axis`` (resolved) on the 1-D ``mesh``."""
    return int(mesh.shape[axis])

