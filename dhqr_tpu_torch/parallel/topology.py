"""The two-tier (DCN x ICI) topology descriptor and axis resolution — the
port of ``dhqr_tpu/parallel/topology.py``.

Ranks do not all talk at the same speed: the ranks of one host reach each
other over NVLink (the fast tier, named ``ici`` after the JAX package's
TPU interconnect), and hosts reach each other over the network (the slow
tier, ``dcn``). :class:`TierAxes` names the two tiers so the wire seam
(:mod:`dhqr_tpu_torch.parallel.wire`) can reduce inside a host first,
cross the network once per collective in ``1/ici_size``-row chunks, and
gather back. The engines accept a :class:`TierAxes` anywhere they accept
an ``axis_name`` string; the helpers at the bottom are all an engine needs,
and each keeps the 1-D spelling unchanged for a string axis.

Topology discovery (:func:`detect_topology`): the ``DHQR_TOPO=PdcnxPici``
override (``DHQR_TOPO=2x2``) wins; otherwise the ranks are grouped by
host — the ranks of one host form an ICI domain and the hosts are the DCN
tier; one host, or hosts with unequal rank counts, is flat (None).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

DCN_AXIS = "dcn"
ICI_AXIS = "ici"

__all__ = [
    "DCN_AXIS",
    "ICI_AXIS",
    "TierAxes",
    "axis_index",
    "axis_label",
    "axis_size",
    "detect_topology",
    "parse_topo",
    "resolve_axis",
    "spec_axes",
]


@dataclasses.dataclass(frozen=True)
class TierAxes:
    """The two-tier axis the engines take in place of an ``axis_name``
    string (fields, checks and labels as the JAX package's).

    ``dcn`` / ``ici`` name the mesh's axes (outer: across hosts, inner:
    within one); ``dcn_size`` / ``ici_size`` are their extents (rank
    ``(d, i)`` of the pod mesh is flat rank ``d * ici_size + i``, the
    order of the 1-D mesh over the same group). ``hierarchical=True``
    selects the reduce-within-the-host-first schedule of the wire;
    ``False`` keeps one flat collective over both tiers, the baseline.
    Frozen and hashable.
    """

    dcn: str = DCN_AXIS
    ici: str = ICI_AXIS
    dcn_size: int = 1
    ici_size: int = 1
    hierarchical: bool = True

    def __post_init__(self):
        if self.dcn_size < 1 or self.ici_size < 1:
            raise ValueError(
                f"tier sizes must be >= 1, got "
                f"{self.dcn_size}x{self.ici_size}"
            )
        if self.dcn == self.ici:
            raise ValueError(
                f"the two tier axes must be distinct, got {self.dcn!r} "
                "for both"
            )

    @property
    def size(self) -> int:
        """Total rank count P = dcn_size * ici_size."""
        return self.dcn_size * self.ici_size

    def label(self) -> str:
        """Topology tag of the engine labels: ``"2x2"`` (hierarchical) /
        ``"2x2f"`` (flat): pulse measures once per label, so the two
        schedules must label apart."""
        return (f"{self.dcn_size}x{self.ici_size}"
                + ("" if self.hierarchical else "f"))


def parse_topo(spec: "str | None") -> "tuple[int, int] | None":
    """Parse a ``DHQR_TOPO``-style ``"PdcnxPici"`` spec (``"2x4"``) into
    ``(dcn_size, ici_size)``; None / empty passes through as None. A
    malformed spec raises: a typo that silently ran flat would mislabel
    every measurement taken under it."""
    if spec is None or not str(spec).strip():
        return None
    parts = str(spec).strip().lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) >= 1
                                  for p in parts):
        raise ValueError(
            f"DHQR_TOPO must look like '2x4' (DCNxICI, both >= 1), "
            f"got {spec!r}"
        )
    return int(parts[0]), int(parts[1])


def detect_topology(devices: Sequence,
                    n_devices: "int | None" = None
                    ) -> "tuple[int, int] | None":
    """``(dcn_size, ici_size)`` for the ranks whose host keys ``devices``
    lists (one entry per rank, in rank order: a hostname, or any value
    that is equal for the ranks of one host), or None when there is no
    two-tier structure.

    The ``DHQR_TOPO`` override wins (checked against the rank count; a
    ``1xP`` spec means flat). Otherwise the ranks are grouped by host
    key: several hosts with the same rank count each give
    ``(hosts, ranks per host)``; one host, or unequal groups, is flat.
    """
    count = int(n_devices if n_devices is not None else len(devices))
    spec = parse_topo(os.environ.get("DHQR_TOPO"))
    if spec is not None:
        dcn, ici = spec
        if dcn * ici != count:
            raise ValueError(
                f"DHQR_TOPO={dcn}x{ici} does not factor the device "
                f"count {count} (needs dcn*ici == P)"
            )
        return (dcn, ici) if dcn > 1 else None
    groups: "dict[object, int]" = {}
    for key in list(devices)[:count]:
        groups[key] = groups.get(key, 0) + 1
    sizes = set(groups.values())
    if len(groups) <= 1 or len(sizes) != 1:
        return None  # one host (flat), or ragged: no tier structure
    return len(groups), sizes.pop()


def resolve_axis(mesh, axis_name):
    """The entry points' resolution of ``axis_name`` on ``mesh``:

    * a :class:`TierAxes` passes through, checked against the mesh;
    * a string naming a mesh axis passes through (the 1-D tier);
    * a string on a ``("dcn", "ici")`` pod mesh resolves to its
      hierarchical :class:`TierAxes`, so the default ``axis_name`` works
      on a pod mesh.
    """
    names = tuple(mesh.axis_names)
    if isinstance(axis_name, TierAxes):
        for ax in (axis_name.dcn, axis_name.ici):
            if ax not in names:
                raise ValueError(
                    f"mesh axes {names} do not carry tier axis {ax!r}"
                )
        if (mesh.shape[axis_name.dcn] != axis_name.dcn_size
                or mesh.shape[axis_name.ici] != axis_name.ici_size):
            raise ValueError(
                f"TierAxes {axis_name.label()} does not match mesh "
                f"shape {dict(mesh.shape)}"
            )
        return axis_name
    if axis_name in names:
        return axis_name
    if DCN_AXIS in names and ICI_AXIS in names:
        return TierAxes(dcn_size=int(mesh.shape[DCN_AXIS]),
                        ici_size=int(mesh.shape[ICI_AXIS]))
    raise KeyError(
        f"axis {axis_name!r} not in mesh axes {names} and the mesh is "
        f"not a ({DCN_AXIS!r}, {ICI_AXIS!r}) pod mesh"
    )


def axis_size(mesh, axis) -> int:
    """Ranks along ``axis`` on ``mesh``: the product of both tiers for a
    :class:`TierAxes`, ``mesh.shape[axis]`` for a string."""
    if isinstance(axis, TierAxes):
        return int(mesh.shape[axis.dcn]) * int(mesh.shape[axis.ici])
    return int(mesh.shape[axis])


def spec_axes(axis):
    """The mesh axes a dimension sharded over ``axis`` spans: the
    ``(dcn, ici)`` tuple for a :class:`TierAxes` (dcn-major: block
    ``d * ici_size + i`` on rank ``(d, i)``), the string otherwise."""
    if isinstance(axis, TierAxes):
        return (axis.dcn, axis.ici)
    return axis


def axis_index(mesh, axis) -> int:
    """This rank's linear position along ``axis``: ``d * ici_size + i``
    for a :class:`TierAxes` (the order of :func:`spec_axes`), the rank
    for a string. The pod mesh numbers its ranks in that order, so both
    are ``mesh.rank``; the JAX package reads it from the traced axis."""
    if isinstance(axis, TierAxes):
        d, i = divmod(mesh.rank, axis.ici_size)
        return d * axis.ici_size + i
    return mesh.rank


def axis_label(axis, nproc: int) -> str:
    """The ``P=`` token of an engine label: the topology tag (``"2x2"`` /
    ``"2x2f"``) for a :class:`TierAxes`, the rank count for a 1-D axis."""
    if isinstance(axis, TierAxes):
        return axis.label()
    return str(int(nproc))
