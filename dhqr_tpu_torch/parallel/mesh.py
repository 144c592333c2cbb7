"""The port's mesh: one process per rank over a ``torch.distributed``
process group — the twin of ``dhqr_tpu/parallel/mesh.py``'s 1-D
``jax.sharding.Mesh``.

The JAX package runs a sharded factorization as ONE SPMD program over a
device mesh. Here every rank runs the same Python code in its own process
(the reference's worker processes, ``addprocs(np)`` at
test/runtests.jl:9, one column block each), and a :class:`ColumnMesh`
names what the engines need: the process group the collectives run on,
this rank's device, and the axis name the JAX API spells ``"cols"`` /
``"rows"``.

The two-tier :class:`PodMesh` (:func:`pod_mesh`) is the twin of the JAX
package's ``("dcn", "ici")`` mesh: the same group, seen as hosts x ranks
per host, with this rank's subgroup inside its host and across the hosts.
Apart from those subgroups, the port never creates, joins or switches a
process group on its own (:mod:`dhqr_tpu_torch.parallel.multihost` is the
caller's helper for that), and never moves a tensor off ``mesh.device``
to get around a backend: a collective the backend refuses raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from dhqr_tpu_torch.parallel import topology as _topo
from dhqr_tpu_torch.utils.device import resolve_device

DEFAULT_AXIS = "cols"
ROW_AXIS = "rows"


@dataclasses.dataclass(frozen=True)
class ColumnMesh:
    """A 1-D mesh over the ranks of ``group``.

    ``group``: a ``torch.distributed`` process group, None for the default
    (WORLD) group. ``device``: this rank's device; every tensor of a mesh
    call lives there. ``axis_name``: the mesh's one axis ("cols" for the
    column-sharded Householder engines, "rows" for TSQR / CholeskyQR).
    """

    group: object = None
    device: torch.device = None
    axis_name: str = DEFAULT_AXIS

    @property
    def rank(self) -> int:
        """This process's rank within ``group``."""
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """The number of ranks in ``group``."""
        return dist.get_world_size(self.group)

    def global_rank(self, r: int) -> int:
        """The default-group rank of ``group``'s rank ``r`` (what the
        collectives' ``src=`` takes)."""
        return r if self.group is None else dist.get_global_rank(self.group, r)

    @property
    def axis_names(self) -> "tuple[str]":
        return (self.axis_name,)

    @property
    def shape(self) -> "dict[str, int]":
        """``{axis_name: size}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: self.size}


def check_mesh(mesh) -> None:
    """Refuse a ``mesh=`` that is not the port's :class:`ColumnMesh`."""
    if not isinstance(mesh, ColumnMesh):
        raise TypeError(
            "mesh must be a dhqr_tpu_torch.parallel.ColumnMesh (column_mesh "
            f"/ row_mesh on an initialized process group), got "
            f"{type(mesh).__name__}")


@dataclasses.dataclass(frozen=True)
class PodMesh(ColumnMesh):
    """A two-tier ``("dcn", "ici")`` mesh over the ranks of ``group``:
    ``dcn_size`` hosts of ``ici_size`` ranks, rank ``(d, i)`` being the
    group's rank ``d * ici_size + i`` (the order of :func:`column_mesh`
    over the same group). ``ici_mesh`` is the 1-D mesh of this rank's host
    (its ``ici_size`` ranks, in order of ``i``), ``dcn_mesh`` the 1-D mesh
    of the ranks with this rank's ``i`` on every host (in order of
    ``d``); the wire runs the legs of its two-tier schedules on them."""

    dcn_size: int = 1
    ici_size: int = 1
    ici_mesh: Optional[ColumnMesh] = None
    dcn_mesh: Optional[ColumnMesh] = None

    @property
    def axis_names(self) -> "tuple[str, str]":
        return (_topo.DCN_AXIS, _topo.ICI_AXIS)

    @property
    def shape(self) -> "dict[str, int]":
        return {_topo.DCN_AXIS: self.dcn_size, _topo.ICI_AXIS: self.ici_size}


def _check_joined() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized torch.distributed process group: "
            "call torch.distributed.init_process_group (or "
            "dhqr_tpu_torch.parallel.initialize) on every rank first")


def _mesh_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pod_mesh(n_devices: Optional[int] = None,
             devices: Optional[Sequence] = None,
             topo: "tuple[int, int] | str | None" = None, *,
             group=None, device=None
             ) -> "tuple[PodMesh, _topo.TierAxes]":
    """The two-tier mesh over ``group`` (None: WORLD) for this rank, and
    its :class:`~dhqr_tpu_torch.parallel.topology.TierAxes`; every rank of
    the group must call it, in the same order as its other collectives
    (it makes the tiers' subgroups with ``dist.new_group``).

    ``topo`` is ``(dcn_size, ici_size)`` or a ``"2x2"`` spec; None asks
    :func:`~dhqr_tpu_torch.parallel.topology.detect_topology` with
    ``devices``, one host key per rank (None: each rank's hostname,
    gathered from the ranks). A flat set of ranks, or ``1xP``, gives a
    valid ``1xP`` pod mesh. ``n_devices``, when given, must be the group's
    size (the port's mesh spans its whole group: make a group of the
    ranks wanted and pass ``group=``). ``device`` as in
    :func:`column_mesh`."""
    from dhqr_tpu_torch.parallel import wire

    _check_joined()
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        if n_devices > size:
            raise ValueError(
                f"requested {n_devices} devices but only {size} visible")
        raise ValueError(
            f"the mesh spans its whole process group ({size} ranks), not "
            f"{n_devices}: make a group of those ranks "
            "(torch.distributed.new_group) and pass group=")
    if isinstance(topo, str):
        topo = _topo.parse_topo(topo)
    if topo is None:
        keys = wire.host_keys(group) if devices is None else list(devices)
        topo = _topo.detect_topology(keys, size) or (1, size)
    dcn, ici = int(topo[0]), int(topo[1])
    if dcn * ici != size:
        raise ValueError(
            f"topology {dcn}x{ici} does not factor the device count {size}")
    dev = _mesh_device(device)
    flat = ColumnMesh(group, dev)
    d, i = divmod(flat.rank, ici)
    members = [flat.global_rank(r) for r in range(size)]
    ici_group = dcn_group = None
    # Every rank makes every subgroup, in one order: new_group is a
    # collective call of the whole group.
    for dd in range(dcn):
        g = dist.new_group([members[dd * ici + ii] for ii in range(ici)])
        if dd == d:
            ici_group = g
    for ii in range(ici):
        g = dist.new_group([members[dd * ici + ii] for dd in range(dcn)])
        if ii == i:
            dcn_group = g
    mesh = PodMesh(group, dev, DEFAULT_AXIS, dcn, ici,
                   ColumnMesh(ici_group, dev, _topo.ICI_AXIS),
                   ColumnMesh(dcn_group, dev, _topo.DCN_AXIS))
    return mesh, _topo.TierAxes(dcn_size=dcn, ici_size=ici)


def column_mesh(group=None, device=None, axis_name: str = DEFAULT_AXIS
                ) -> ColumnMesh:
    """The column mesh over ``group`` (None: WORLD) for this rank.

    ``device=None`` follows the port's device rule
    (:func:`~dhqr_tpu_torch.utils.device.resolve_device`): the CUDA card,
    ``cuda:<torch.cuda.current_device()>``; pass ``device="cpu"`` for a
    gloo group on the CPU. The process group must already be initialized
    (``torch.distributed.init_process_group`` or
    :func:`~dhqr_tpu_torch.parallel.multihost.initialize`)."""
    _check_joined()
    mesh = ColumnMesh(group, _mesh_device(device), axis_name)
    if mesh.rank < 0:
        raise ValueError("this process is not a member of the mesh's group")
    return mesh


def row_mesh(group=None, device=None, axis_name: str = ROW_AXIS
             ) -> ColumnMesh:
    """1-D mesh over the row axis (the TSQR / CholeskyQR worker pool)."""
    return column_mesh(group, device, axis_name)


_NO_SHARDING = (
    "a jax NamedSharding places one array over a device mesh; here each "
    "rank holds its own tensors and the engines slice its block "
    "themselves, so there is no placement object to build")


def column_sharding(mesh, axis_name=DEFAULT_AXIS):
    """Raises :class:`~dhqr_tpu_torch.utils.config.NotPortedError`: the
    JAX package's ``NamedSharding`` of a column-split matrix."""
    from dhqr_tpu_torch.utils.config import NotPortedError

    del mesh, axis_name
    raise NotPortedError("parallel.column_sharding()",
                         "Queue A, Not ported by design",
                         reason=_NO_SHARDING)


def replicated_sharding(mesh):
    """Raises :class:`~dhqr_tpu_torch.utils.config.NotPortedError`: the
    JAX package's replicated ``NamedSharding``."""
    from dhqr_tpu_torch.utils.config import NotPortedError

    del mesh
    raise NotPortedError("parallel.replicated_sharding()",
                         "Queue A, Not ported by design",
                         reason=_NO_SHARDING)
