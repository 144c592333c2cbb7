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

The port never creates, joins or switches a process group on its own
(:mod:`dhqr_tpu_torch.parallel.multihost` is the caller's helper for
that), and never moves a tensor off ``mesh.device`` to get around a
backend: a collective the backend refuses raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

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


def column_mesh(group=None, device=None, axis_name: str = DEFAULT_AXIS
                ) -> ColumnMesh:
    """The column mesh over ``group`` (None: WORLD) for this rank.

    ``device=None`` follows the port's device rule
    (:func:`~dhqr_tpu_torch.utils.device.resolve_device`): the CUDA card,
    ``cuda:<torch.cuda.current_device()>``; pass ``device="cpu"`` for a
    gloo group on the CPU. The process group must already be initialized
    (``torch.distributed.init_process_group`` or
    :func:`~dhqr_tpu_torch.parallel.multihost.initialize`)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized torch.distributed process group: "
            "call torch.distributed.init_process_group (or "
            "dhqr_tpu_torch.parallel.initialize) on every rank first")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = ColumnMesh(group, dev, axis_name)
    if mesh.rank < 0:
        raise ValueError("this process is not a member of the mesh's group")
    return mesh


def row_mesh(group=None, device=None, axis_name: str = ROW_AXIS
             ) -> ColumnMesh:
    """1-D mesh over the row axis (the TSQR / CholeskyQR worker pool)."""
    return column_mesh(group, device, axis_name)
