"""The port's distributed tier — twin of ``dhqr_tpu/parallel``.

One process per rank over a ``torch.distributed`` process group (the
reference's worker processes, each holding a column block —
src/DistributedHouseholderQR.jl:11-40); a :class:`ColumnMesh` names the
group, this rank's device and the axis. Every rank calls an entry point
with the same global inputs and keeps its own columns (or rows); every
collective goes through :mod:`dhqr_tpu_torch.parallel.wire`, at the wire
format ``comms=`` names. :func:`pod_mesh` gives the two-tier (hosts x
ranks per host) mesh and its :class:`TierAxes`, on which the collectives
run the hierarchical schedules.
"""

from dhqr_tpu_torch.parallel.layout import (
    ColumnBlock,
    area_balanced_splits,
    column_block_ranges,
    local_column_block,
)
from dhqr_tpu_torch.parallel.mesh import (
    ColumnMesh,
    PodMesh,
    column_mesh,
    column_sharding,
    pod_mesh,
    replicated_sharding,
    row_mesh,
)
from dhqr_tpu_torch.parallel.multihost import (
    global_column_mesh,
    global_pod_mesh,
    global_row_mesh,
    initialize,
    process_info,
)
from dhqr_tpu_torch.parallel.sharded_cholqr import sharded_cholqr_lstsq
from dhqr_tpu_torch.parallel.sharded_qr import (
    sharded_blocked_qr,
    sharded_householder_qr,
)
from dhqr_tpu_torch.parallel.sharded_solve import sharded_lstsq, sharded_solve
from dhqr_tpu_torch.parallel.sharded_tsqr import sharded_tsqr_lstsq
from dhqr_tpu_torch.parallel.topology import TierAxes

__all__ = [
    "ColumnBlock",
    "ColumnMesh",
    "PodMesh",
    "TierAxes",
    "area_balanced_splits",
    "column_block_ranges",
    "local_column_block",
    "column_mesh",
    "sharded_householder_qr",
    "sharded_blocked_qr",
    "sharded_solve",
    "sharded_lstsq",
    "row_mesh",
    "sharded_tsqr_lstsq",
    "sharded_cholqr_lstsq",
    "initialize",
    "global_column_mesh",
    "global_row_mesh",
    "process_info",
    "pod_mesh",
    "global_pod_mesh",
]
