"""Joining the ranks — the twin of ``dhqr_tpu/parallel/multihost.py``.

The JAX package forms its global runtime with
``jax.distributed.initialize`` and builds one mesh over every device of
every host. The port runs one process per rank: :func:`initialize` joins
the default ``torch.distributed`` process group, with the address, world
size and rank given, or read from the variables ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``). Then every rank builds the same mesh:

    from dhqr_tpu_torch.parallel import initialize, global_column_mesh
    initialize()                       # under torchrun, on every rank
    mesh = global_column_mesh()        # this rank's card
    x = dhqr_tpu_torch.lstsq(A, b, mesh=mesh)

The column axis carries one broadcast per panel, so it belongs on NVLink
within a node; TSQR's one all-gather tolerates a slower network, so its
row axis may span nodes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from dhqr_tpu_torch.parallel.mesh import (
    DEFAULT_AXIS,
    ROW_AXIS,
    column_mesh,
    pod_mesh,
    row_mesh,
)

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, **kwargs) -> None:
    """Join the default process group (no-op when already initialized).

    ``coordinator_address`` ("host:port", rank 0's) becomes the
    ``tcp://`` rendezvous, with ``num_processes`` ranks of which this is
    ``process_id``; without them the ``torchrun`` variables are read. A
    single process with neither arguments nor a managed environment is a
    no-op (the same script then runs standalone, the reference's np = 1
    mode). ``backend`` defaults to NCCL where CUDA is available, gloo
    otherwise; under ``torchrun`` the current CUDA device becomes
    ``LOCAL_RANK``'s. Other keywords go to ``init_process_group``.
    """
    if dist.is_initialized():
        return
    requested = (coordinator_address is not None or num_processes is not None
                 or process_id is not None or bool(kwargs))
    managed = all(v in os.environ for v in _TORCHRUN_VARS)
    if not requested and not managed:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if coordinator_address is not None:
        kwargs.setdefault("init_method", f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, **kwargs)


def global_column_mesh(axis_name: str = DEFAULT_AXIS, device=None):
    """Column mesh over every rank of the default group (this rank's
    card unless ``device`` says otherwise)."""
    return column_mesh(None, device, axis_name)


def global_pod_mesh(topo=None, device=None):
    """Two-tier ``("dcn", "ici")`` mesh over every rank of the default
    group, and its ``TierAxes``: the hosts are the DCN tier and the ranks
    of one host its ICI domain (``DHQR_TOPO=PdcnxPici`` or ``topo``
    force a shape); on one host it is a ``1xP`` mesh, whose collectives
    are the flat tier's."""
    from dhqr_tpu_torch.parallel.mesh import pod_mesh

    return pod_mesh(topo=topo, device=device)


def global_row_mesh(axis_name: str = ROW_AXIS, device=None):
    """Row mesh over every rank of the default group — the TSQR axis."""
    return row_mesh(None, device, axis_name)


def process_info() -> dict:
    """Topology summary for logs (the reference prints its worker layout
    at startup, runtests.jl:10, 28)."""
    joined = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "local_devices": torch.cuda.device_count(),
        "global_devices": dist.get_world_size() if joined else 1,
        "backend": str(dist.get_backend()) if joined else None,
    }
