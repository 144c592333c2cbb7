"""Row-sharded TSQR least squares — port of
``dhqr_tpu/parallel/sharded_tsqr.py``.

Rows are split over a 1-D row mesh: each rank factors its own row block
(no communication; on the card every leaf panel launches the Hopper panel
kernel), then the (P n x n) stack of R heads and the stack of Q^H b heads
are all-gathered — the one exchange of the whole solve — and the combine
QR runs replicated on every rank. This relaxes the reference's
rows-never-partitioned invariant (src:33): its column layout cannot scale
a 65536 x 256 problem, a row layout can.

Under a compressed ``comms`` the gathered heads carry the wire's
rounding, so the combine keeps its R and the solve runs
:data:`~dhqr_tpu_torch.parallel.wire.CSNE_SWEEPS` corrected semi-normal
sweeps ``x += (R^H R)^{-1} A^H (b - A x)`` against the true local rows,
the (n, nrhs) correction summed on the uncompressed wire.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch import armor as _armor
from dhqr_tpu_torch.obs import pulse as _pulse
from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.blocked import _resolve_kernel
from dhqr_tpu_torch.ops.householder import DEFAULT_PRECISION
from dhqr_tpu_torch.ops.solve import _back_substitute, as_matrix_rhs, r_matrix
from dhqr_tpu_torch.ops.tsqr import _combine_factor, _leaf_factor
from dhqr_tpu_torch.parallel import wire
from dhqr_tpu_torch.parallel.mesh import ROW_AXIS, check_mesh, row_mesh
from dhqr_tpu_torch.parallel.topology import (
    axis_label,
    axis_size,
    resolve_axis,
)
from dhqr_tpu_torch.precision import resolve_comms
from dhqr_tpu_torch.utils.config import (
    GRAD_MESH_ITEM,
    check_precision,
    refuse_grad,
)
from dhqr_tpu_torch.utils.device import as_tensor, check_fp32_matmul


def local_rows(A: torch.Tensor, b: torch.Tensor, mesh):
    """This rank's contiguous row block of A and b (views)."""
    rows = A.shape[0] // mesh.size
    sl = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    return A[sl], b[sl]


def prepare_rows(A, b, mesh, axis_name):
    """(A, b on the mesh's device, resolved axis, rank count), with the
    checks every rank makes before any collective."""
    check_mesh(mesh)
    A = as_tensor(A, mesh.device)
    b = as_tensor(b, A.device, A.dtype)
    check_fp32_matmul(A.device)
    refuse_grad(A, "the mesh engines", GRAD_MESH_ITEM, None)
    refuse_grad(b, "the mesh engines", GRAD_MESH_ITEM, None)
    axis = resolve_axis(mesh, axis_name)
    return A, b, axis, axis_size(mesh, axis)


def csne_sweeps(Al, Bl, X, R, mesh, axis, steps: int):
    """``steps`` corrected semi-normal sweeps ``X += (R^H R)^{-1} A^H (B -
    A X)`` on the row mesh (``Al``, ``Bl``: this rank's rows): the residual
    in full precision on the local rows, ``A^H r`` summed over the ranks
    on the uncompressed wire (quantizing it would cap the sweep at the
    wire's rounding it exists to remove)."""
    for _ in range(steps):
        r = Bl - gemm.matmul(Al, X, "highest")
        g = wire.wire_psum(gemm.matmul(Al.mH, r, "highest"), mesh, None,
                           onehot=False, axis=axis)
        y = torch.linalg.solve_triangular(R.mH, g, upper=False)
        X = X + torch.linalg.solve_triangular(R, y, upper=True)
    return X


def dispatch_label(name, axis, nproc, m, n, comms, extra="") -> str:
    """The pulse label of a row-engine dispatch (the JAX package's)."""
    return (f"{name}[P={axis_label(axis, nproc)},{m}x{n}{extra}"
            + (f",w{comms}" if comms else "") + "]")


def sharded_tsqr_lstsq(A, b, mesh, block_size: int = 128, axis_name=ROW_AXIS,
                       precision: str = DEFAULT_PRECISION,
                       use_pallas: str = "auto", comms=None) -> torch.Tensor:
    """Distributed tall-skinny least squares: rows sharded, one all-gather.

    Every rank calls it with the same global A and b; m must divide by the
    rank count with each local block still tall (m / P >= n). Returns x on
    every rank. ``use_pallas`` routes the leaf and combine panels through
    the Hopper panel kernel, resolved against the local leaf height
    m / P on ``mesh.device``. ``comms`` compresses the heads' gather
    (module docstring)."""
    comms = resolve_comms(comms)
    check_precision(precision)
    A, b, axis, nproc = prepare_rows(A, b, mesh, axis_name)
    m, n = A.shape
    if m % nproc != 0:
        raise ValueError(f"m={m} must be divisible by mesh size {nproc}")
    if m // nproc < n:
        raise ValueError(
            f"local row blocks must stay tall: m/P = {m // nproc} < n = {n}"
        )
    nb = min(int(block_size), n)
    kernel = _resolve_kernel(use_pallas, m // nproc, A.dtype, mesh.device)
    Al, bl = local_rows(A, b, mesh)
    Bl, restore = as_matrix_rhs(bl)

    def dispatch(wire_comms):
        def run():
            R, c = _leaf_factor(Al.clone(), Bl, nb, precision, kernel)
            Rstack = wire.wire_all_gather(R, mesh, wire_comms, axis=axis)
            cstack = wire.wire_all_gather(c, mesh, wire_comms, axis=axis)
            H2, alpha2, c2 = _combine_factor(Rstack, cstack, nb, precision,
                                             kernel)
            x = _back_substitute(H2, alpha2, c2)
            if wire_comms is None:
                return x
            return csne_sweeps(Al, Bl, x, r_matrix(H2, alpha2), mesh, axis,
                               wire.CSNE_SWEEPS)

        return _pulse.observed_dispatch(
            dispatch_label("tsqr_lstsq", axis, nproc, m, n, wire_comms,
                           f",nb={nb}"),
            run, mesh=mesh, n_devices=nproc, wire_format=wire_comms)

    base_label = dispatch_label("tsqr_lstsq", axis, nproc, m, n, None,
                                f",nb={nb}")
    comms = _armor.effective_comms(base_label, comms)
    x = _armor.checked_solve(base_label, dispatch, A, b, engine="tsqr",
                             comms=comms,
                             plan_shape=("lstsq", m, n, A.dtype, nproc))
    return restore(x)
