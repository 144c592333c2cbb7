"""Row-sharded CholeskyQR2 least squares — port of
``dhqr_tpu/parallel/sharded_cholqr.py`` (its ``comms=None`` branch).

Rows are split over the row mesh; each Gram matrix is a local product plus
ONE sum over the ranks of an n x n block, the Cholesky and triangular work
runs replicated (tiny, and bit-identical on every rank since the summed
Gram is), and the Q updates stay local. Three reductions in all (one per
Gram pass and one for Q^H b; four in the shifted three-pass form), O(n^2)
words each whatever m is.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.cholqr import _cholqr_passes
from dhqr_tpu_torch.ops.householder import DEFAULT_PRECISION
from dhqr_tpu_torch.ops.solve import as_matrix_rhs
from dhqr_tpu_torch.parallel import wire
from dhqr_tpu_torch.parallel.mesh import ROW_AXIS
from dhqr_tpu_torch.parallel.sharded_tsqr import local_rows, prepare_rows
from dhqr_tpu_torch.utils.config import check_precision


def sharded_cholqr_lstsq(A, b, mesh, axis_name=ROW_AXIS,
                         precision: str = DEFAULT_PRECISION,
                         shift: bool = False, comms=None) -> torch.Tensor:
    """Distributed least squares via CholeskyQR2: rows sharded, three
    reductions (four with ``shift=True``, the shifted CholeskyQR3 form).

    Every rank calls it with the same global A and b; m must divide by the
    rank count. Returns x on every rank. Same conditioning window as
    :func:`dhqr_tpu_torch.ops.cholqr.cholesky_qr2` (NaN outside it)."""
    wire.check_comms(comms)
    check_precision(precision)
    A, b, nproc = prepare_rows(A, b, mesh, axis_name)
    m, n = A.shape
    if m < n:
        raise ValueError(f"lstsq requires m >= n, got {tuple(A.shape)}")
    if m % nproc != 0:
        raise ValueError(f"m={m} must be divisible by mesh size {nproc}")
    Al, bl = local_rows(A, b, mesh)

    def gram(X):
        return wire.wire_psum(gemm.matmul(X.mH, X, precision), mesh, comms)

    Ql, R = _cholqr_passes(Al, gram, precision, bool(shift))
    Bl, restore = as_matrix_rhs(bl)
    C = wire.wire_psum(gemm.matmul(Ql.mH, Bl, precision), mesh, comms)
    return restore(torch.linalg.solve_triangular(R, C, upper=True))
