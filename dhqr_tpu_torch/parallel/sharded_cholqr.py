"""Row-sharded CholeskyQR2 least squares — port of
``dhqr_tpu/parallel/sharded_cholqr.py``.

Rows are split over the row mesh; each Gram matrix is a local product plus
ONE sum over the ranks of an n x n block, the Cholesky and triangular work
runs replicated (tiny, and bit-identical on every rank since the summed
Gram is), and the Q updates stay local. Three reductions in all (one per
Gram pass and one for Q^H b; four in the shifted three-pass form), O(n^2)
words each whatever m is.

The reductions are dense sums, so ``comms="int8"`` carries them as bf16
(per-rank scales cannot be added). Under a compressed ``comms`` the solve
runs :data:`~dhqr_tpu_torch.parallel.wire.CSNE_SWEEPS` corrected
semi-normal sweeps against the true local rows, as TSQR's does. Its
gradients are TSQR's (:class:`~dhqr_tpu_torch.parallel.sharded_tsqr.
_RowLstsq`), with R from the last pass.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch import armor as _armor
from dhqr_tpu_torch.obs import pulse as _pulse
from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.cholqr import _cholqr_passes
from dhqr_tpu_torch.ops.householder import DEFAULT_PRECISION
from dhqr_tpu_torch.ops.solve import as_matrix_rhs
from dhqr_tpu_torch.parallel import wire
from dhqr_tpu_torch.parallel.mesh import ROW_AXIS
from dhqr_tpu_torch.parallel.sharded_tsqr import (
    csne_sweeps,
    dispatch_label,
    local_rows,
    prepare_rows,
    row_lstsq_grad,
)
from dhqr_tpu_torch.precision import resolve_comms
from dhqr_tpu_torch.utils.config import check_precision, records_grad


def sharded_cholqr_lstsq(A, b, mesh, axis_name=ROW_AXIS,
                         precision: str = DEFAULT_PRECISION,
                         shift: bool = False, comms=None) -> torch.Tensor:
    """Distributed least squares via CholeskyQR2: rows sharded, three
    reductions (four with ``shift=True``, the shifted CholeskyQR3 form).

    Every rank calls it with the same global A and b; m must divide by the
    rank count. Returns x on every rank. Same conditioning window as
    :func:`dhqr_tpu_torch.ops.cholqr.cholesky_qr2` (NaN outside it).
    ``comms``: the wire format of the reductions (module docstring)."""
    comms = resolve_comms(comms)
    check_precision(precision)
    A, b, axis, nproc = prepare_rows(A, b, mesh, axis_name)
    m, n = A.shape
    if m < n:
        raise ValueError(f"lstsq requires m >= n, got {tuple(A.shape)}")
    if m % nproc != 0:
        raise ValueError(f"m={m} must be divisible by mesh size {nproc}")

    def dense_sum(X, wire_comms):
        return wire.wire_psum(X, mesh, wire_comms, onehot=False, axis=axis)

    def solve(Al, Bl, wire_comms):
        Ql, R = _cholqr_passes(
            Al, lambda X: dense_sum(gemm.matmul(X.mH, X, precision),
                                    wire_comms),
            precision, bool(shift))
        C = dense_sum(gemm.matmul(Ql.mH, Bl, precision), wire_comms)
        x = torch.linalg.solve_triangular(R, C, upper=True)
        if wire_comms is None:
            return x, R
        return csne_sweeps(Al, Bl, x, R, mesh, axis, wire.CSNE_SWEEPS), R

    extra = ",shift" if shift else ""

    def dispatch(wire_comms, A=A, b=b):
        Al, bl = local_rows(A, b, mesh)
        Bl, _ = as_matrix_rhs(bl)
        return _pulse.observed_dispatch(
            dispatch_label("cholqr_lstsq", axis, nproc, m, n, wire_comms,
                           extra),
            lambda: solve(Al, Bl, wire_comms), mesh=mesh, n_devices=nproc,
            wire_format=wire_comms)

    base_label = dispatch_label("cholqr_lstsq", axis, nproc, m, n, None,
                                extra)
    comms = _armor.effective_comms(base_label, comms)
    restore = as_matrix_rhs(b)[1]
    if records_grad(A, b):
        return restore(row_lstsq_grad(A, b, dispatch, mesh, axis, comms,
                                      precision))
    return restore(_armor.checked_solve(
        base_label, lambda wire_comms: dispatch(wire_comms)[0], A, b,
        engine="cholqr3" if shift else "cholqr2", comms=comms,
        plan_shape=("lstsq", m, n, A.dtype, nproc)))
