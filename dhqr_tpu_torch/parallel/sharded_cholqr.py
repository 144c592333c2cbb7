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
semi-normal sweeps against the true local rows, as TSQR's does.
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
)
from dhqr_tpu_torch.precision import resolve_comms
from dhqr_tpu_torch.utils.config import check_precision


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
    Al, bl = local_rows(A, b, mesh)
    Bl, restore = as_matrix_rhs(bl)

    def dispatch(wire_comms):
        def dense_sum(X):
            return wire.wire_psum(X, mesh, wire_comms, onehot=False,
                                  axis=axis)

        def run():
            Ql, R = _cholqr_passes(
                Al, lambda X: dense_sum(gemm.matmul(X.mH, X, precision)),
                precision, bool(shift))
            C = dense_sum(gemm.matmul(Ql.mH, Bl, precision))
            x = torch.linalg.solve_triangular(R, C, upper=True)
            if wire_comms is None:
                return x
            return csne_sweeps(Al, Bl, x, R, mesh, axis, wire.CSNE_SWEEPS)

        return _pulse.observed_dispatch(
            dispatch_label("cholqr_lstsq", axis, nproc, m, n, wire_comms,
                           ",shift" if shift else ""),
            run, mesh=mesh, n_devices=nproc, wire_format=wire_comms)

    base_label = dispatch_label("cholqr_lstsq", axis, nproc, m, n, None,
                                ",shift" if shift else "")
    comms = _armor.effective_comms(base_label, comms)
    x = _armor.checked_solve(
        base_label, dispatch, A, b, engine="cholqr3" if shift else "cholqr2",
        comms=comms, plan_shape=("lstsq", m, n, A.dtype, nproc))
    return restore(x)
