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

**Gradients** (the conventions of :mod:`~dhqr_tpu_torch.parallel.
sharded_qr`): both row engines differentiate in A and b through
:class:`_RowLstsq`, the closed-form rule of ``ops.differentiable.
_LstsqDiff`` with R and x replicated after the combine: ``w = (A^H A)^{-1}
x_bar`` by R's two triangular solves (and, under a compressed ``comms``,
the forward's count of CSNE sweeps against the true rows, so the gradient
carries no more of the wire's rounding than x does), then each rank's rows
``b_bar_l = A_l w`` and ``A_bar_l = -b_bar_l x^H + r_l w^H``, all-gathered
in one collective.
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
    check_precision,
    records_grad,
    refuse_mesh_grad,
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
    axis = resolve_axis(mesh, axis_name)
    return A, b, axis, axis_size(mesh, axis)


def csne_sweeps(Al, Bl, X, R, mesh, axis, steps: int, rhs=None):
    """``steps`` corrected semi-normal sweeps ``X += (R^H R)^{-1} A^H (B -
    A X)`` on the row mesh (``Al``, ``Bl``: this rank's rows): the residual
    in full precision on the local rows, ``A^H r`` summed over the ranks
    on the uncompressed wire (quantizing it would cap the sweep at the
    wire's rounding it exists to remove). ``rhs`` (replicated) is added to
    the sum: with ``Bl = 0`` the sweeps solve ``A^H A X = rhs``."""
    for _ in range(steps):
        r = Bl - gemm.matmul(Al, X, "highest")
        g = wire.wire_psum(gemm.matmul(Al.mH, r, "highest"), mesh, None,
                           onehot=False, axis=axis)
        if rhs is not None:
            g = g + rhs
        y = torch.linalg.solve_triangular(R.mH, g, upper=False)
        X = X + torch.linalg.solve_triangular(R, y, upper=True)
    return X


def _normal_solve(Al, R, G, g):
    """Z with ``A^H A Z = G`` (G replicated): R's two triangular solves,
    then the forward's CSNE sweeps (``g = (mesh, axis, sweeps,
    precision)``) against the true rows."""
    mesh, axis, sweeps, _ = g
    Z = torch.linalg.solve_triangular(
        R, torch.linalg.solve_triangular(R.mH, G, upper=False), upper=True)
    if not sweeps:
        return Z
    return csne_sweeps(Al, Al.new_zeros((Al.shape[0], G.shape[1])), Z, R,
                       mesh, axis, sweeps, rhs=G)


def _gather_rows(Xl, mesh) -> torch.Tensor:
    """Every rank's rows, all-gathered in rank order: the adjoint of
    :func:`local_rows` (a relayout, exact)."""
    return wire.wire_all_gather(Xl, mesh, dim=0, relayout=True)


class _RowLstsq(torch.autograd.Function):
    """``(x, R)`` of a row engine by ``run`` (the forward's dispatch, grad
    off; x as an (n, k) matrix), R non-differentiable, with
    ``_LstsqDiff``'s closed-form rules on the row mesh (module docstring).
    ``geom`` is ``(mesh, axis, sweeps, precision)``."""

    @staticmethod
    def forward(A, b, run, geom):
        return run(A, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, b, _run, geom = inputs
        x, R = output
        ctx.mark_non_differentiable(R)
        ctx.geom = geom
        ctx.save_for_backward(A, b, x, R)
        ctx.save_for_forward(A, b, x, R)

    @staticmethod
    def backward(ctx, x_bar, _R_bar):
        A, b, x, R = ctx.saved_tensors
        mesh, _, _, prec = g = ctx.geom
        Al, bl = local_rows(A, b, mesh)
        w = _normal_solve(Al, R, x_bar, g)
        b_bar = gemm.matmul(Al, w, prec)
        parts = [b_bar]
        if ctx.needs_input_grad[0]:
            r = as_matrix_rhs(bl)[0] - gemm.matmul(Al, x, prec)
            parts.insert(0, -gemm.matmul(b_bar, x.mH, prec)
                         + gemm.matmul(r, w.mH, prec))
        rows = _gather_rows(torch.cat(parts, 1), mesh)
        b_bar = rows[:, -x.shape[1]:]
        A_bar = rows[:, :A.shape[1]] if len(parts) == 2 else None
        return A_bar, b_bar[:, 0] if b.ndim == 1 else b_bar, None, None

    @staticmethod
    def jvp(ctx, dA, db, _run, _geom):
        A, b, x, R = ctx.saved_tensors
        mesh, axis, _, prec = g = ctx.geom
        Al, bl = local_rows(A, b, mesh)
        Bl = as_matrix_rhs(bl)[0]
        dAl, dbl = local_rows(torch.zeros_like(A) if dA is None else dA,
                              torch.zeros_like(b) if db is None else db, mesh)
        # A^H (db - dA x) + dA^H r, summed over the ranks' rows
        G = gemm.matmul(Al.mH, as_matrix_rhs(dbl)[0]
                        - gemm.matmul(dAl, x, prec), prec) \
            + gemm.matmul(dAl.mH, Bl - gemm.matmul(Al, x, prec), prec)
        G = wire.wire_psum(G, mesh, onehot=False, axis=axis)
        return _normal_solve(Al, R, G, g), None


def row_lstsq_grad(A, b, dispatch, mesh, axis, comms, precision):
    """x (an (n, k) matrix) of a row engine when autograd follows A or b:
    the engine's ``dispatch(comms, A, b) -> (x, R)`` inside
    :class:`_RowLstsq`, with the forward's count of CSNE sweeps; refused
    while the armor seam is armed (``jax.grad`` fails there)."""
    if _armor.active() is not None:
        refuse_mesh_grad("an armed row-mesh lstsq", "armor", A, b)
    sweeps = wire.CSNE_SWEEPS if comms else 0
    return _RowLstsq.apply(A, b, lambda A, b: dispatch(comms, A, b),
                           (mesh, axis, sweeps, precision))[0]


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

    def solve(Al, Bl, wire_comms):
        R, c = _leaf_factor(Al.clone(), Bl, nb, precision, kernel)
        Rstack = wire.wire_all_gather(R, mesh, wire_comms, axis=axis)
        cstack = wire.wire_all_gather(c, mesh, wire_comms, axis=axis)
        H2, alpha2, c2 = _combine_factor(Rstack, cstack, nb, precision,
                                         kernel)
        x, R = _back_substitute(H2, alpha2, c2), r_matrix(H2, alpha2)
        if wire_comms is None:
            return x, R
        return csne_sweeps(Al, Bl, x, R, mesh, axis, wire.CSNE_SWEEPS), R

    def dispatch(wire_comms, A=A, b=b):
        Al, bl = local_rows(A, b, mesh)
        Bl, _ = as_matrix_rhs(bl)
        return _pulse.observed_dispatch(
            dispatch_label("tsqr_lstsq", axis, nproc, m, n, wire_comms,
                           f",nb={nb}"),
            lambda: solve(Al, Bl, wire_comms), mesh=mesh, n_devices=nproc,
            wire_format=wire_comms)

    base_label = dispatch_label("tsqr_lstsq", axis, nproc, m, n, None,
                                f",nb={nb}")
    comms = _armor.effective_comms(base_label, comms)
    restore = as_matrix_rhs(b)[1]
    if records_grad(A, b):
        return restore(row_lstsq_grad(A, b, dispatch, mesh, axis, comms,
                                      precision))
    return restore(_armor.checked_solve(
        base_label, lambda wire_comms: dispatch(wire_comms)[0], A, b,
        engine="tsqr", comms=comms,
        plan_shape=("lstsq", m, n, A.dtype, nproc)))
