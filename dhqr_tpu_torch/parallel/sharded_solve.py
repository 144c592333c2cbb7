"""Column-sharded least-squares solve — port of
``dhqr_tpu/parallel/sharded_solve.py``.

* Apply Q^H: each nb-wide panel's reflectors are broadcast from their
  owner and applied on every rank to b, which every rank holds whole (the
  analogue of the reference's ``SharedArray(b)``, src:318).
* Back-substitution, right to left over the panels: the owner solves its
  nb x nb diagonal block and forms its columns' update to the earlier
  rows; one broadcast carries both (n / nb collectives in place of the
  reference's n rounds of host RPCs, src:256-282).

Both stages' broadcasts ride the ``comms`` wire format, on the
``axis_name`` (a two-tier axis on a pod mesh) as the factorization's.

**Gradients** (the conventions of :mod:`~dhqr_tpu_torch.parallel.
sharded_qr`): :func:`sharded_solve` differentiates in b and in the
factorization (H, alpha) through :class:`_ShardedSolve`, and
:func:`sharded_lstsq` in A and b through :class:`_ShardedLstsq`, the
closed-form rule of ``ops.differentiable._LstsqDiff`` on sharded pieces:
the forward substitution with R^H (:func:`_forward_sub_shard`), the
application of Q (:func:`_apply_q_shard`, the adjoint of
:func:`_apply_qt_shard`) and :func:`_backsub_shard`, their collectives
uncompressed.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch import armor as _armor
from dhqr_tpu_torch.obs import pulse as _pulse
from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.blocked import (
    apply_block_reflector,
    apply_block_reflector_h,
)
from dhqr_tpu_torch.ops.differentiable import _wy_jvp, _wy_vjp
from dhqr_tpu_torch.ops.householder import DEFAULT_PRECISION
from dhqr_tpu_torch.parallel import wire
from dhqr_tpu_torch.parallel.layout import plan_padding
from dhqr_tpu_torch.parallel.mesh import DEFAULT_AXIS, check_mesh
from dhqr_tpu_torch.parallel.sharded_qr import (
    _chain_refusal,
    _check_divisibility,
    _check_layout,
    _Geometry,
    _local_block_of,
    _local_gidx,
    _pad_problem,
    _pad_rows,
    _panel_owner,
    sharded_blocked_qr,
)
from dhqr_tpu_torch.parallel.topology import (
    axis_label,
    axis_size,
    resolve_axis,
)
from dhqr_tpu_torch.precision import (
    apply_policy_to_comms_arg,
    apply_policy_to_factor_args,
    resolve_comms,
    resolve_policy,
)
from dhqr_tpu_torch.ops.solve import as_matrix_rhs
from dhqr_tpu_torch.utils.config import (
    check_precision,
    records_grad,
    refuse_mesh_grad,
)
from dhqr_tpu_torch.utils.device import as_tensor


def _apply_qt_shard(Hl, B, n, nb, mesh, precision, layout, comms=None,
                    axis=None):
    """B <- Q^H B in place (B (m, k), whole on every rank): per panel, the
    owner's reflectors (rows k:, R's entries zeroed) broadcast and applied
    everywhere."""
    m, nloc = Hl.shape
    for k in range(0, n, nb):
        owner, kl = _panel_owner(k, n, nloc, nb, layout)
        Y = torch.tril(Hl[k:, kl:kl + nb]) if mesh.rank == owner \
            else Hl.new_empty((m - k, nb))
        Y = wire.wire_broadcast(Y, owner, mesh, comms, axis=axis)
        apply_block_reflector_h(Y, B[k:], precision, inplace=True)
    return B


def _backsub_shard(Hl, alpha, C, n, nb, mesh, precision, layout, comms=None,
                   axis=None):
    """Solve R x = C[:n] (R packed in Hl's strict upper triangle and
    alpha); returns x (n, k) on every rank."""
    nloc = Hl.shape[1]
    C = C[:n].clone()
    x = torch.zeros_like(C)
    for k in reversed(range(0, n, nb)):
        owner, kl = _panel_owner(k, n, nloc, nb, layout)
        if mesh.rank == owner:
            Rpp = torch.triu(Hl[k:k + nb, kl:kl + nb], diagonal=1) \
                + torch.diag(alpha[k:k + nb])
            xp = torch.linalg.solve_triangular(Rpp, C[k:k + nb], upper=True)
            delta = gemm.matmul(Hl[:k, kl:kl + nb], xp, precision)
            packed = torch.cat([delta, xp])
        else:
            packed = C.new_empty((k + nb, C.shape[1]))
        packed = wire.wire_broadcast(packed, owner, mesh, comms, axis=axis)
        x[k:k + nb] = packed[k:]
        C[:k] -= packed[:k]
    return x


def _forward_sub_shard(Hl, alpha, C, n, nb, mesh, precision, layout,
                       axis=None):
    """Solve R^H y = C[:n] (R packed in Hl's strict upper triangle and
    alpha); returns y (n, k) on every rank. Panels in order: the owner
    solves its diagonal block against its rows of C less its columns' R
    rows above times y so far, and broadcasts its rows of y
    (uncompressed)."""
    nloc = Hl.shape[1]
    y = C.new_zeros((n, C.shape[1]))
    for k in range(0, n, nb):
        owner, kl = _panel_owner(k, n, nloc, nb, layout)
        if mesh.rank == owner:
            Rpp = torch.triu(Hl[k:k + nb, kl:kl + nb], diagonal=1) \
                + torch.diag(alpha[k:k + nb])
            rhs = C[k:k + nb] - gemm.matmul(Hl[:k, kl:kl + nb].mH, y[:k],
                                            precision)
            yk = torch.linalg.solve_triangular(Rpp.mH, rhs, upper=False)
        else:
            yk = C.new_empty((nb, C.shape[1]))
        y[k:k + nb] = wire.wire_broadcast(yk, owner, mesh, axis=axis)
    return y


def _apply_q_shard(Hl, B, n, nb, mesh, precision, layout, axis=None):
    """B <- Q B in place (B (m, k), whole on every rank), the adjoint of
    :func:`_apply_qt_shard`: panels in reverse order, each owner's
    reflectors broadcast (uncompressed) and applied everywhere."""
    m, nloc = Hl.shape
    for k in reversed(range(0, n, nb)):
        owner, kl = _panel_owner(k, n, nloc, nb, layout)
        Y = torch.tril(Hl[k:, kl:kl + nb]) if mesh.rank == owner \
            else Hl.new_empty((m - k, nb))
        Y = wire.wire_broadcast(Y, owner, mesh, axis=axis)
        apply_block_reflector(Y, B[k:], precision, inplace=True)
    return B


def _solve_core(Hl, alpha, B, n, nb, mesh, precision, layout, comms=None,
                axis=None):
    """``(x, c)``: c = Q^H B (B (m, k), not modified) and x = R^{-1}
    c[:n], on every rank."""
    c = _apply_qt_shard(Hl, B.clone(), n, nb, mesh, precision, layout,
                        comms, axis)
    return _backsub_shard(Hl, alpha, c, n, nb, mesh, precision, layout,
                          comms, axis), c


def _solve_vjp(Hl, alpha, c, X, X_bar, g: _Geometry):
    """``(Hl_bar, alpha_bar, B_bar)`` of x = R^{-1} (Q^H B)[:n]: y =
    R^{-H} x_bar (the forward substitution), R's cotangent -y x^H
    (replicated: this rank keeps its columns' strict upper part, and alpha
    its diagonal), then Q^H's adjoint panel by panel in reverse on
    ``[y; 0]``, each panel's Y-cotangent kept by its owner."""
    n, nb, prec, mesh = g.n, g.nb, g.precision, g.mesh
    m, nloc = Hl.shape
    y = _forward_sub_shard(Hl, alpha, X_bar, n, nb, mesh, prec, g.layout,
                           g.axis)
    R_bar = -gemm.matmul(y, X.mH, prec)
    cols = torch.as_tensor(_local_gidx(mesh.rank, n, nloc, nb, g.layout),
                           device=Hl.device)
    Hl_bar = torch.zeros_like(Hl)
    Hl_bar[:n] = torch.triu(R_bar, diagonal=1).index_select(1, cols)
    alpha_bar = torch.diagonal(R_bar).clone()
    C, O = c.clone(), torch.zeros_like(c)
    O[:n] = y
    for k in reversed(range(0, n, nb)):
        owner, kl = _panel_owner(k, n, nloc, nb, g.layout)
        mine = mesh.rank == owner
        Y = torch.tril(Hl[k:, kl:kl + nb]) if mine \
            else Hl.new_empty((m - k, nb))
        Y = wire.wire_broadcast(Y, owner, mesh, axis=g.axis)
        Y_bar = _wy_vjp(Y, C[k:], O[k:], prec)
        if mine:
            Hl_bar[k:, kl:kl + nb] += torch.tril(Y_bar)
    return Hl_bar, alpha_bar, O


def _solve_jvp(Hl, alpha, B, X, dHl, dalpha, dB, g: _Geometry):
    """The tangent of x = R^{-1} (Q^H B)[:n]: Q^H B's tangent panel by
    panel (the owner broadcasts Y and its tangent, every rank runs
    ``_wy_jvp`` on the replicated B), then ``R^{-1} (dc[:n] - dR x)``
    with dR x summed over the ranks' columns."""
    n, nb, prec, mesh = g.n, g.nb, g.precision, g.mesh
    m, nloc = Hl.shape
    dHl = torch.zeros_like(Hl) if dHl is None else dHl
    S = B.clone()
    dS = torch.zeros_like(B) if dB is None else dB.clone()
    for k in range(0, n, nb):
        owner, kl = _panel_owner(k, n, nloc, nb, g.layout)
        if mesh.rank == owner:
            parts = [torch.tril(Hl[k:, kl:kl + nb]),
                     torch.tril(dHl[k:, kl:kl + nb])]
        else:
            parts = [Hl.new_empty((m - k, nb)), Hl.new_empty((m - k, nb))]
        Y, dY = wire.wire_broadcast(parts, owner, mesh, axis=g.axis)
        _wy_jvp(Y, dY, S[k:], dS[k:], prec)
    gidx = torch.as_tensor(_local_gidx(mesh.rank, n, nloc, nb, g.layout),
                           device=Hl.device)
    upper = torch.arange(n, device=Hl.device)[:, None] < gidx[None, :]
    dRx = wire.wire_psum(gemm.matmul(torch.where(upper, dHl[:n], 0),
                                     X.index_select(0, gidx), prec),
                         mesh, onehot=False, axis=g.axis)
    if dalpha is not None:
        dRx = dRx + dalpha[:, None] * X
    return _backsub_shard(Hl, alpha, dS[:n] - dRx, n, nb, mesh, prec,
                          g.layout, None, g.axis)


class _ShardedSolve(torch.autograd.Function):
    """``(x, c)`` of the solve with this rank's store-order block Hl,
    alpha and B (m, k), by ``run`` (the forward's dispatch, grad off); c =
    Q^H B comes out non-differentiable for the rules. x is replicated, Hl
    sharded, alpha and B replicated (module docstring of
    :mod:`~dhqr_tpu_torch.parallel.sharded_qr`)."""

    @staticmethod
    def forward(Hl, alpha, B, run, geom):
        return run(Hl, alpha, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        Hl, alpha, B, _run, geom = inputs
        x, c = output
        ctx.mark_non_differentiable(c)
        ctx.geom = geom
        ctx.save_for_backward(Hl, alpha, x, c)
        ctx.save_for_forward(Hl, alpha, B, x)

    @staticmethod
    def backward(ctx, x_bar, _c_bar):
        Hl, alpha, x, c = ctx.saved_tensors
        return _solve_vjp(Hl, alpha, c, x, x_bar, ctx.geom) + (None, None)

    @staticmethod
    def jvp(ctx, dHl, dalpha, dB, _run, _geom):
        Hl, alpha, B, x = ctx.saved_tensors
        return _solve_jvp(Hl, alpha, B, x, dHl, dalpha, dB, ctx.geom), None


class _ShardedLstsq(torch.autograd.Function):
    """``(x, Hl, alpha)`` of the padded one-shot solve by ``run`` (the
    forward's dispatch, grad off), with ``_LstsqDiff``'s closed-form rules
    on the sharded factors; the factors come out non-differentiable."""

    @staticmethod
    def forward(A, b, run, geom):
        return run(A, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, b, _run, geom = inputs
        x, Hl, alpha = output
        ctx.mark_non_differentiable(Hl, alpha)
        ctx.geom = geom
        ctx.save_for_backward(A, b, Hl, alpha, x)
        ctx.save_for_forward(A, b, Hl, alpha, x)

    @staticmethod
    def backward(ctx, x_bar, _H_bar, _alpha_bar):
        A, b, Hl, alpha, x = ctx.saved_tensors
        g = ctx.geom
        n, nb, prec = g.n, g.nb, g.precision
        X, _ = as_matrix_rhs(x)
        y = _forward_sub_shard(Hl, alpha, as_matrix_rhs(x_bar)[0], n, nb,
                               g.mesh, prec, g.layout, g.axis)
        O = y.new_zeros((A.shape[0], y.shape[1]))
        O[:n] = y
        b_bar = _apply_q_shard(Hl, O, n, nb, g.mesh, prec, g.layout, g.axis)
        A_bar = None
        if ctx.needs_input_grad[0]:
            r = as_matrix_rhs(b)[0] - gemm.matmul(A, X, prec)
            w = _backsub_shard(Hl, alpha, y, n, nb, g.mesh, prec, g.layout,
                               None, g.axis)
            A_bar = -gemm.matmul(b_bar, X.mH, prec) \
                + gemm.matmul(r, w.mH, prec)
        b_bar = b_bar[:, 0] if b.ndim == 1 else b_bar
        return A_bar, b_bar, None, None

    @staticmethod
    def jvp(ctx, dA, db, _run, _geom):
        A, b, Hl, alpha, x = ctx.saved_tensors
        g = ctx.geom
        n, nb, prec, mesh = g.n, g.nb, g.precision, g.mesh
        X, restore = as_matrix_rhs(x)
        B, _ = as_matrix_rhs(b)
        dB = as_matrix_rhs(torch.zeros_like(b) if db is None else db)[0]
        dA = torch.zeros_like(A) if dA is None else dA
        # dx1 = A+ (db - dA x): Q^H, then R^{-1}
        dx1 = _solve_core(Hl, alpha, dB - gemm.matmul(dA, X, prec), n, nb,
                          mesh, prec, g.layout, None, g.axis)[0]
        # dx2 = (A^H A)^{-1} dA^H r: R^{-H}, then R^{-1}
        Z = gemm.matmul(dA.mH, B - gemm.matmul(A, X, prec), prec)
        W = _forward_sub_shard(Hl, alpha, Z, n, nb, mesh, prec, g.layout,
                               g.axis)
        dx2 = _backsub_shard(Hl, alpha, W, n, nb, mesh, prec, g.layout, None,
                             g.axis)
        return restore(dx1 + dx2), None, None


def _pad_factorization(H, alpha, b, n_pad: int):
    """An n-column factorization extended to n_pad: zero columns (v = 0 is
    the identity reflector) and a unit R diagonal. The padded R has no
    coupling into the leading rows, so x[:n] is exact. Zero rows are
    appended to H and b where the padded width exceeds m."""
    m, n = H.shape[0], alpha.shape[0]
    rows = max(m, n_pad)
    Hp = H.new_zeros((rows, n_pad))
    Hp[:m, :n] = H
    return (Hp, torch.cat([alpha, alpha.new_ones(n_pad - n)]),
            _pad_rows(b, rows - m))


def sharded_solve(H, alpha, b, mesh, block_size: int = 128,
                  axis_name=DEFAULT_AXIS, precision: str = DEFAULT_PRECISION,
                  layout: str = "block", _H_in_store_layout: bool = False,
                  comms=None) -> torch.Tensor:
    """x = argmin ||A x - b|| from the column-sharded packed factorization.

    ``H`` is the global (m, n) H in natural column order, the same on
    every rank, unless ``_H_in_store_layout``: then it is this rank's
    (m, n / P) block in store order (the chaining of
    :func:`sharded_lstsq` and of a mesh factorization's solves). ``b``
    ((m,) or (m, k)) is the same on every rank; so is the returned x.
    ``comms``: the wire format of the solve's broadcasts. When autograd
    follows H, alpha or b, the solve differentiates in each
    (:class:`_ShardedSolve`; H's cotangent is this rank's block's share
    with ``_H_in_store_layout``, else the whole one).
    """
    comms = resolve_comms(comms)
    check_precision(precision)
    check_mesh(mesh)
    _check_layout(layout)
    H = as_tensor(H, mesh.device)
    alpha = as_tensor(alpha, mesh.device, H.dtype)
    b = as_tensor(b, mesh.device, H.dtype)
    axis_name = resolve_axis(mesh, axis_name)
    nproc = axis_size(mesh, axis_name)
    n = alpha.shape[0]
    nb, n_pad = plan_padding(n, nproc, block_size)
    if n_pad != n:  # an awkward n
        if _H_in_store_layout:
            raise _chain_refusal(n, f"nb*P = {nb * nproc}")
        H, alpha, b = _pad_factorization(H, alpha, b, n_pad)
    _check_divisibility(H.shape[0], n_pad, nproc, nb, layout)
    Hl = H if _H_in_store_layout else _local_block_of(H, mesh, n_pad, nb,
                                                      layout)
    m = H.shape[0]
    base_label = (f"sharded_solve[P={axis_label(axis_name, nproc)},"
                  f"{m}x{n_pad},nb={nb},{layout}]")

    def observed(run, wire_comms):
        return _pulse.observed_dispatch(
            base_label[:-1] + (f",w{wire_comms}" if wire_comms else "")
            + "]", run, mesh=mesh, n_devices=nproc, wire_format=wire_comms)

    comms = _armor.effective_comms(base_label, comms)
    B = b[:, None] if b.ndim == 1 else b
    if records_grad(Hl, alpha, B):
        if _armor.active() is not None:
            refuse_mesh_grad("an armed mesh solve", "armor", Hl, alpha, B)
        x, _ = _ShardedSolve.apply(
            Hl, alpha, B, lambda Hl, alpha, B: observed(
                lambda: _solve_core(Hl, alpha, B, n_pad, nb, mesh,
                                    precision, layout, comms, axis_name),
                comms),
            _Geometry(mesh, axis_name, n_pad, nb, layout, precision))
        return x[:n, 0] if b.ndim == 1 else x[:n]

    def dispatch(wire_comms):
        return observed(lambda: _solve_core(
            Hl, alpha, B, n_pad, nb, mesh, precision, layout, wire_comms,
            axis_name)[0], wire_comms)

    if _armor.active() is None or _H_in_store_layout:
        # A store-order link of a chain verifies at the chain's end.
        x = dispatch(comms)
    else:
        # Handed factors, not A: the checkable invariant is finiteness
        # (wire-tag poisoning and injected NaN are caught).
        x = _armor.checked_dispatch(
            base_label, lambda: dispatch(comms),
            lambda x: (_armor.checks.finite_gap(x), None),
            engine="householder", comms=comms,
            degrade=(lambda: dispatch(None)) if comms else None,
            plan_shape=("lstsq", m, n, H.dtype, nproc))
    return x[:n, 0] if b.ndim == 1 else x[:n]


def sharded_lstsq(A, b, mesh, block_size: int = 128, axis_name=DEFAULT_AXIS,
                  precision: str = DEFAULT_PRECISION, layout: str = "block",
                  norm: str = "accurate", use_pallas: str = "auto",
                  panel_impl: str = "loop",
                  trailing_precision: "str | None" = None,
                  lookahead: bool = False, agg_panels: "int | None" = None,
                  overlap_depth: "int | None" = None,
                  apply_precision: "str | None" = None, comms=None,
                  policy=None) -> torch.Tensor:
    """One-shot distributed least squares: factor + solve on the mesh (the
    reference's ``qr!(A) \\ b`` on a DArray, runtests.jl:77-78).

    An awkward n is padded once here (``_pad_problem``), so the
    factorization stays in store order between the two stages.
    ``apply_precision`` (default ``precision``) sets the solve stage's
    matmul precision; ``policy`` sets the precision tuple at once and must
    not refine (the one factor + solve pass would skip it).
    """
    comms = apply_policy_to_comms_arg(policy, comms)
    if policy is not None:
        if apply_precision is not None:
            raise ValueError(
                "pass either policy= or apply_precision=, not both")
        pol = resolve_policy(policy)
        if pol.refine:
            raise ValueError(
                "policy.refine > 0 is not supported by sharded_lstsq "
                "(one factor+solve pass; the refinement would be "
                "silently skipped) — use models.qr_model.lstsq(..., "
                "mesh=, policy=...), which loops the sharded solve, or "
                "a refine=0 policy"
            )
        apply_precision = pol.resolved_apply()
    precision, trailing_precision = apply_policy_to_factor_args(
        policy, precision, trailing_precision,
        default_precision=DEFAULT_PRECISION)
    if apply_precision is None:
        apply_precision = precision
    check_mesh(mesh)
    A = as_tensor(A, mesh.device)
    b = as_tensor(b, mesh.device, A.dtype)
    m, n = A.shape
    axis = resolve_axis(mesh, axis_name)
    nproc = axis_size(mesh, axis)
    A, b, nb, n_pad = _pad_problem(A, nproc, block_size, b)

    def factor_solve(A, b, wire_comms):
        Hl, alpha = sharded_blocked_qr(
            A, mesh, block_size=nb, axis_name=axis_name,
            precision=precision, layout=layout, _store_layout_output=True,
            norm=norm, use_pallas=use_pallas, panel_impl=panel_impl,
            trailing_precision=trailing_precision, lookahead=lookahead,
            agg_panels=agg_panels, overlap_depth=overlap_depth,
            comms=wire_comms)
        return sharded_solve(Hl, alpha, b, mesh, block_size=nb,
                             axis_name=axis_name, precision=apply_precision,
                             layout=layout, _H_in_store_layout=True,
                             comms=wire_comms), Hl, alpha

    # One normal-equations checksum over the whole factor + solve (the
    # chained stages skip their own); a re-dispatch re-runs both. The
    # wire-trip key is the caller's (m, n), the one resolve_plan looks up.
    base_label = (f"sharded_lstsq[P={axis_label(axis, nproc)},"
                  f"{A.shape[0]}x{A.shape[1]},nb={nb},{layout}]")
    comms = _armor.effective_comms(base_label, comms)
    if records_grad(A, b):
        if _armor.active() is not None:
            refuse_mesh_grad("an armed mesh lstsq", "armor", A, b)
        return _ShardedLstsq.apply(
            A, b, lambda A, b: factor_solve(A, b, comms),
            _Geometry(mesh, axis, n_pad, nb, layout, precision))[0][:n]
    return _armor.checked_solve(
        base_label, lambda wire_comms: factor_solve(A, b, wire_comms)[0],
        A, b, engine="householder", comms=comms,
        plan_shape=("lstsq", m, n, A.dtype, nproc))[:n]
