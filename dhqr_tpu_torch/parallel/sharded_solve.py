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
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch.obs import pulse as _pulse
from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.blocked import apply_block_reflector_h
from dhqr_tpu_torch.ops.householder import DEFAULT_PRECISION
from dhqr_tpu_torch.parallel import wire
from dhqr_tpu_torch.parallel.layout import plan_padding
from dhqr_tpu_torch.parallel.mesh import DEFAULT_AXIS, check_mesh
from dhqr_tpu_torch.parallel.sharded_qr import (
    _chain_refusal,
    _check_divisibility,
    _check_layout,
    _local_block,
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
from dhqr_tpu_torch.utils.config import check_precision, refuse_grad
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
    ``comms``: the wire format of the solve's broadcasts.
    """
    comms = resolve_comms(comms)
    check_precision(precision)
    check_mesh(mesh)
    _check_layout(layout)
    H = as_tensor(H, mesh.device)
    alpha = as_tensor(alpha, mesh.device, H.dtype)
    b = as_tensor(b, mesh.device, H.dtype)
    refuse_grad(b, "the mesh engines")
    axis_name = resolve_axis(mesh, axis_name)
    nproc = axis_size(mesh, axis_name)
    n = alpha.shape[0]
    nb, n_pad = plan_padding(n, nproc, block_size)
    if n_pad != n:  # an awkward n
        if _H_in_store_layout:
            raise _chain_refusal(n, f"nb*P = {nb * nproc}")
        H, alpha, b = _pad_factorization(H, alpha, b, n_pad)
    _check_divisibility(H.shape[0], n_pad, nproc, nb, layout)
    Hl = H if _H_in_store_layout else _local_block(H, mesh, n_pad, nb,
                                                   layout)
    m = H.shape[0]

    def dispatch():
        B = b[:, None].clone() if b.ndim == 1 else b.clone()
        return _backsub_shard(
            Hl, alpha, _apply_qt_shard(Hl, B, n_pad, nb, mesh, precision,
                                       layout, comms, axis_name),
            n_pad, nb, mesh, precision, layout, comms, axis_name)

    label = (f"sharded_solve[P={axis_label(axis_name, nproc)},{m}x{n_pad},"
             f"nb={nb},{layout}" + (f",w{comms}" if comms else "") + "]")
    x = _pulse.observed_dispatch(label, dispatch, mesh=mesh,
                                 n_devices=nproc, wire_format=comms)
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
    n = A.shape[1]
    nproc = axis_size(mesh, resolve_axis(mesh, axis_name))
    A, b, nb, _ = _pad_problem(A, nproc, block_size, b)
    Hl, alpha = sharded_blocked_qr(
        A, mesh, block_size=nb, axis_name=axis_name, precision=precision,
        layout=layout, _store_layout_output=True, norm=norm,
        use_pallas=use_pallas, panel_impl=panel_impl,
        trailing_precision=trailing_precision, lookahead=lookahead,
        agg_panels=agg_panels, overlap_depth=overlap_depth, comms=comms)
    return sharded_solve(Hl, alpha, b, mesh, block_size=nb,
                         axis_name=axis_name, precision=apply_precision,
                         layout=layout, _H_in_store_layout=True,
                         comms=comms)[:n]
