"""Factorization object + public API — port of ``dhqr_tpu/models/qr_model.py``
(single-device tier).

* :class:`QRFactorization` holds the packed factorization ``(H, alpha)``;
* :func:`qr` factors, :meth:`QRFactorization.solve` / :func:`solve` solve,
  :func:`qr_explicit` returns ``(Q, R)``;
* :func:`lstsq` is the one-shot least-squares solve (minimum-norm for
  m < n), routed by ``engine`` to the blocked Householder engine (through
  the differentiable :func:`~dhqr_tpu_torch.ops.differentiable.lstsq_diff`),
  TSQR, CholeskyQR or the sketched solver.

``mesh=`` (a :class:`~dhqr_tpu_torch.parallel.ColumnMesh`) runs the
distributed tier (:mod:`dhqr_tpu_torch.parallel`): every rank of the mesh
calls the entry point with the same inputs. ``guards=`` routes through
the numeric ladder (:mod:`dhqr_tpu_torch.numeric.ladder`). ``comms=``
names the mesh's wire format; a compressed mesh solve refines through
corrected semi-normal sweeps (:func:`_csne_refine`). Knobs the port does
not run yet (plan) raise :class:`~dhqr_tpu_torch.utils.config.
NotPortedError` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dhqr_tpu_torch.ops import blocked as _blocked
from dhqr_tpu_torch.ops import householder as _hh
from dhqr_tpu_torch.ops import solve as _solve
from dhqr_tpu_torch.ops.cholqr import cholesky_qr_lstsq
from dhqr_tpu_torch.ops.differentiable import lstsq_diff
from dhqr_tpu_torch.ops.tsqr import tsqr_lstsq
from dhqr_tpu_torch.ops import gemm as _gemm
from dhqr_tpu_torch.parallel import sharded_qr as _sharded
from dhqr_tpu_torch.parallel.mesh import DEFAULT_AXIS, ROW_AXIS, check_mesh
from dhqr_tpu_torch.parallel.sharded_cholqr import sharded_cholqr_lstsq
from dhqr_tpu_torch.parallel.sharded_solve import sharded_lstsq, sharded_solve
from dhqr_tpu_torch.parallel.sharded_tsqr import sharded_tsqr_lstsq
from dhqr_tpu_torch.parallel.topology import (
    DCN_AXIS,
    ICI_AXIS,
    axis_size,
    resolve_axis,
)
from dhqr_tpu_torch.parallel.wire import CSNE_MODEL_SWEEPS
from dhqr_tpu_torch.precision import (
    apply_policy_to_factor_args,
    resolve_comms,
    resolve_policy,
)
from dhqr_tpu_torch.solvers.sketch import sketched_lstsq
from dhqr_tpu_torch.utils.config import (
    ENGINES,
    DHQRConfig,
    SketchConfig,
    refuse_unported,
)
from dhqr_tpu_torch.utils.device import as_tensor, check_fp32_matmul

LSTSQ_ENGINES = ENGINES


def _csne_refine(A, R, x, b, steps: int):
    """Corrected semi-normal refinement ``x += (R^H R)^{-1} A^H (b - A x)``,
    the residual and ``A^H r`` in full precision. Its fixed point is the
    least-squares solution whatever rounding R carries (``A^H r* = 0``
    there), so it converges for a factorization whose R carries the wire's
    rounding: the compressed-wire recovery (Björck's CSNE)."""
    vec = x.ndim == 1
    X = x[:, None] if vec else x
    B = b[:, None] if vec else b
    for _ in range(steps):
        resid = B - _gemm.matmul(A, X, "highest")
        G = _gemm.matmul(A.mH, resid, "highest")
        Y = torch.linalg.solve_triangular(R.mH, G, upper=False)
        X = X + torch.linalg.solve_triangular(R, Y, upper=True)
    return X[:, 0] if vec else X


@dataclasses.dataclass
class QRFactorization:
    """Packed Householder QR factorization of A (m x n, m >= n).

    Fields (the JAX package's storage):
      H: (m, n) — reflectors v_j (||v_j||^2 = 2) in rows j:m of column j;
         R's strict upper triangle in rows < j.
      alpha: (n,) — R's diagonal.
      block_size: compact-WY panel width used to apply Q/Q^H in solves.
      precision: matmul precision of the solves' Q/Q^H applies (a policy's
        ``apply`` field when built by ``qr(A, policy=...)``).
      refine: iterative-refinement sweeps :meth:`solve` runs by default.
      matrix: the original A, kept only when refinement was requested at
        factor time (the residual must be measured against the true A).
      mesh: the :class:`~dhqr_tpu_torch.parallel.ColumnMesh` of a
        distributed factorization (``qr(A, mesh=...)``), else None. Then
        ``H`` is this rank's (m + k, (n + k) / P) block, in store order, of
        the factorization of A padded by k orthogonal columns to the
        engines' divisibility (k = 0 when n divides into ``block_size``-wide
        panels over the ranks); ``alpha`` is R's diagonal (n,) on every
        rank; solves run the distributed engines, and :meth:`natural_H`
        all-gathers H in natural column order (every rank must call them).
      layout: the mesh's column layout, "block" or "cyclic".
      comms: the collective wire format of a mesh factorization's solves
        (None: uncompressed); with refinement, a compressed one refines
        through corrected semi-normal sweeps (:func:`_csne_refine`).

    The fields are the JAX package's, in its order.
    """

    H: torch.Tensor
    alpha: torch.Tensor
    block_size: int = _blocked.DEFAULT_BLOCK_SIZE
    mesh: object = None
    precision: str = _hh.DEFAULT_PRECISION
    layout: str = "block"
    refine: int = 0
    matrix: Optional[torch.Tensor] = None
    comms: "str | None" = None

    def _pad(self) -> int:
        """Columns (and rows) a mesh factorization was padded by."""
        return self.H.shape[1] * self.mesh.size - self.alpha.shape[0]

    @property
    def shape(self):
        if self.mesh is None:
            return tuple(self.H.shape)
        return (self.H.shape[0] - self._pad(), self.alpha.shape[0])

    def natural_H(self) -> torch.Tensor:
        """H (m, n) in natural column order: ``H`` itself on one device;
        on a mesh, every rank's block all-gathered (a collective)."""
        if self.mesh is None:
            return self.H
        m, n = self.shape
        H = _sharded._gather_natural(self.H, self.mesh, n + self._pad(),
                                     self.block_size, self.layout)
        return H[:m, :n]

    @property
    def dtype(self):
        return self.H.dtype

    def _rhs(self, b) -> torch.Tensor:
        return as_tensor(b, self.H.device, self.H.dtype)

    def r_matrix(self) -> torch.Tensor:
        """Dense n x n upper-triangular R."""
        return _solve.r_matrix(self.natural_H(), self.alpha)

    def q_columns(self, k: Optional[int] = None) -> torch.Tensor:
        """The first k columns of Q (default n) — a test/debug aid."""
        m, n = self.shape
        eye = torch.eye(m, n if k is None else k, dtype=self.H.dtype,
                        device=self.H.device)
        return self.matmul_q(eye)

    def condition_estimate(self) -> torch.Tensor:
        """Cheap lower bound on cond_2(A): ``max|r_ii| / min|r_ii|``."""
        d = self.alpha.abs()
        return d.max() / d.min()

    def rank(self, rtol: Optional[float] = None) -> torch.Tensor:
        """Numerical rank estimate ``#{i : |r_ii| > rtol * max|r_ii|}``;
        default rtol = max(m, n) * eps of the dtype."""
        d = self.alpha.abs()
        if rtol is None:
            rtol = max(self.H.shape) * torch.finfo(d.dtype).eps
        return torch.sum(d > rtol * d.max())

    def _solve_once(self, b: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            # H is the padded problem's block (``_pad_problem``): b gets its
            # zero rows, alpha the padded columns' unit diagonal (x[:n]
            # does not depend on it: R has no coupling into them)
            k = self._pad()
            alpha = torch.cat([self.alpha, self.alpha.new_ones(k)])
            return sharded_solve(
                self.H, alpha, _sharded._pad_rows(b, k), self.mesh,
                block_size=self.block_size,
                precision=self.precision, layout=self.layout,
                _H_in_store_layout=True,
                comms=self.comms)[:self.alpha.shape[0]]
        c = _blocked._apply_qt_impl(self.H, b, self.block_size, self.precision)
        return _solve._back_substitute(self.H, self.alpha, c)

    def solve(self, b, refine: Optional[int] = None) -> torch.Tensor:
        """Least-squares solve ``x = argmin ||A x - b||``: apply Q^H,
        back-substitute R. ``refine`` sweeps (default: the recorded count)
        of ``x += solve(b - A x)``, residual at full precision, need the
        original ``matrix``; under a compressed ``comms`` the sweeps are
        corrected semi-normal ones with this factorization's R (plain
        refinement stalls at the bias of the perturbed Q^H)."""
        steps = self.refine if refine is None else int(refine)
        b = self._rhs(b)
        x = self._solve_once(b)
        if steps:
            if self.matrix is None:
                raise ValueError(
                    "refinement needs the original matrix: factor with "
                    "qr(A, policy=...) (policy.refine > 0 keeps A on the "
                    "factorization), or pass refine=0")
            if self.comms is not None:
                return _csne_refine(self.matrix, self.r_matrix(), x, b,
                                    steps)
            for _ in range(steps):
                x = x + self._solve_once(b - torch.matmul(self.matrix, x))
        return x

    def matmul_q(self, b) -> torch.Tensor:
        """Q @ b (b of length m, or (m, k)); on a mesh, on every rank
        through the gathered H."""
        return _blocked._apply_q_impl(self.natural_H(), self._rhs(b),
                                      self.block_size, self.precision)

    def matmul_qt(self, b) -> torch.Tensor:
        """Q^H @ b."""
        return _blocked._apply_qt_impl(self.natural_H(), self._rhs(b),
                                       self.block_size, self.precision)


def _reject_nonblocked_knobs(cfg: DHQRConfig) -> None:
    if cfg.use_pallas != "auto":
        raise ValueError(
            "use_pallas applies to the blocked engines only "
            f"(got use_pallas={cfg.use_pallas!r} with blocked=False)")
    if cfg.trailing_precision is not None:
        raise ValueError(
            "trailing_precision applies to the blocked engines only "
            f"(got {cfg.trailing_precision!r} with blocked=False)")
    if cfg.lookahead:
        raise ValueError(
            "lookahead applies to the blocked engines only (the unblocked "
            "panel loop has no panel-level schedule to reorder)")
    if cfg.agg_panels:
        raise ValueError(
            "agg_panels applies to the blocked engines only (the unblocked "
            "panel loop has no panel-level updates to aggregate)")
    if cfg.overlap_depth:
        raise ValueError(
            "overlap_depth applies to the blocked engines only (the "
            "unblocked panel loop has no panel-level schedule to pipeline)")


def _resolve_policy_cfg(cfg: DHQRConfig):
    """Resolve ``cfg.policy`` into the classic precision knobs (shared by
    ``qr`` and ``lstsq``).

    Returns ``(cfg', policy-or-None)``: the returned config carries
    ``precision``/``trailing_precision``/``apply_precision`` from the policy
    and ``policy=None``; ``refine`` rides back on the policy for the caller
    to place (``qr`` records it on the factorization, ``lstsq`` maps it into
    ``cfg.refine``). A policy is mutually exclusive with setting the knobs
    it resolves. ``comms`` is normalized first ("f32"/"none" -> None).
    """
    if cfg.comms is not None:
        cfg = dataclasses.replace(cfg, comms=resolve_comms(cfg.comms))
    if cfg.policy is None:
        return cfg, None
    pol = resolve_policy(cfg.policy)
    precision, trailing = apply_policy_to_factor_args(
        pol, cfg.precision, cfg.trailing_precision,
        default_precision=DHQRConfig.precision)
    if cfg.refine:
        raise ValueError(
            "pass either policy= or refine=, not both "
            f"(policy sets refine={pol.refine})")
    if cfg.apply_precision is not None:
        raise ValueError(
            "pass either policy= or apply_precision=, not both "
            f"(policy resolves apply to {pol.resolved_apply()!r})")
    if cfg.comms is not None:
        raise ValueError(
            "pass either policy= or comms=, not both "
            f"(policy sets the wire format to {pol.comms!r})")
    apply = pol.resolved_apply()
    cfg = dataclasses.replace(
        cfg, precision=precision, trailing_precision=trailing,
        apply_precision=None if apply == pol.panel else apply,
        comms=pol.comms, policy=None)
    return cfg, pol


def _resolved(cfg: DHQRConfig, mesh, device):
    if mesh is not None:
        check_mesh(mesh)
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(
                f"device={device!r} differs from the mesh's device "
                f"{mesh.device}: a mesh call runs on mesh.device")
    cfg, pol = _resolve_policy_cfg(cfg)
    refuse_unported(cfg, mesh)
    return cfg, pol


def _col_axis_size(cfg: DHQRConfig, mesh) -> "tuple[object, int]":
    """The column axis the householder mesh path shards over (on a pod
    mesh, its ``TierAxes``), and its rank count."""
    axis = resolve_axis(mesh, cfg.mesh_axis or DEFAULT_AXIS)
    return axis, axis_size(mesh, axis)


def _qr_mesh(A, cfg: DHQRConfig, mesh):
    """``(H, alpha, nb)`` of the mesh path: A padded once to the panel
    width's divisibility (``_pad_problem``), factored by the sharded
    engine, left in store order on each rank; alpha cut back to n."""
    axis, nproc = _col_axis_size(cfg, mesh)
    n = A.shape[1]
    Ap, _, nb, _ = _sharded._pad_problem(A, nproc, cfg.block_size)
    if cfg.blocked:
        H, alpha = _sharded.sharded_blocked_qr(
            Ap, mesh, block_size=nb, axis_name=axis, precision=cfg.precision,
            layout=cfg.layout, _store_layout_output=True, norm=cfg.norm,
            use_pallas=cfg.use_pallas, panel_impl=cfg.panel_impl,
            trailing_precision=cfg.trailing_precision,
            lookahead=cfg.lookahead, agg_panels=cfg.agg_panels,
            overlap_depth=cfg.overlap_depth, comms=cfg.comms)
    else:
        _reject_nonblocked_knobs(cfg)
        H, alpha = _sharded.sharded_householder_qr(
            Ap, mesh, axis_name=axis, precision=cfg.precision,
            layout=cfg.layout, store_nb=nb, _store_layout_output=True,
            norm=cfg.norm, comms=cfg.comms)
    return H, alpha[:n], nb


def _with_block_size(cfg: DHQRConfig) -> DHQRConfig:
    if cfg.block_size is None:
        cfg = dataclasses.replace(cfg, block_size=_blocked.DEFAULT_BLOCK_SIZE)
    return cfg


def qr(A, config: Optional[DHQRConfig] = None, donate: bool = False,
       mesh=None, device=None, **overrides) -> QRFactorization:
    """Factor A (m x n, m >= n).

    >>> fact = qr(A)                  # blocked compact-WY, panels on the kernel
    >>> fact = qr(A, blocked=False)   # unblocked reference-parity engine
    >>> fact = qr(A, donate=True)     # factors in place in A's storage
    >>> fact = qr(A, policy="balanced")  # bf16x3 trailing GEMMs, refined solves
    >>> fact = qr(A, lookahead=True)  # panel q+1 beside panel q's GEMM
    >>> fact = qr(A, mesh=column_mesh())  # every rank: its column block

    ``policy=`` names the precision tuple at once: panel and trailing
    precision go to the factor engine, ``apply`` becomes the
    factorization's solve precision, and ``refine > 0`` arms refinement in
    every later ``.solve(b)`` (the factorization then keeps A).
    ``device=None`` runs on the CUDA card (inputs are moved there); with
    ``mesh=`` every rank calls ``qr`` with the same A, on ``mesh.device``.
    ``guards=`` ("screen", "fallback", "full") routes through
    :func:`~dhqr_tpu_torch.numeric.ladder.guarded_qr` and returns its
    factorization.
    """
    cfg = dataclasses.replace(config or DHQRConfig(), **overrides)
    if cfg.guards is not None:
        # Numeric guardrails: screening, breakdown detection, policy
        # escalation, typed refusal; guarded_qr has the provenance.
        if donate:
            raise ValueError(
                "donate=True cannot be combined with guards=: escalation "
                "must be able to re-read A, which donation invalidates"
            )
        from dhqr_tpu_torch.numeric.ladder import guarded_qr

        return guarded_qr(A, config=cfg, mesh=mesh,
                          device=device).factorization
    cfg, pol = _resolved(cfg, mesh, device)
    cfg = _with_block_size(cfg)
    if cfg.engine != "householder":
        raise ValueError(
            f"qr() supports only engine='householder' (got {cfg.engine!r}): "
            "the factorization object stores packed reflectors; the "
            "tsqr/cholqr/sketch engines are lstsq-only fast paths")
    if cfg.refine:
        raise ValueError(
            "refine applies to lstsq() only — qr() returns the raw "
            "factorization; use lstsq(A, b, refine=...), or pass a policy= "
            "with refine > 0 (which arms refinement on the solves)")
    solve_refine = pol.refine if pol is not None else 0
    if solve_refine and donate:
        raise ValueError(
            "donate=True cannot be combined with a refining policy: "
            "refinement must keep the original A, which donation "
            "invalidates")
    A = as_tensor(A, device if mesh is None else mesh.device)
    check_fp32_matmul(A.device)
    if mesh is not None:
        if donate:
            raise ValueError(
                "donate=True is not supported on the mesh path (the input is "
                "re-placed onto the mesh, so donation cannot honor its contract)"
            )
        H, alpha, nb = _qr_mesh(A, cfg, mesh)
        return QRFactorization(
            H, alpha, block_size=nb,
            precision=cfg.apply_precision or cfg.precision,
            refine=solve_refine, matrix=A if solve_refine else None,
            mesh=mesh, layout=cfg.layout, comms=cfg.comms)
    if cfg.blocked:
        H, alpha = _blocked.blocked_householder_qr(
            A, cfg.block_size, donate=donate, precision=cfg.precision,
            use_pallas=cfg.use_pallas, norm=cfg.norm,
            panel_impl=cfg.panel_impl,
            trailing_precision=cfg.trailing_precision,
            lookahead=cfg.lookahead, agg_panels=cfg.agg_panels,
            device=A.device)
    else:
        if donate:
            raise ValueError("donate=True is only supported on the blocked path")
        _reject_nonblocked_knobs(cfg)
        H, alpha = _hh.householder_qr(A, precision=cfg.precision,
                                      norm=cfg.norm, device=A.device)
    return QRFactorization(
        H, alpha, block_size=cfg.block_size,
        precision=cfg.apply_precision or cfg.precision, refine=solve_refine,
        matrix=A if solve_refine else None)


def solve(fact: QRFactorization, b) -> torch.Tensor:
    """Functional form of ``fact.solve(b)``."""
    return fact.solve(b)


def qr_explicit(A, config: Optional[DHQRConfig] = None, mesh=None,
                device=None, **overrides):
    """Explicit reduced factors ``(Q, R)`` — the ``torch.linalg.qr`` shape:
    Q (m, n) with orthonormal columns, R (n, n) upper-triangular. The
    packed form (:func:`qr`) is cheaper when only solves are needed."""
    fact = qr(A, config=config, mesh=mesh, device=device, **overrides)
    return fact.q_columns(), fact.r_matrix()


def _minimum_norm_impl(A: torch.Tensor, b: torch.Tensor, block_size: int,
                       precision: str = _hh.DEFAULT_PRECISION,
                       norm: str = "accurate") -> torch.Tensor:
    """Underdetermined (m < n, full row rank): factor A^H = Q R, then
    ``x = Q R^{-H} b`` is the minimum-norm solution of A x = b."""
    m, n = A.shape
    H, alpha = _blocked._blocked_qr_impl(A.mH.clone(), block_size, norm=norm,
                                         precision=precision)
    R = _solve.r_matrix(H, alpha)  # (m, m) upper; A = R^H Q^H
    B = b[:, None] if b.ndim == 1 else b
    Y = torch.linalg.solve_triangular(R.mH, B, upper=False)  # R^H Y = b
    Yp = Y.new_zeros((n,) + tuple(Y.shape[1:]))
    Yp[:m] = Y
    X = _blocked._apply_q_impl(H, Yp, block_size, precision)
    return X[:, 0] if b.ndim == 1 else X


def _validate_alt_engine_cfg(cfg: DHQRConfig) -> None:
    """Option rejections shared by every route into the alt engines (the
    plain path and the refine path)."""
    if cfg.layout != "block":
        raise ValueError(
            f"layout applies only to the householder engines; "
            f"engine={cfg.engine!r} shards rows (layout={cfg.layout!r})")
    if cfg.engine != "tsqr" and cfg.use_pallas != "auto":
        raise ValueError(
            f"use_pallas applies to engines with panel loops (householder, "
            f"tsqr); engine={cfg.engine!r} is all-GEMM "
            f"(use_pallas={cfg.use_pallas!r})")
    if cfg.trailing_precision is not None:
        raise ValueError(
            "trailing_precision applies to the blocked householder engines "
            f"only (engine={cfg.engine!r}; the ops-level entry points "
            "accept a policy= directly — tsqr_lstsq, cholesky_qr_lstsq)")
    if cfg.apply_precision is not None:
        raise ValueError(
            "apply_precision applies to the householder engines only "
            f"(engine={cfg.engine!r})")
    if cfg.lookahead:
        raise ValueError(
            "lookahead applies to the blocked householder engines only "
            f"(engine={cfg.engine!r})")
    if cfg.agg_panels:
        raise ValueError(
            "agg_panels applies to the blocked householder engines only "
            f"(engine={cfg.engine!r})")


def _lstsq_sketch(A, b, cfg: DHQRConfig, mesh=None):
    """Route ``lstsq`` to the sketched engine
    (:func:`~dhqr_tpu_torch.solvers.sketch.sketched_lstsq`): compress to
    an s x n core, R from the core, R-preconditioned CGLS against the true
    A. ``precision`` / ``trailing_precision`` steer the core's Gram
    product; ``refine`` adds CGLS iterations to the
    :class:`~dhqr_tpu_torch.utils.config.SketchConfig` baseline.
    Single-device only."""
    if mesh is not None:
        raise ValueError(
            "engine='sketch' is single-device: the sketch core is "
            "already small — shard the stream, not the sketch"
        )
    if cfg.layout != "block":
        raise ValueError(
            f"layout applies only to the householder engines "
            f"(engine='sketch', layout={cfg.layout!r})")
    if cfg.use_pallas != "auto":
        raise ValueError(
            "use_pallas applies to engines with single-problem panel "
            f"loops (got use_pallas={cfg.use_pallas!r} with "
            "engine='sketch'; the sketch core has no panel loop)")
    if cfg.apply_precision is not None:
        raise ValueError(
            "apply_precision applies to the householder engines only "
            "(engine='sketch')")
    if cfg.panel_impl != "loop":
        raise ValueError(
            "panel_impl applies to the blocked householder engines "
            f"(engine='sketch', panel_impl={cfg.panel_impl!r})")
    if cfg.lookahead or cfg.agg_panels or cfg.overlap_depth:
        raise ValueError(
            "lookahead/agg_panels/overlap_depth apply to the blocked "
            "householder engines only (engine='sketch')")
    if not cfg.blocked:
        raise ValueError(
            "engine='sketch' factors its core with the blocked engine "
            "(got blocked=False)")
    scfg = SketchConfig.from_env()
    return sketched_lstsq(
        A, b, scfg, precision=cfg.precision,
        trailing_precision=cfg.trailing_precision, norm=cfg.norm,
        refine=scfg.refine + cfg.refine, block_size=cfg.block_size,
        device=A.device)


def _lstsq_impl(A, b, cfg: DHQRConfig):
    """The householder engine, m >= n: blocked through ``lstsq_diff``
    (gradients at every ``refine``), or the unblocked engine."""
    if cfg.blocked:
        return lstsq_diff(
            A, b, cfg.block_size, cfg.precision, norm=cfg.norm,
            panel_impl=cfg.panel_impl, refine=cfg.refine,
            trailing_precision=cfg.trailing_precision,
            lookahead=cfg.lookahead, agg_panels=cfg.agg_panels,
            apply_precision=cfg.apply_precision, device=A.device,
            use_pallas=cfg.use_pallas)
    _reject_nonblocked_knobs(cfg)
    H, alpha = _hh.householder_qr(A, precision=cfg.precision, norm=cfg.norm,
                                  device=A.device)
    ap = cfg.apply_precision or cfg.precision

    def qr_solve(rhs):
        return _solve._back_substitute(
            H, alpha, _solve.apply_qt(H, alpha, rhs, precision=ap,
                                      device=A.device))

    x = qr_solve(b)
    for _ in range(cfg.refine):
        x = x + qr_solve(b - torch.matmul(A, x))
    return x


def _lstsq_refined(A, b, cfg: DHQRConfig, mesh=None):
    """``refine`` sweeps of iterative refinement around one factorization:
    the householder engine refines inside ``lstsq_diff``'s forward
    (gradients intact), or on a mesh factors once with :func:`qr` and
    loops the sharded solve; the cholqr engines reuse their explicit
    (Q, R); tsqr refuses (its tree keeps no reusable factorization, so
    each sweep would repeat the whole factorization)."""
    if cfg.engine == "tsqr":
        raise ValueError(
            "refine is not supported with engine='tsqr' (no reusable "
            "factorization in the tree); use householder or cholqr")
    if cfg.engine in ("cholqr2", "cholqr3"):
        _validate_alt_engine_cfg(cfg)
        if mesh is not None:
            raise ValueError(
                "refine with the cholqr engines is single-device only")
        return cholesky_qr_lstsq(A, b, precision=cfg.precision,
                                 shift=cfg.engine == "cholqr3",
                                 refine=cfg.refine, device=A.device)
    if mesh is None:
        return _lstsq_impl(A, b, cfg)
    return _lstsq_mesh(A, b, cfg, mesh)


def _row_axis(cfg: DHQRConfig, mesh):
    """The axis the row engines shard over: ``mesh_axis`` when it is
    given, else the 1-D mesh's one axis; on a pod mesh, both tiers (the
    default row axis resolves to its ``TierAxes``)."""
    if cfg.mesh_axis is not None:
        if cfg.mesh_axis not in mesh.shape:
            raise ValueError(
                f"mesh axes {tuple(mesh.shape)} do not include "
                f"mesh_axis={cfg.mesh_axis!r}")
        return cfg.mesh_axis
    if len(mesh.shape) == 1:
        return next(iter(mesh.shape))
    if tuple(mesh.axis_names) == (DCN_AXIS, ICI_AXIS):
        return ROW_AXIS
    raise ValueError(
        f"ambiguous row axis on mesh axes {tuple(mesh.shape)} for "
        f"engine={cfg.engine!r}: pass mesh_axis= to pick one")


def _lstsq_alt_engine(A, b, cfg: DHQRConfig, mesh=None):
    """Route ``lstsq`` to TSQR ("tsqr", row blocks looped, leaves on the
    panel kernel) or CholeskyQR ("cholqr2"/"cholqr3", all GEMMs). On a
    mesh both shard ROWS (:func:`_row_axis`), with ``comms`` on their
    exchanges."""
    _validate_alt_engine_cfg(cfg)
    if mesh is not None:
        axis = _row_axis(cfg, mesh)
        if cfg.engine == "tsqr":
            return sharded_tsqr_lstsq(
                A, b, mesh, block_size=cfg.block_size, axis_name=axis,
                precision=cfg.precision, use_pallas=cfg.use_pallas,
                comms=cfg.comms)
        return sharded_cholqr_lstsq(A, b, mesh, axis_name=axis,
                                    precision=cfg.precision,
                                    shift=cfg.engine == "cholqr3",
                                    comms=cfg.comms)
    if cfg.engine == "tsqr":
        m, n = A.shape
        n_blocks = max(1, min(8, m // max(n, 1)))
        while n_blocks > 1 and m % n_blocks:
            n_blocks -= 1
        return tsqr_lstsq(A, b, n_blocks=n_blocks, block_size=cfg.block_size,
                          precision=cfg.precision, use_pallas=cfg.use_pallas,
                          device=A.device)
    return cholesky_qr_lstsq(A, b, precision=cfg.precision,
                             shift=cfg.engine == "cholqr3", device=A.device)


def lstsq(A, b, config: Optional[DHQRConfig] = None, mesh=None, device=None,
          **overrides) -> torch.Tensor:
    """One-shot least squares ``x = argmin ||A x - b||``.

    For m >= n, ``engine="householder"`` (default): the blocked
    factorization (panels on the Hopper kernel by default), Q^H b through
    the compact-WY applies, back-substitution, and ``refine`` sweeps with
    the residual in full precision — through
    :func:`~dhqr_tpu_torch.ops.differentiable.lstsq_diff`, so
    ``torch.autograd`` works through it at every ``refine``;
    ``blocked=False`` runs the unblocked engine. ``engine="tsqr"`` /
    ``"cholqr2"`` / ``"cholqr3"`` route to the tall-skinny engines,
    ``engine="sketch"`` to :func:`~dhqr_tpu_torch.solvers.sketch.
    sketched_lstsq` (m > n). For m < n: the minimum-norm solution.

    ``policy=`` names the precision tuple at once: panel/trailing go to the
    factor stage, ``apply`` to the Q^H applies, ``refine`` into the
    refinement loop.

    With ``mesh=`` (every rank calls it with the same A and b, and gets
    the same x) the householder engine runs column-sharded
    (:func:`~dhqr_tpu_torch.parallel.sharded_lstsq`, or the unblocked
    engine chained into :func:`~dhqr_tpu_torch.parallel.sharded_solve`)
    and tsqr / cholqr2 / cholqr3 row-sharded; ``refine`` factors once
    and loops the sharded solve. The mesh path is not differentiable.

    ``comms=`` (mesh only) names the wire format of the mesh's
    collectives; a compressed householder mesh solve refines by at least
    ``wire.CSNE_MODEL_SWEEPS[comms]`` corrected semi-normal sweeps, so it
    holds the 8x criterion (the row engines sweep inside).

    ``guards=`` ("screen", "fallback", "full") routes through
    :func:`~dhqr_tpu_torch.numeric.ladder.guarded_lstsq` (screen, run,
    health check, the engine and policy ladder, typed refusal) and
    returns its ``x``.
    """
    cfg = dataclasses.replace(config or DHQRConfig(), **overrides)
    if cfg.guards is not None:
        from dhqr_tpu_torch.numeric.ladder import guarded_lstsq

        return guarded_lstsq(A, b, config=cfg, mesh=mesh, device=device).x
    cfg, pol = _resolved(cfg, mesh, device)
    if pol is not None and pol.refine:
        cfg = dataclasses.replace(cfg, refine=pol.refine)
    A = as_tensor(A, device if mesh is None else mesh.device)
    b = as_tensor(b, A.device, A.dtype)
    check_fp32_matmul(A.device)
    if cfg.refine < 0:
        raise ValueError(f"refine must be >= 0, got {cfg.refine}")
    m, n = A.shape
    if m < n and (cfg.engine != "householder" or mesh is not None):
        raise ValueError(
            f"m < n (got {tuple(A.shape)}) is supported only on the "
            "single-device householder path (minimum-norm solve)")
    if cfg.engine == "sketch":  # before the block-size default, as in JAX
        return _lstsq_sketch(A, b, cfg, mesh)
    cfg = _with_block_size(cfg)
    if m < n:
        if not cfg.blocked or cfg.use_pallas != "auto" \
                or cfg.trailing_precision is not None or cfg.lookahead \
                or cfg.agg_panels or cfg.apply_precision is not None:
            raise ValueError(
                "m < n supports only the default blocked path "
                f"(got blocked={cfg.blocked}, use_pallas={cfg.use_pallas!r}, "
                f"trailing_precision={cfg.trailing_precision!r}, "
                f"lookahead={cfg.lookahead}, agg_panels={cfg.agg_panels}, "
                f"apply_precision={cfg.apply_precision!r})")
        if cfg.refine:
            raise ValueError(
                "refine is not supported for m < n (the minimum-norm solve "
                "is already exact to working precision)")
        return _minimum_norm_impl(A, b, cfg.block_size, cfg.precision,
                                  norm=cfg.norm)
    if cfg.comms is not None and mesh is not None \
            and cfg.engine == "householder":
        # A compressed wire's factorization carries its rounding: the
        # solve refines by CSNE sweeps, at least the format's floor.
        floor = CSNE_MODEL_SWEEPS.get(cfg.comms, 2)
        if cfg.refine < floor:
            cfg = dataclasses.replace(cfg, refine=floor)
    if cfg.refine:
        return _lstsq_refined(A, b, cfg, mesh)
    if cfg.engine != "householder":
        return _lstsq_alt_engine(A, b, cfg, mesh)
    if mesh is not None:
        return _lstsq_mesh(A, b, cfg, mesh)
    return _lstsq_impl(A, b, cfg)


def _lstsq_mesh(A, b, cfg: DHQRConfig, mesh):
    """The householder engine on a mesh: blocked in one pass through
    :func:`~dhqr_tpu_torch.parallel.sharded_lstsq`; unblocked, or with
    ``refine`` sweeps, one :func:`qr` and its sharded solves (factor and
    solve share one store order)."""
    if cfg.blocked and not cfg.refine:
        return sharded_lstsq(
            A, b, mesh, block_size=cfg.block_size,
            axis_name=_col_axis_size(cfg, mesh)[0], precision=cfg.precision,
            layout=cfg.layout, norm=cfg.norm,
            use_pallas=cfg.use_pallas, panel_impl=cfg.panel_impl,
            trailing_precision=cfg.trailing_precision,
            lookahead=cfg.lookahead, agg_panels=cfg.agg_panels,
            overlap_depth=cfg.overlap_depth,
            apply_precision=cfg.apply_precision, comms=cfg.comms)
    fact = qr(A, config=dataclasses.replace(cfg, refine=0), mesh=mesh)
    x = fact.solve(b)
    if cfg.comms is not None:
        return _csne_refine(A, fact.r_matrix(), x, b, cfg.refine)
    for _ in range(cfg.refine):
        x = x + fact.solve(b - torch.matmul(A, x))
    return x
