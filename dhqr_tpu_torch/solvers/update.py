"""Updatable QR — a live factorization for streaming regression; port of
``dhqr_tpu/solvers/update.py``.

Users whose data changes between requests (online regression, sliding
windows) would otherwise re-factor from scratch on every rank-1 change of
A. :class:`UpdatableQR` keeps one factorization live instead:

* state is ``(A, G, R)`` — the data matrix, its Gram matrix ``G = A^H A``,
  and R, the upper-triangular Cholesky factor of G (the R of QR(A) up to
  row signs: the same diagonal magnitudes, so the R-diagonal condition
  bound applies unchanged);
* :meth:`~UpdatableQR.update` / :meth:`~UpdatableQR.downdate` apply
  ``A <- A ± u v^H``: G exactly (one ``A^H u`` product, 2mn), and R by an
  O(n^2) pair of rotation sweeps, one Givens append and one hyperbolic
  removal (LINPACK's ``chud`` / ``chdd``);
* :meth:`~UpdatableQR.solve` answers ``argmin ||A x - b||`` through the
  corrected semi-normal equations (``x = (R^H R)^{-1} A^H b`` plus
  refinement sweeps against the true A — Björck's CSNE).

The Gram route squares the conditioning, so the refactor POLICY carries
the accuracy: after ``refactor_after`` accumulated steps, when the
R-diagonal condition bound leaves the CholeskyQR window, or when a sweep
comes back non-finite (the hyperbolic sweep's breakdown is loud), the
factor is rebuilt from the live A through the guarded ladder
(:func:`dhqr_tpu_torch.numeric.ladder.guarded_qr`: the blocked QR with its
panels on the Hopper kernel). A refactor that refuses typed rolls the
rank-1 data change back: the live factorization never diverges from its
data.

The sweeps are a plain Python loop over the n rows of R, each step a few
row-vectorised tensor ops, with masks that keep the structural zeros
exactly zero (the JAX package runs the same steps as a ``lax.scan``,
outside any kernel). On the card that is 2n sequential steps of small
launches per update: launch-bound by design until it gets a kernel of its
own (ROADMAP).

The ``numeric.breakdown`` fault site fires inside every update/downdate
(as if the sweep had come back non-finite), so each refactor path replays
without crafting a matrix for it. The scheduler's ``"update"`` request
kind (``serve/scheduler.py``) drives a session op by op, in submission
order; each op runs through :func:`update_program` / :func:`solve_program`.
"""

from __future__ import annotations

import math

import torch

from dhqr_tpu_torch.faults import harness as _faults
from dhqr_tpu_torch.numeric import guards as _guards
from dhqr_tpu_torch.numeric.errors import NonFiniteInput
from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.utils.device import as_tensor
from dhqr_tpu_torch.utils.profiling import Counters

#: Process-wide updatable-QR accounting: ``update_steps`` /
#: ``downdate_steps`` / ``update_solves`` / ``update_refactors`` (every
#: ladder rebuild, whatever triggered it) / ``update_breakdowns``
#: (non-finite or injected sweeps) / ``update_screen_rejects``.
COUNTERS = Counters()

#: Updates absorbed before a scheduled refactor (the threshold half of the
#: policy; the condition-bound trip is the other half).
DEFAULT_REFACTOR_AFTER = 32


def _masks(n: int, device):
    """Row k of the first: columns >= k; of the second: columns > k."""
    cols = torch.arange(n, device=device)
    upper = cols[None, :] >= cols[:, None]
    return upper, upper & (cols[None, :] != cols[:, None])


def _givens_append(R: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Re-triangularize ``[R; z^H]``: upper R' with ``R'^H R' = R^H R +
    z z^H`` by n Givens rotations (the ``chud`` sweep, O(n^2)). Row k of R
    and the carried z-row rotate in the (k, n+1) plane; the entries left
    of k are structural zeros in both, and the masks keep them exactly
    zero. A zero pair (rho = 0) leaves both rows as they are."""
    n = R.shape[0]
    ge, gt = _masks(n, R.device)
    y = z.conj()
    rows = []
    for k in range(n):
        rk = R[k]
        a, b = rk[k], y[k]
        rho = torch.sqrt(torch.abs(a) ** 2 + torch.abs(b) ** 2)
        safe = rho > 0
        rho_s = torch.where(safe, rho, torch.ones_like(rho))
        rk_new = (a.conj() * rk + b.conj() * y) / rho_s
        y_new = (-b * rk + a * y) / rho_s
        rows.append(torch.where(safe & ge[k], rk_new,
                                torch.where(safe, 0, rk)))
        y = torch.where(safe & gt[k], y_new, torch.where(safe, 0, y))
    return torch.stack(rows)


def _hyperbolic_remove(R: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Downdate twin of :func:`_givens_append`: upper R' with ``R'^H R' =
    R^H R - z z^H`` by n hyperbolic rotations (the ``chdd`` sweep). The
    breakdown is loud: when the downdated Gram stops being positive
    definite, ``|a|^2 - |b|^2`` goes non-positive, the square root (or
    0 / 0) makes a NaN, and the NaN reaches every later row."""
    n = R.shape[0]
    ge, gt = _masks(n, R.device)
    y = z.conj()
    rows = []
    for k in range(n):
        rk = R[k]
        a, b = rk[k], y[k]
        rho = torch.sqrt(torch.abs(a) ** 2 - torch.abs(b) ** 2)
        rk_new = (a.conj() * rk - b.conj() * y) / rho
        y_new = (-b * rk + a * y) / rho
        rows.append(torch.where(ge[k], rk_new, 0))
        y = torch.where(gt[k], y_new, 0)
    return torch.stack(rows)


def _mhv(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``A^H u`` as the vector-matrix product ``(u^H A)^H``, full
    precision."""
    return gemm.matmul(u.conj(), A, "highest").conj()


def _update_state_impl(A, G, R, u, v, sgn: float):
    """One rank-1 step: ``A' = A + sgn u v^H``, G updated exactly, R
    refreshed by the sweep pair.

    The Gram change is ``dG = sgn (w v^H + v w^H) + (u^H u) v v^H`` with
    ``w = A^H u``; with ``p = w + sgn (u^H u / 2) v`` it is ``sgn (p v^H +
    v p^H) = sgn/2 [(p+v)(p+v)^H - (p-v)(p-v)^H]``, so an update appends
    ``(p+v)/sqrt(2)`` and removes ``(p-v)/sqrt(2)`` (the roles swap for a
    downdate). The balanced split ``beta = sqrt(||p|| / ||v||)`` (``p v^H +
    v p^H = (p/beta)(beta v)^H + (beta v)(p/beta)^H`` for any beta) keeps
    the two vectors of equal norm, so the sweeps' error scales with
    ``||dG||`` rather than with ``||p||``. R drifts from chol(G) only by
    the sweeps' own rounding, which the refactor policy bounds."""
    w = _mhv(A, u)
    # dhqr: ignore[DHQR002] a vector dot has no reduced-precision path: this is the JAX twin's vdot at "highest"
    uu = torch.vdot(u, u).real
    vh = v.conj()
    A2 = torch.addr(A, u, vh, alpha=sgn)
    cross = torch.outer(w, vh)
    G2 = G + sgn * (cross + cross.mH) + uu * torch.outer(v, vh)
    p = w + (sgn * 0.5 * uu).to(A.dtype) * v
    pn = torch.linalg.vector_norm(p)
    vn = torch.linalg.vector_norm(v)
    ok = (pn > 0) & (vn > 0)
    beta = torch.sqrt(torch.where(
        ok, pn / torch.where(vn > 0, vn, torch.ones_like(vn)),
        torch.ones_like(pn))).to(A.dtype)
    pb, vb = p / beta, v * beta
    inv_sqrt2 = 0.7071067811865476
    z_plus = (pb + vb) * inv_sqrt2
    z_minus = (pb - vb) * inv_sqrt2
    z_add, z_sub = (z_plus, z_minus) if sgn > 0 else (z_minus, z_plus)
    R2 = _hyperbolic_remove(_givens_append(R, z_add), z_sub)
    return A2, G2, R2


def _usolve_impl(A, R, b, refine: int = 1, precision: str = "highest"):
    """Corrected semi-normal equations: ``x0 = (R^H R)^{-1} A^H b``, then
    ``refine`` sweeps ``x += (R^H R)^{-1} A^H (b - A x)`` with the residual
    at full precision (CSNE's stability hinges on it). ``A^H b`` runs at
    the caller's ``precision``."""

    def sns(g):
        y = torch.linalg.solve_triangular(R.mH, g[:, None], upper=False)
        return torch.linalg.solve_triangular(R, y, upper=True)[:, 0]

    x = sns(gemm.matmul(b.conj()[None, :], A, precision)[0].conj())
    for _ in range(refine):
        x = x + sns(_mhv(A, b - gemm.matmul(A, x, "highest")))
    return x


def update_program():
    """The rank-1 state update as a plain callable ``(A, G, R, u, v, sgn)
    -> (A', G', R')`` — no state object, as in the JAX package; every
    :meth:`UpdatableQR.update` / :meth:`~UpdatableQR.downdate` runs it."""
    return lambda A, G, R, u, v, sgn: _update_state_impl(A, G, R, u, v, sgn)


def solve_program(refine: int = 1, precision: str = "highest"):
    """The CSNE solve as a plain callable ``(A, R, b) -> x``; every
    :meth:`UpdatableQR.solve` runs it."""
    return lambda A, R, b: _usolve_impl(A, R, b, refine=refine,
                                        precision=precision)


class UpdatableQR:
    """A live, rank-1-updatable QR factorization of a tall matrix.

    >>> fact = UpdatableQR(A)                  # guarded fresh factor
    >>> fact.update(u, v)                      # A <- A + u v^H
    >>> x = fact.solve(b)                      # CSNE within the 8x gate
    >>> fact.downdate(u, v)                    # A <- A - u v^H

    Construction and every refactor run the guarded ladder (``guards=``,
    default "fallback"): a matrix no engine can answer refuses TYPED (the
    :class:`~dhqr_tpu_torch.numeric.NumericalError` family).
    ``refactor_after`` / ``cond_window`` are the refactor policy: a rebuild
    fires after that many accumulated steps, when the R-diagonal condition
    lower bound exceeds the window (default: the CholeskyQR window
    ``~1/sqrt(eps)``), or when a sweep comes back non-finite.
    :attr:`last_refactor` records the trigger and the ladder path.
    ``device=None`` runs on the card, as every entry point of the port.
    """

    def __init__(self, A, *, block_size: "int | None" = None,
                 precision: str = "highest", refine: int = 1,
                 refactor_after: int = DEFAULT_REFACTOR_AFTER,
                 cond_window: "float | None" = None,
                 guards: str = "fallback", device=None):
        A = as_tensor(A, device)
        if A.ndim != 2 or A.shape[0] < A.shape[1] or A.shape[1] < 1:
            raise ValueError(
                f"UpdatableQR factors tall problems (m >= n >= 1), got "
                f"shape {tuple(A.shape)}"
            )
        if refactor_after < 1:
            raise ValueError(
                f"refactor_after must be >= 1, got {refactor_after}")
        if refine < 0:
            raise ValueError(f"refine must be >= 0, got {refine}")
        bad_A, _, _ = _guards.screen_input(A, device=A.device)
        if bad_A:
            COUNTERS.bump("update_screen_rejects")
            raise NonFiniteInput(
                "UpdatableQR input carries non-finite entries; clean the "
                "stream before factoring", engine="update")
        # a zero column refuses typed inside the ladder
        self._A = A
        self._precision = precision
        self._block_size = block_size
        self._refine = int(refine)
        self._refactor_after = int(refactor_after)
        self._guards = guards
        if cond_window is None:
            from dhqr_tpu_torch.ops.cholqr import cholqr_max_cond

            cond_window = cholqr_max_cond(A.dtype)
        self._cond_window = float(cond_window)
        self._k = 0
        self.refactor_count = 0
        self.last_refactor: "dict | None" = None
        self._refactor("initial")

    # ------------------------------------------------------------ state
    @property
    def shape(self):
        return tuple(self._A.shape)

    @property
    def dtype(self):
        return self._A.dtype

    @property
    def device(self):
        return self._A.device

    @property
    def matrix(self) -> torch.Tensor:
        """The live data matrix A (replaced, never written in place, by
        each step)."""
        return self._A

    @property
    def updates_since_refactor(self) -> int:
        return self._k

    def r_matrix(self) -> torch.Tensor:
        """The current n x n upper-triangular R (the sweeps' R after
        updates; the guarded QR's R right after a refactor)."""
        return self._R

    def cond_estimate(self) -> float:
        """Cheap LOWER bound on cond_2(A) from the current R diagonal (the
        rule the refactor policy trips on)."""
        return _guards.diag_condition_bound(torch.diagonal(self._R))

    # -------------------------------------------------------- refactor
    def _refactor(self, reason: str) -> None:
        """Rebuild (G, R) from the live A through the guarded ladder.
        Typed refusals propagate; the ladder already classified them."""
        from dhqr_tpu_torch.numeric.ladder import guarded_qr

        res = guarded_qr(self._A, guards=self._guards,
                         precision=self._precision,
                         block_size=self._block_size, device=self.device)
        R = res.factorization.r_matrix()
        self._G = gemm.matmul(R.mH, R, "highest")
        self._R = R
        self._k = 0
        self.refactor_count += 1
        COUNTERS.bump("update_refactors")
        self.last_refactor = {
            "reason": reason,
            "engine": res.engine,
            "escalations": res.escalations,
            "attempts": [a.outcome for a in res.attempts],
            "trace_id": res.trace_id,
        }

    # ------------------------------------------------------- rank-1 ops
    def _screen_vectors(self, u, v):
        u = as_tensor(u, self.device, self.dtype)
        v = as_tensor(v, self.device, self.dtype)
        m, n = self._A.shape
        if tuple(u.shape) != (m,) or tuple(v.shape) != (n,):
            raise ValueError(
                f"rank-1 vectors must be u (m,) = ({m},) and v (n,) = "
                f"({n},), got {tuple(u.shape)} and {tuple(v.shape)}"
            )
        if _guards.any_nonfinite(u, v):
            COUNTERS.bump("update_screen_rejects")
            raise NonFiniteInput(
                "rank-1 update vectors carry non-finite entries; no "
                "factorization survives a poisoned update — drop it",
                engine="update")
        return u, v

    def _rank1(self, u, v, sgn: float, op: str) -> dict:
        u, v = self._screen_vectors(u, v)
        COUNTERS.bump(f"{op}_steps")
        injected = False
        try:
            _faults.fire("numeric.breakdown")
        except _faults.FaultInjected:
            injected = True
        A2, G2, R2 = update_program()(self._A, self._G, self._R, u, v, sgn)
        broken = injected or _guards.any_nonfinite(R2)
        cond = math.inf if broken else _guards.diag_condition_bound(
            torch.diagonal(R2))
        reason = None
        if broken:
            reason = "injected_breakdown" if injected else "breakdown"
            COUNTERS.bump("update_breakdowns")
        elif cond > self._cond_window:
            reason = "condition"
        elif self._k + 1 >= self._refactor_after:
            reason = "threshold"
        if reason is None:
            self._A, self._G, self._R = A2, G2, R2
            self._k += 1
        else:
            # Commit the data change, then rebuild the factor through the
            # guarded ladder; a typed refusal rolls the data back.
            old_A = self._A
            self._A = A2
            try:
                self._refactor(reason)
            except Exception:
                self._A = old_A
                raise
            cond = self.cond_estimate()
        return {
            "op": op,
            "refactored": reason is not None,
            "reason": reason,
            "cond_estimate": float(cond),
            "updates_since_refactor": self._k,
        }

    def update(self, u, v) -> dict:
        """``A <- A + u v^H``; returns the step's provenance dict
        (``refactored`` / ``reason`` / ``cond_estimate`` / ...)."""
        return self._rank1(u, v, 1.0, "update")

    def downdate(self, u, v) -> dict:
        """``A <- A - u v^H`` (the inverse of :meth:`update` with the same
        vectors: the round trip restores the factorization to working
        precision)."""
        return self._rank1(u, v, -1.0, "downdate")

    # ------------------------------------------------------------ solve
    def solve(self, b, refine: "int | None" = None) -> torch.Tensor:
        """Least squares against the LIVE A, through the guard screen (a
        non-finite b refuses typed before any compute): CSNE with
        ``refine`` sweeps (default: the constructor's)."""
        b = as_tensor(b, self.device, self.dtype)
        if tuple(b.shape) != (self._A.shape[0],):
            raise ValueError(
                f"b must be a length-m vector (m = {self._A.shape[0]}), "
                f"got shape {tuple(b.shape)}"
            )
        if _guards.any_nonfinite(b):
            COUNTERS.bump("update_screen_rejects")
            raise NonFiniteInput(
                "right-hand side carries non-finite entries",
                engine="update")
        COUNTERS.bump("update_solves")
        steps = self._refine if refine is None else int(refine)
        return solve_program(steps, self._precision)(self._A, self._R, b)


__all__ = [
    "COUNTERS",
    "DEFAULT_REFACTOR_AFTER",
    "UpdatableQR",
    "solve_program",
    "update_program",
]
