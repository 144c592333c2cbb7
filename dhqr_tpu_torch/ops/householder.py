"""Unblocked Householder QR — port of ``dhqr_tpu/ops/householder.py``.

Same numerics as the JAX engine:

* sign choice ``alpha = s * alphafactor(a_jj)``;
* reflector scale ``f = 1 / sqrt(s * (s + |a_jj|))``, so every stored
  reflector has ``||v||^2 = 2`` and ``H_j = I - v_j v_j^H`` (no tau);
* the reflector overwrites column j's rows ``j:m``; R's strict upper
  triangle stays in H, R's diagonal lives in ``alpha``.

The JAX engine keeps static shapes under ``jit`` by masking whole columns;
eager PyTorch slices instead: the trailing update of a column step runs on
rows ``j:`` and columns right of it only. The skipped entries are the ones
the JAX engine multiplies by structural zeros, so the results agree. The
column norm keeps the JAX engine's masked full-length compensated tree, so
its summation order is the reference's.

The reconstruct panel engine (:func:`_panel_qr_reconstruct`, with
:func:`_lu_nopivot` and :func:`_explicit_qr_tree`) is the one place the
port calls a library QR, as the JAX engine calls ``jnp.linalg.qr`` there;
only ``panel_impl="reconstruct[:<chunk>]"`` reaches it.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.summation import norm2
from dhqr_tpu_torch.utils.config import (
    DEFAULT_PRECISION,
    check_precision,
    refuse_grad,
)
from dhqr_tpu_torch.utils.device import as_tensor

RECURSIVE_BASE_WIDTH = 32


def alphafactor(x: torch.Tensor) -> torch.Tensor:
    """Sign factor for the Householder diagonal shift.

    Real: ``-sign(x)``; complex: ``-x / |x|``. A zero pivot gives ``-1`` in
    both cases, which keeps the factorization finite.
    """
    if x.is_complex():
        mag = x.abs()
        safe = torch.where(mag == 0, torch.ones_like(mag), mag)
        unit = torch.complex(x.real / safe, x.imag / safe)
        return torch.where(mag == 0, -torch.ones_like(x), -unit)
    return torch.where(x >= 0, -torch.ones_like(x), torch.ones_like(x))


def householder_reflector(col: torch.Tensor, j: int, norm: str = "accurate"):
    """One reflector from the full m-vector column ``col`` (rows < j are R
    entries of earlier steps and are masked out). Returns ``(v, alpha_j)``
    with ``v`` zero in rows < j and ``||v||^2 = 2``. Leading axes of
    ``col`` are a batch: one reflector per row."""
    m = col.shape[-1]
    rows = torch.arange(m, device=col.device)
    colm = torch.where(rows >= j, col, torch.zeros_like(col))
    s = norm2(colm, norm)
    a_jj = col[..., j]
    alpha_j = s.to(col.dtype) * alphafactor(a_jj)
    denom = s * (s + a_jj.abs())
    # f = 1/sqrt(s(s+|a_jj|)); a zero column gives v = 0. Not rsqrt: its
    # error makes each reflector slightly non-unitary.
    f = torch.where(denom > 0,
                    1.0 / torch.sqrt(torch.where(denom > 0, denom,
                                                 torch.ones_like(denom))),
                    torch.zeros_like(denom))
    shifted = colm - alpha_j[..., None] * (rows == j).to(col.dtype)
    return shifted * f.to(col.dtype)[..., None], alpha_j


def _panel_step(jj: int, P: torch.Tensor, alpha: torch.Tensor, offset: int,
                norm: str = "accurate",
                precision: str = DEFAULT_PRECISION) -> None:
    """One column step on panel ``P`` (m, b), or a stack of panels
    (B, m, b), in place: the reflector of local column ``jj`` (diagonal at
    row ``offset + jj``), then the rank-1 update of the columns right of
    it (partial dots at ``precision``)."""
    j = offset + jj
    v, alpha_j = householder_reflector(P[..., jj], j, norm)
    P[..., j:, jj] = v[..., j:]  # rows < j keep R entries
    alpha[..., jj] = alpha_j
    vj = v[..., j:]
    if P.ndim == 2:
        w = gemm.matmul(vj.conj(), P[j:, jj + 1:], precision)  # partial dots
        P[j:, jj + 1:] -= torch.outer(vj, w)
        return
    w = gemm.matmul(vj.conj()[..., None, :], P[..., j:, jj + 1:],
                    precision)[..., 0, :]
    P[..., j:, jj + 1:] -= vj[..., :, None] * w[..., None, :]


def _step_scalars(a: torch.Tensor, alpha: torch.Tensor, v0: torch.Tensor):
    """``(s, t, phi, f, live, eps)`` of the column step that took a column
    with pivot ``a`` to ``alpha e_0`` with the stored reflector's first
    entry ``v0`` (element-wise: one step, or every step of a panel): the
    norm ``s = |alpha|``, the sign factor ``phi = alpha / s``, ``t = -phi
    a`` (real) or ``|a|`` (complex), the scale ``f = 1/sqrt(s (s + t))``,
    the gate ``s (s + t) > 0`` and the sign ``eps`` of ``v = eps f (x -
    alpha e_0)``.

    The loop and the kernel take ``phi = alphafactor(a)``, so ``t = |a|``
    and ``eps = 1``, as :func:`householder_reflector` computes them. The
    reconstruct panels (real only) take the sign of Q's diagonal instead
    and a reflector whose first entry is positive; reading ``phi`` and
    ``eps`` off the stored factors lets one rule serve both."""
    s = alpha.abs()
    if a.is_complex():
        phi, t, eps = alphafactor(a), a.abs(), torch.ones_like(s)
    else:
        phi = torch.where(alpha > 0, 1.0, -1.0).to(a.dtype)
        t = -phi * a
        eps = torch.where(v0 * (a - alpha) < 0, -1.0, 1.0).to(a.dtype)
    denom = s * (s + t)
    live = denom > 0
    f = torch.where(live, 1.0 / torch.sqrt(torch.where(live, denom, 1.0)),
                    0.0)
    return s, t, phi, f, live, eps


def _shifted(x: torch.Tensor, alpha_j: torch.Tensor) -> torch.Tensor:
    """``x - alpha_j e_0``: the reflector before its scale ``f``."""
    u = x.clone()
    u[0] -= alpha_j
    return u


def _safe(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > 0, t, torch.ones_like(t))


def _reflector_jvp(x, dx, alpha_j, v):
    """Tangent of one reflector: ``(dv, dalpha_j)`` from the column ``x``
    (rows from the diagonal down), its tangent ``dx``, the step's
    ``alpha_j`` and stored ``v`` (:func:`_step_scalars`). The gates of
    :func:`householder_reflector` give a zero tangent where they select a
    constant: a zero column (``denom == 0``), a zero pivot's sign factor."""
    a = x[0]
    s, t, phi, f, live, eps = _step_scalars(a, alpha_j, v[0])
    # dhqr: ignore[DHQR002] the norm's tangent Re(x^H dx)/s: the norm is a full-precision sum (ops.summation), never a policy product
    ds = torch.where(s > 0, torch.vdot(x, dx).real / _safe(s), 0.0)
    da = dx[0]
    dalpha = ds * phi
    if x.is_complex():  # t = |a|, phi = -a/|a|
        dt = torch.where(t > 0, (a.conj() * da).real / _safe(t), 0.0)
        dphi = (a * dt / _safe(t) - da) / _safe(t)
        dalpha = dalpha + s * torch.where(t > 0, dphi, 0.0)
    else:  # phi constant
        dt = -phi * da
    ddenom = (2 * s + t) * ds + s * dt
    df = torch.where(live, -0.5 * f ** 3 * ddenom, 0.0)
    du = _shifted(dx, dalpha)
    return eps * (df * _shifted(x, alpha_j) + f * du), dalpha


def _vjp_constants(alpha: torch.Tensor, v0: torch.Tensor):
    """Per column of a factored panel, the scalars of its step's adjoint
    that the stored factors fix, one vector each (so that a column's
    adjoint launches only the kernels its cotangent needs): ``x = mu v +
    alpha e_0`` rebuilds the column (``mu = -conj(v0) alpha``, so the pivot
    is ``a = alpha (1 - |v0|^2)``), then ``eps f``, ``-eps f^3 / 2`` (gated),
    ``2 s + t``, ``1 / s`` (gated), ``phi``, ``s``, and for complex ``s /
    t`` and ``a / t^2`` (gated) and ``sgn(a)``."""
    a = alpha * (1 - v0.abs() ** 2)
    s, t, phi, f, live, eps = _step_scalars(a, alpha, v0)
    consts = [-v0.conj() * alpha, eps * f,
              torch.where(live, -0.5 * f ** 3, 0.0) * eps, 2 * s + t,
              torch.where(s > 0, 1.0 / _safe(s), 0.0), phi, s]
    if a.is_complex():
        consts += [torch.where(t > 0, s / _safe(t), 0.0),
                   torch.where(t > 0, a / _safe(t) ** 2, 0.0), torch.sgn(a)]
    return consts


def _reflector_vjp(x, v_bar, alpha_bar, p, consts):
    """Adjoint of one reflector: the cotangent of the column ``x`` (rows
    from the diagonal down) from those of ``v`` and ``alpha_j``, under the
    real inner product ``Re<u, v>`` (PyTorch's convention for complex
    tensors), with ``p = v^H v_bar`` and the column's
    :func:`_vjp_constants`. Zero where :func:`_reflector_jvp`'s gates are
    closed."""
    mu, ef, c3, c4, inv_s, phi, s = consts[:7]
    c = c3 * (mu.conj() * p).real          # u = x - alpha e_0 = mu v
    alpha_bar = alpha_bar - ef * v_bar[0]
    s_bar = c * c4 + (alpha_bar.conj() * phi).real
    t_bar = c * s
    if x.is_complex():  # phi = -a/|a|, weighted by s; t = |a|
        s_t, a_t2, sgn_a = consts[7:]
        a_bar = -s_t * alpha_bar + (
            t_bar + s * (alpha_bar.conj() * a_t2).real) * sgn_a
    else:  # t = -phi a
        a_bar = -phi * t_bar
    x_bar = torch.addcmul(ef * v_bar, s_bar * inv_s, x)
    x_bar[0] += a_bar
    return x_bar


def _panel_jvp(S, dS, Hp, alpha, precision: str = DEFAULT_PRECISION):
    """Tangent of the column steps of one panel, in order, in place: ``S``
    is the panel's input from its diagonal row down (it ends as the
    factored panel), ``dS`` its tangent (it ends as the factored panel's),
    ``Hp`` and ``alpha`` the factored panel of the forward pass, whose
    reflectors the steps reuse. Returns the tangent of ``alpha``."""
    b = S.shape[1]
    dalpha = torch.zeros_like(alpha)
    for jj in range(b):
        v = Hp[jj:, jj]
        dv, dalpha[jj] = _reflector_jvp(S[jj:, jj], dS[jj:, jj], alpha[jj],
                                        v)
        if jj + 1 < b:
            T, dT = S[jj:, jj + 1:], dS[jj:, jj + 1:]
            w = gemm.matmul(v.conj(), T, precision)
            dw = gemm.matmul(dv.conj(), T, precision) \
                + gemm.matmul(v.conj(), dT, precision)
            dT -= torch.outer(dv, w) + torch.outer(v, dw)
            T -= torch.outer(v, w)
        S[jj:, jj] = v
        dS[jj:, jj] = dv
    return dalpha


def _panel_vjp(S, G, alpha, alpha_bar, precision: str = DEFAULT_PRECISION):
    """Adjoint of the column steps of one panel, in reverse, in place:
    ``S`` is the factored panel from its diagonal row down (it ends as the
    panel's input), ``G`` its cotangent (it ends as the input's).

    Nothing of the forward pass is kept but the factored panel: every
    reflector is an involution (``||v||^2 = 2``), so the columns right of
    step j before it are ``(I - v v^H)`` of those after it, and the column
    itself was ``(I - v v^H) alpha_j e_j``."""
    b = S.shape[1]
    consts = _vjp_constants(alpha, torch.diagonal(S))
    for jj in reversed(range(b)):
        v = S[jj:, jj]  # read before S[jj:, jj] takes the rebuilt column
        v_bar = G[jj:, jj]
        if jj + 1 < b:
            Tn, Gn = S[jj:, jj + 1:], G[jj:, jj + 1:]
            Tn.addr_(v, gemm.matmul(v.conj(), Tn, precision), alpha=-1)
            w = gemm.matmul(v.conj(), Tn, precision)
            g = gemm.matmul(v.conj(), Gn, precision)
            v_bar = v_bar - gemm.matmul(Gn, w.conj(), precision) \
                - gemm.matmul(Tn, g.conj(), precision)
            Gn.addr_(v, g, alpha=-1)
        k = [c[jj] for c in consts]
        x = k[0] * v
        x[0] += alpha[jj]
        # dhqr: ignore[DHQR002] a scalar of the reflector's scale, which the forward computes at full precision, never a policy product
        p = torch.vdot(v, v_bar)
        G[jj:, jj] = _reflector_vjp(x, v_bar, alpha_bar[jj], p, k)
        S[jj:, jj] = x


def _panel_qr_masked(panel: torch.Tensor, offset: int,
                     precision: str = DEFAULT_PRECISION,
                     norm: str = "accurate"):
    """Panel QR with the reflector of local column jj starting at row
    ``offset + jj``; rows above it are preserved. Returns a new
    ``(pf, alpha)``; ``offset=0`` on the whole matrix is the unblocked
    engine. A stack (B, m, b) of panels factors row by row in one loop. A
    panel that requires grad raises."""
    check_precision(precision)
    refuse_grad(panel, "the plain panel loop")
    P = panel.clone()
    alpha = P.new_zeros(P.shape[:-2] + P.shape[-1:])
    for jj in range(P.shape[-1]):
        _panel_step(jj, P, alpha, offset, norm, precision)
    return P, alpha


def _lu_nopivot(M: torch.Tensor, base: int = 32) -> torch.Tensor:
    """Unpivoted LU of a square matrix, packed: tril(P,-1)+I = L, triu(P) = U.

    Recursion (left LU, two triangular solves, Schur update at full
    precision, right LU) keeps the work in GEMMs; the base case is the
    elimination sweep. No pivoting by design: the only caller factors
    ``Q1_top - S`` with ``S = -sign(diag Q1)``, whose diagonal is bounded
    away from zero (Ballard et al., "Reconstructing Householder Vectors
    from TSQR"; LAPACK dorhr_col)."""
    b = M.shape[0]
    if b <= base:
        P = M.clone()
        for j in range(b - 1):
            lcol = P[j + 1:, j] / P[j, j]
            P[j + 1:, j + 1:] -= torch.outer(lcol, P[j, j + 1:])
            P[j + 1:, j] = lcol
        return P
    h = b // 2
    P11 = _lu_nopivot(M[:h, :h], base)
    L11 = torch.tril(P11, -1) + torch.eye(h, dtype=M.dtype, device=M.device)
    U11 = torch.triu(P11)
    U12 = torch.linalg.solve_triangular(L11, M[:h, h:], upper=False,
                                        unitriangular=True)
    L21 = torch.linalg.solve_triangular(U11, M[h:, :h], upper=True,
                                        left=False)
    S22 = M[h:, h:] - gemm.matmul(L21, U12, DEFAULT_PRECISION)
    P22 = _lu_nopivot(S22, base)
    return torch.cat([torch.cat([P11, U12], dim=1),
                      torch.cat([L21, P22], dim=1)])


def _explicit_qr_tree(active: torch.Tensor, chunk: int):
    """Reduced QR of ``active`` (m x b, zero rows allowed) through a
    two-level TSQR tree: a batched ``torch.linalg.qr`` over the row chunks,
    one combine QR of the stacked R factors and one batched GEMM that
    assembles Q. Rows are zero-padded to a chunk multiple; Householder chunk
    QRs keep zero rows zero, so the slice back to m rows stays orthonormal."""
    m, b = active.shape
    chunk = max(chunk, b)
    pad = (-m) % chunk
    Ap = torch.cat([active, active.new_zeros((pad, b))]) if pad else active
    C = Ap.shape[0] // chunk
    Qs, Rs = torch.linalg.qr(Ap.reshape(C, chunk, b), mode="reduced")
    Q2, R = torch.linalg.qr(Rs.reshape(C * b, b), mode="reduced")
    Q1 = gemm.matmul(Qs, Q2.reshape(C, b, b), DEFAULT_PRECISION)
    return Q1.reshape(C * chunk, b)[:m], R


def _panel_qr_reconstruct(panel: torch.Tensor, offset: int,
                          tree_chunk: int = 0):
    """Panel QR by an explicit-Q factorization and Householder
    reconstruction (real dtypes): returns ``(pf, alpha)`` in the packed
    storage of :func:`_panel_qr_masked`.

    The panel's explicit reduced QR (``torch.linalg.qr``, the library QR
    that the JAX engine calls through ``jnp.linalg.qr``; or
    :func:`_explicit_qr_tree` with ``tree_chunk`` rows per chunk) gives Q1,
    R1. With ``S = -sign(diag Q1_top)``, the unpivoted LU ``Q1_top - S =
    L (-W)`` yields unit-triangular directions ``Y = [L; -Q1_bot W^{-1}]``
    and scales ``tau_i = W_ii / s_i``; ``v_i = Y[:, i] sqrt(tau_i)`` has
    ``||v||^2 = 2``, R is ``S R1`` and alpha its diagonal (LAPACK
    dorhr_col). The triangular solves and the LU's Schur GEMM run at full
    precision; there is no ``precision`` knob, as in the JAX engine.

    ``offset`` rolls the panel so its active rows (``offset:``) sit on top,
    zeroes the stale bottom rows and restores the rows above ``offset``
    after rolling back. A panel that requires grad raises."""
    refuse_grad(panel, "the reconstruct panel engine")
    m, b = panel.shape
    live = (torch.arange(m, device=panel.device) < m - offset)[:, None]
    rolled = torch.roll(panel, -offset, 0)
    active = torch.where(live, rolled, 0)
    if tree_chunk:
        Q1, R1 = _explicit_qr_tree(active, tree_chunk)
    else:
        Q1, R1 = torch.linalg.qr(active, mode="reduced")
    s = torch.where(torch.diagonal(Q1[:b]) >= 0, -1.0, 1.0).to(panel.dtype)
    P = _lu_nopivot(Q1[:b] - torch.diag(s))
    L1 = torch.tril(P, -1) + torch.eye(b, dtype=P.dtype, device=P.device)
    W = -torch.triu(P)
    tau = torch.diagonal(W) / s
    Y2 = torch.linalg.solve_triangular(W, -Q1[b:], upper=True, left=False)
    V = torch.cat([L1, Y2]) * torch.sqrt(torch.clamp_min(tau, 0))[None, :]
    Rh = s[:, None] * R1
    top = torch.where(torch.ones(b, b, dtype=torch.bool,
                                 device=panel.device).triu(1), Rh, V[:b])
    merged = torch.where(live, torch.cat([top, V[b:]]), rolled)
    return torch.roll(merged, offset, 0), torch.diagonal(Rh).clone()


def _panel_qr_recursive(panel: torch.Tensor, offset: int,
                        precision: str = DEFAULT_PRECISION,
                        norm: str = "accurate",
                        base: int = RECURSIVE_BASE_WIDTH, leaf=None):
    """Divide-and-conquer panel QR (the LAPACK geqrt3 recursion): left half
    by recursion, its reflectors applied to the right half as one
    compact-WY transform, right half by recursion at row ``offset + h``.

    ``leaf(panel, offset)`` factors a panel of width <= ``base`` (default:
    :func:`_panel_qr_masked`); the blocked engine passes the Hopper panel
    kernel here. A stack (B, m, b) of panels recurses as one.
    """
    b = panel.shape[-1]
    if b <= base:
        if leaf is not None:
            return leaf(panel, offset)
        return _panel_qr_masked(panel, offset, precision=precision, norm=norm)
    from dhqr_tpu_torch.ops.blocked import apply_block_reflector_h, shifted_tril

    h = b // 2
    left_f, alpha_l = _panel_qr_recursive(panel[..., :h], offset, precision,
                                          norm, base, leaf)
    right = apply_block_reflector_h(shifted_tril(left_f, offset),
                                    panel[..., h:], precision)
    right_f, alpha_r = _panel_qr_recursive(right, offset + h, precision, norm,
                                           base, leaf)
    return (torch.cat([left_f, right_f], dim=-1),
            torch.cat([alpha_l, alpha_r], dim=-1))


def householder_qr(A, precision: str = DEFAULT_PRECISION,
                   norm: str = "accurate", device=None):
    """Factor ``A`` (m x n, m >= n): returns ``(H, alpha)`` — reflectors
    (rows j:m of column j, ``||v||^2 = 2``) and R's strict upper triangle in
    ``H``, R's diagonal in ``alpha``. Differentiable in both modes
    (:func:`~dhqr_tpu_torch.ops.differentiable.householder_factor`)."""
    from dhqr_tpu_torch.ops.differentiable import householder_factor

    A = as_tensor(A, device)
    m, n = A.shape
    if m < n:
        raise ValueError(f"householder_qr requires m >= n, got {tuple(A.shape)}")
    return householder_factor(A, unblocked=True, precision=precision,
                              norm=norm)
