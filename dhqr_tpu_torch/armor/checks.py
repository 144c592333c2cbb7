"""ABFT checksum invariants — O(mn) post-hoc verification; port of
``dhqr_tpu/armor/checks.py``.

Algorithm-based fault tolerance for QR, factor-side: a weighted checksum
row ``u^H A`` of the input must equal the same weighted row pushed through
the factors, ``(Q^H u)^H R`` — and ``Q^H u`` is one reflector sweep over a
VECTOR (``ops.blocked._apply_qt_impl``), O(mn), not a re-factorization.
For solves the invariant is the normal-equations identity
``A^H (b - A x) ~ 0``, two matvecs. Honest results sit at the
backward-error level (~f32 eps; ~wire eps under a compressed format), a
corrupted panel broadcast, a dropped shard contribution or a flipped
compressed payload at O(1): ``ArmorConfig.rtol`` splits the two.

Every check is a few torch reductions on the factors' device, reading the
FACTORS the dispatch produced — never the engine internals — so it
composes over every sharded engine. The factor check localizes: the gap
is a per-column vector, and the worst column's owner under the engine's
layout is the implicated shard. Row-sharded solve residuals do not
localize; their errors carry ``shard_index=None``.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch.ops import gemm

#: Additive floor inside relative denominators.
_TINY = 1e-30


def _weights(m: int, dtype, device=None) -> torch.Tensor:
    """The checksum weights, a ``1 + i/m`` ramp computed in float32 and
    cast (the JAX package's values): uniform weights are blind to two
    equal and opposite hits; the ramp breaks the symmetry while keeping
    every weight O(1)."""
    ramp = 1.0 + torch.arange(m, dtype=torch.float32, device=device) / m
    return ramp.to(dtype)


def _qr_gap_impl(H, alpha, A, block_size: int, precision: str = "highest"):
    """Per-column relative checksum gap of a packed factorization and its
    worst column: ``u^H A`` against ``(Q^H u)[:n]^H R``."""
    from dhqr_tpu_torch.ops import blocked as _blocked

    m, n = A.shape
    u = _weights(m, A.dtype, A.device)
    s_in = gemm.matmul(u.conj(), A, "highest")                    # (n,)
    c = _blocked._apply_qt_impl(H, u, block_size, precision)
    R = torch.triu(H[:n, :n], 1) + torch.diag(alpha[:n])
    s_fact = gemm.matmul(c[:n].conj(), R, "highest")              # (n,)
    unorm = torch.linalg.vector_norm(u)
    colnorm = torch.sqrt(torch.sum(A.abs() ** 2, dim=0))
    gap = (s_in - s_fact).abs() / (unorm * colnorm + _TINY)
    # NaN anywhere in the factors is a detection too (the wire tags poison
    # NaN-loud): those columns' gap is +inf, never an invisible NaN.
    finite = torch.isfinite(torch.sum(H, dim=0)) \
        & torch.isfinite(alpha[:n])
    gap = torch.where(finite & torch.isfinite(gap), gap,
                      torch.full_like(gap, float("inf")))
    return gap, torch.argmax(gap)


def _lstsq_gap_impl(A, b, x):
    """Scalar normal-equations checksum gap of a solve:
    ``||A^H (b - A x)|| / (||A||_F (||A||_F ||x|| + ||b||))``."""
    B = b if b.ndim == 2 else b[:, None]
    X = x if x.ndim == 2 else x[:, None]
    r = B - gemm.matmul(A, X, "highest")
    g = gemm.matmul(A.mH, r, "highest")
    anorm = torch.linalg.vector_norm(A)
    gap = torch.linalg.vector_norm(g) / (
        anorm * (anorm * torch.linalg.vector_norm(X)
                 + torch.linalg.vector_norm(B)) + _TINY)
    return gap if bool(torch.isfinite(gap)) else torch.tensor(float("inf"))


def qr_gap(H, alpha, A, block_size: int,
           precision: str = "highest") -> "tuple[float, int]":
    """The factor checksum gap and the worst column (the localization the
    engines map to a shard index)."""
    gap, worst = _qr_gap_impl(H, alpha, A, int(block_size), precision)
    return float(torch.max(gap)), int(worst)


def lstsq_gap(A, b, x) -> float:
    """The solve checksum gap (scalar; no localization)."""
    return float(_lstsq_gap_impl(A, b, x))


def finite_gap(*arrays) -> float:
    """Degenerate invariant for surfaces with no checkable identity (a
    standalone ``sharded_solve`` is handed factors, not A): 0.0 when every
    output entry is finite, +inf otherwise."""
    from dhqr_tpu_torch.numeric import guards as _guards

    return float("inf") if _guards.any_nonfinite(*arrays) else 0.0
