"""Sketch-and-precondition least squares — port of ``dhqr_tpu/solvers/sketch.py``.

A tall system (m x n, m > n) is compressed first to an ``s x n`` core with
``s = O(n log n)`` rows by one pass over A: a count sketch (each row of A
added, with a sign, into one of s buckets; ``index_add_``) or a
subsampled randomized Hadamard transform (SRHT: sign flips, a fast
Walsh-Hadamard butterfly over the rows padded to a power of two, s rows
kept). The core's R comes from one Gram product and a shifted
``checked_cholesky``; ``refine`` iterations of R-preconditioned CGLS
against the true A then carry the semi-normal answer to the reference's
8x criterion (Rokhlin-Tygert, Blendenpik).

The operators are numpy PCG64 draws seeded with ``[seed, m, s]`` (and a
trailing 4 for the SRHT), copied verbatim from the JAX package, so both
packages draw bit-identical operators for the same seed. Everything runs
on the matrix's device as plain PyTorch: no panel kernel is on this path
(the core has no panel loop), the Gram product goes through
``ops/gemm.py`` at the trailing (else panel) precision, the CGLS matvecs
at full FP32 and the triangular solves through
``torch.linalg.solve_triangular``.

Scope: single device, vector right-hand side, m > n.
``lstsq(A, b, engine="sketch")`` routes here.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from dhqr_tpu_torch.numeric.guards import checked_cholesky
from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.utils.config import SketchConfig, check_precision
from dhqr_tpu_torch.utils.device import as_tensor
from dhqr_tpu_torch.utils.profiling import Counters

#: Calls into :func:`sketched_lstsq` (``sketch_calls``) and operator draws
#: (``sketch_operator_draws``: one per new (operator, m, s, seed, dtype)).
COUNTERS = Counters()

#: Panel width the JAX package gives the core's factorization; the port's
#: Gram core has no panel loop, and the value only rides the signature.
SKETCH_DEFAULT_BLOCK = 32

OPERATORS = ("countsketch", "srht")


def sketch_dim(m: int, n: int, factor: float = 1.0) -> int:
    """Sketch rows ``s = O(n log n)``: ``factor * n * (1 + log2 n)``,
    floored at ``n + 8``, rounded up to a multiple of 8, capped at m."""
    if n < 1 or m < n:
        raise ValueError(
            f"sketching covers tall problems (m >= n >= 1), got ({m}, {n})"
        )
    base = factor * n * (1.0 + math.log2(max(n, 2)))
    s = max(n + 8, int(math.ceil(base)))
    s = -(-s // 8) * 8
    return min(s, m)


def resolve_operator(operator: str, m: int) -> str:
    """``"auto"`` -> "srht" when m is a power of two (the butterfly needs
    no pad rows), "countsketch" otherwise. Explicit names pass through
    validated."""
    if operator == "auto":
        return "srht" if m >= 2 and (m & (m - 1)) == 0 else "countsketch"
    if operator not in OPERATORS:
        raise ValueError(
            f"sketch operator must be one of {OPERATORS} or 'auto', "
            f"got {operator!r}"
        )
    return operator


def count_sketch_operator(m: int, s: int, seed: int):
    """Seeded count-sketch operator for m rows into s buckets:
    ``(rows int32 (m,), signs int8 (m,))``, from numpy's PCG64 seeded with
    ``[seed, m, s]`` (bit-identical in every process)."""
    rng = np.random.default_rng([int(seed), int(m), int(s)])
    rows = rng.integers(0, s, size=m, dtype=np.int32)
    signs = (rng.integers(0, 2, size=m, dtype=np.int8) * 2 - 1).astype(
        np.int8)
    return rows, signs


def srht_operator(m: int, s: int, seed: int):
    """Seeded SRHT operator: ``(signs int8 (p,), idx int32 (s,))`` with p
    the next power of two >= m; ``idx`` samples s of the p Hadamard rows
    without replacement, sorted. The trailing 4 in the seed keeps the draw
    independent of the count sketch's for the same (seed, m, s)."""
    p = 1 << max(0, (int(m) - 1).bit_length())
    rng = np.random.default_rng([int(seed), int(m), int(s), 4])
    signs = (rng.integers(0, 2, size=p, dtype=np.int8) * 2 - 1).astype(
        np.int8)
    idx = np.sort(rng.choice(p, size=s, replace=False)).astype(np.int32)
    return signs, idx


def _fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized fast Walsh-Hadamard transform over axis 0 of a
    (p, ...) tensor, p a power of two: log2(p) butterfly passes, each one
    reshape and one stack of sums and differences."""
    p = x.shape[0]
    h = 1
    while h < p:
        y = x.reshape((p // (2 * h), 2, h) + tuple(x.shape[1:]))
        a, b = y[:, 0], y[:, 1]
        x = torch.stack([a + b, a - b], dim=1).reshape(x.shape)
        h *= 2
    return x


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den``, and 0 where ``den`` is 0: once CGLS reaches the exact
    solution a Krylov scalar is 0, and a zero step keeps the iterate."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def _mhv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M^H v`` at full precision, as ``(v^H M)^H``."""
    return gemm.matmul(v.conj(), M, "highest").conj()


def _vdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.real(torch.vdot(u, v))


def _sketch_solve(A, b, SA, Sb, precision, trailing_precision, refine):
    """The shared core: R from the Gram of the sketch, the semi-normal x0,
    then ``refine`` iterations of R-preconditioned CGLS against the true A.

    ``(SA)^H SA`` runs at ``trailing_precision or precision``; a shift of
    32 eps max(diag) keeps the Cholesky finite where the sketch, not A, is
    rank-deficient (``checked_cholesky`` returns NaN on a breakdown, the
    CholeskyQR breakdown contract). The true-A matvecs run at full
    precision: their accuracy is the point of refining against A."""
    G = gemm.matmul(SA.mH, SA, trailing_precision or precision)
    eps = torch.finfo(G.real.dtype).eps
    lam = 32.0 * eps * torch.max(torch.real(torch.diagonal(G)))
    L = checked_cholesky(G + lam * torch.eye(G.shape[0], dtype=G.dtype,
                                             device=G.device))
    R = L.mH

    def rinv(p):      # R z = p
        return torch.linalg.solve_triangular(R, p[:, None], upper=True)[:, 0]

    def rinv_h(p):    # R^H z = p
        return torch.linalg.solve_triangular(R.mH, p[:, None],
                                             upper=False)[:, 0]

    x = rinv(rinv_h(_mhv(SA, Sb)))  # (R^H R)^{-1} (SA)^H Sb
    if not refine:
        return x
    r = b - gemm.matmul(A, x, "highest")
    g = rinv_h(_mhv(A, r))
    p = g
    gg = _vdot(g, g)
    for _ in range(refine):
        z = rinv(p)
        q = gemm.matmul(A, z, "highest")
        alpha_k = _safe_div(gg, _vdot(q, q))
        x = x + alpha_k * z
        r = r - alpha_k * q
        g = rinv_h(_mhv(A, r))
        gg_next = _vdot(g, g)
        p = g + _safe_div(gg_next, gg) * p
        gg = gg_next
    return x


def _count_sketch(A, b, rows, signs, s):
    """``(S A, S b)`` of the count sketch: each signed row into its bucket
    (the JAX engine's ``segment_sum``)."""
    rows = rows.long()
    SA = A.new_zeros((s, A.shape[1])).index_add_(0, rows, signs[:, None] * A)
    Sb = b.new_zeros(s).index_add_(0, rows, signs * b)
    return SA, Sb


def _srht(A, b, signs, idx):
    """``(S A, S b)`` of the SRHT: pad rows to p, flip signs, butterfly,
    keep the ``idx`` rows, scale by 1/sqrt(s)."""
    m, p = A.shape[0], signs.shape[0]
    Ap = torch.cat([A, A.new_zeros((p - m, A.shape[1]))]) * signs[:, None]
    bp = torch.cat([b, b.new_zeros(p - m)]) * signs
    idx = idx.long()
    scale = 1.0 / math.sqrt(idx.shape[0])
    return _fwht(Ap)[idx] * scale, _fwht(bp)[idx] * scale


# A bounded LRU of drawn operators (host numpy arrays, signs already in the
# matrix's dtype): a warm stream draws nothing, so ``sketch_operator_draws``
# counts new tuples only.
_OPERATOR_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_OPERATOR_CACHE_MAX = 64
_OPERATOR_LOCK = threading.Lock()


def _numpy_dtype(dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _operator_arrays(operator: str, m: int, s: int, seed: int, dtype):
    """Host numpy operator arrays for one (operator, m, s, seed, dtype)
    tuple, the signs cast to the matrix's dtype; memoized per tuple."""
    np_dtype = _numpy_dtype(dtype)
    key = (operator, int(m), int(s), int(seed), np_dtype.name)
    with _OPERATOR_LOCK:
        hit = _OPERATOR_CACHE.get(key)
        if hit is not None:
            _OPERATOR_CACHE.move_to_end(key)
            return hit
    COUNTERS.bump("sketch_operator_draws")
    if operator == "countsketch":
        rows, signs = count_sketch_operator(m, s, seed)
        entry = (rows, np.asarray(signs, dtype=np_dtype))
    else:
        signs, idx = srht_operator(m, s, seed)
        entry = (np.asarray(signs, dtype=np_dtype), idx)
    with _OPERATOR_LOCK:
        _OPERATOR_CACHE[key] = entry
        _OPERATOR_CACHE.move_to_end(key)
        while len(_OPERATOR_CACHE) > _OPERATOR_CACHE_MAX:
            _OPERATOR_CACHE.popitem(last=False)
    return entry


def sketched_lstsq(
    A,
    b,
    config: Optional[SketchConfig] = None,
    *,
    policy=None,
    precision: str = "highest",
    trailing_precision: "str | None" = None,
    norm: str = "accurate",
    refine: "int | None" = None,
    s: "int | None" = None,
    operator: "str | None" = None,
    seed: "int | None" = None,
    block_size: "int | None" = None,
    device=None,
):
    """Randomized sketched least squares ``x ~ argmin ||A x - b||``.

    ``config`` (default: ``SketchConfig.from_env()``) carries the sketch
    knobs; the keyword arguments override it per call. ``s`` defaults to
    :func:`sketch_dim`'s ``O(n log n)`` rule. ``policy=`` sets the Gram
    product's precision (its panel precision, or its trailing split) and
    adds its ``refine`` to the sketch's baseline iterations; it excludes
    explicit ``precision`` / ``trailing_precision`` / ``refine``.
    ``norm`` and ``block_size`` ride the signature, as in the JAX package
    (the core has no panel loop). ``device=None`` runs on the CUDA card.

    Returns x (n,). Accuracy is not certified here: the caller holds the
    answer to its criterion.
    """
    del norm
    scfg = config or SketchConfig.from_env()
    if policy is not None:
        from dhqr_tpu_torch.precision import resolve_policy

        if (precision != "highest" or trailing_precision is not None
                or refine is not None):
            raise ValueError(
                "pass either policy= or explicit "
                "precision/trailing_precision/refine, not both"
            )
        pol = resolve_policy(policy)
        precision = pol.panel
        trailing_precision = pol.split_trailing()
        refine = scfg.refine + pol.refine
    for name in (precision, trailing_precision):
        if name is not None:
            check_precision(name)
    A = as_tensor(A, device)
    b = as_tensor(b, A.device, A.dtype)
    if A.ndim != 2 or A.shape[0] <= A.shape[1] or A.shape[1] < 1:
        raise ValueError(
            f"sketched_lstsq needs a genuinely tall problem "
            f"(m > n >= 1 — there is nothing to compress at m == n), "
            f"got shape {tuple(A.shape)}"
        )
    if tuple(b.shape) != (A.shape[0],):
        raise ValueError(
            f"b must be a length-m vector matching A (A is "
            f"{tuple(A.shape)}, b has shape {tuple(b.shape)}); block "
            "right-hand sides are not sketched yet"
        )
    m, n = A.shape
    s = sketch_dim(m, n, factor=scfg.factor) if s is None else int(s)
    if not n < s <= m:
        raise ValueError(
            f"sketch size s must satisfy n < s <= m, got s={s} for "
            f"shape ({m}, {n})"
        )
    seed = scfg.seed if seed is None else int(seed)
    op = resolve_operator(operator or scfg.operator, m)
    refine = scfg.refine if refine is None else int(refine)
    if refine < 0:
        raise ValueError(f"refine must be >= 0, got {refine}")
    del block_size
    COUNTERS.bump("sketch_calls")
    a0, a1 = _operator_arrays(op, m, s, seed, A.dtype)
    a0 = torch.from_numpy(a0).to(A.device)
    a1 = torch.from_numpy(a1).to(A.device)
    if op == "countsketch":
        SA, Sb = _count_sketch(A, b, a0, a1, s)
    else:
        SA, Sb = _srht(A, b, a0, a1)
    return _sketch_solve(A, b, SA, Sb, precision, trailing_precision, refine)


__all__ = [
    "COUNTERS",
    "OPERATORS",
    "SKETCH_DEFAULT_BLOCK",
    "count_sketch_operator",
    "resolve_operator",
    "sketch_dim",
    "sketched_lstsq",
    "srht_operator",
]
