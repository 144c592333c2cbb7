"""The yardstick's operation and byte counts, and the peaks they are held to.

The flop counts are the LAPACK working-note counts for real dtypes, frozen
here so that the yardstick cannot move with the program: Householder QR
``2mn^2 - (2/3)n^3`` (geqrf), Q^T applied to k columns ``4mnk - 2n^2 k``
(ormqr), back-substitution ``n^2 k`` (trsm). A call's nominal work is the
same whatever implements it.

The byte counts read each input byte once and write each output byte
once, whatever a kernel reads again. Standard library only.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def qr_flops(m: int, n: int) -> float:
    """Householder QR of (m, n), m >= n, factor only (geqrf)."""
    m, n = float(m), float(n)
    return 2.0 * m * n * n - (2.0 / 3.0) * n ** 3


def apply_qt_flops(m: int, n: int, k: int = 1) -> float:
    """Q^T from (m, n) packed reflectors applied to an (m, k) block (ormqr)."""
    m, n, k = float(m), float(n), float(k)
    return 4.0 * m * n * k - 2.0 * n * n * k


def back_substitute_flops(n: int, k: int = 1) -> float:
    """R x = c with the n x n upper-triangular R, k right-hand sides."""
    n, k = float(n), float(k)
    return n * n * k


def solve_flops(m: int, n: int) -> float:
    """One right-hand side against a factorization: Q^T b, then R x = c."""
    return apply_qt_flops(m, n, 1) + back_substitute_flops(n, 1)


def lstsq_flops(m: int, n: int) -> float:
    """One-shot least squares with one right-hand side, no refinement."""
    return qr_flops(m, n) + solve_flops(m, n)


def panel_leaves(m: int, n: int, launches: int) -> "list[tuple[int, int]]":
    """``[(rows, width), ...]`` of a factorization whose panel kernel ran
    ``launches`` times on equal leaves side by side: the leaf at column c
    has m - c rows. Empty when the launches do not split n evenly."""
    if launches < 1 or n % launches:
        return []
    w = n // launches
    return [(m - c, w) for c in range(0, n, w)]


def panel_bytes(rows: int, width: int, item: int) -> float:
    """A panel read once and written once, with its ``width`` diagonal
    entries written."""
    return 2.0 * rows * width * item + width * item


def trailing_bytes(m: int, n: int, leaves, item: int) -> float:
    """The trailing matrix right of each leaf read and written once per
    update, and the leaf's reflectors read once."""
    total = 0.0
    for rows, width in leaves:
        c = m - rows
        right = n - c - width
        if right > 0:
            total += 2.0 * rows * right * item + rows * width * item
    return total


def solve_bytes(m: int, n: int, item: int) -> float:
    """H read once, b read once, x written once."""
    return float(m * n + m + n) * item


def peaks() -> dict:
    """``{"flops_per_s", "bytes_per_s", "source", ...}`` of one card."""
    return json.loads(PEAKS_FILE.read_text())


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(flops / peak["flops_per_s"], nbytes / peak["bytes_per_s"])


def panel_least_seconds(m: int, n: int, launches: int, item: int,
                        peak: dict) -> "float | None":
    """Least time of one factorization's panel-kernel launches, each leaf
    held to its own bound; None where the leaves cannot be told."""
    leaves = panel_leaves(m, n, launches)
    if not leaves:
        return None
    return sum(least_seconds(qr_flops(r, w),
                             panel_bytes(r, w, item), peak)
               for r, w in leaves)


def trailing_least_seconds(m: int, n: int, launches: int, item: int,
                           peak: dict) -> "float | None":
    """Least time of the nominal trailing work: the factorization's count
    less its panels' counts, against the trailing bytes."""
    leaves = panel_leaves(m, n, launches)
    if not leaves:
        return None
    flops = qr_flops(m, n) - sum(qr_flops(r, w) for r, w in leaves)
    return least_seconds(flops, trailing_bytes(m, n, leaves, item), peak)


def solve_least_seconds(m: int, n: int, item: int, peak: dict) -> float:
    return least_seconds(solve_flops(m, n), solve_bytes(m, n, item), peak)
