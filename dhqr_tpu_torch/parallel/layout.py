"""Column layouts and local-block bookkeeping — the port's own copy of
``dhqr_tpu/parallel/layout.py`` (numpy only; the port imports nothing of
the JAX package, so it carries these functions itself, and
``tests/test_torch_layout.py`` holds the copy equal to the original).

``local_column_block`` gives, per rank, the global column offset and width
of its local block — what the reference's ``LocalColumnBlock`` carries as
``Δj``/``colrange`` (reference src/DistributedHouseholderQR.jl:26-36).
The sharded engines hold even blocks; ``cyclic_store_columns`` makes a
contiguous split block-cyclic (load balance), and ``plan_padding`` pads an
awkward n to the engines' divisibility. ``area_balanced_splits`` is the
reference's uneven split (test/runtests.jl:36-38), kept as a documented
oracle.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ColumnBlock:
    """A device's contiguous block of global columns [start, stop).

    ``start`` plays the role of the reference's ``Δj`` column offset and
    ``range(start, stop)`` its ``colrange`` (src:26-36).
    """

    start: int
    stop: int

    @property
    def width(self) -> int:
        return self.stop - self.start

    def contains(self, j: int) -> bool:
        return self.start <= j < self.stop


def local_column_block(n: int, n_devices: int, device_index: int) -> ColumnBlock:
    """Even column-block layout: the block rank ``device_index`` holds.

    The sharded engines' placement on a column mesh for n divisible
    by n_devices (the supported case, mirroring the reference's even-block
    ``DArray`` constructor at runtests.jl:71).
    """
    if n % n_devices != 0:
        raise ValueError(
            f"n={n} must divide evenly over {n_devices} devices; pad the matrix"
        )
    w = n // n_devices
    return ColumnBlock(device_index * w, (device_index + 1) * w)


def fit_block_size(nloc: int, requested: int) -> int:
    """Largest panel width <= requested that divides the local block width.

    Keeps the single-owner-per-panel invariant of the sharded compact-WY
    engine without making users hand-tune nb against n/mesh combinations.
    """
    nb = max(1, min(int(requested), nloc))
    while nloc % nb:
        nb -= 1
    return nb


def plan_padding(n: int, n_devices: int, requested_nb: int) -> tuple[int, int]:
    """Pick ``(nb, n_pad)`` so arbitrary n fits the sharded-engine invariants.

    The sharded engines need ``n_pad % (nb * P) == 0`` (every panel has a
    single owner and devices hold equal blocks — see ``_check_divisibility``).
    The reference instead handles awkward n with *uneven* worker blocks
    (``columnblocks``, src:18-19; sqrt-split, test/runtests.jl:36-38); the
    sharded engines hold even blocks, so the answer here is to pad
    (VERDICT r2 next-round #3) — this planner keeps the padding minimal.

    Scans panel widths from ``min(requested_nb, ceil(n/P))`` downward and
    returns the width with the smallest padded n; ties break toward wider
    panels (better MXU utilization), and the scan stops early once the
    padding reaches the theoretical minimum ``ceil(n/P)*P - n``.
    """
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    nloc0 = -(-n // n_devices)  # ceil: local width after minimal padding
    minimal = nloc0 * n_devices
    best_nb = best_pad = None
    for nb in range(min(max(int(requested_nb), 1), nloc0), 0, -1):
        step = nb * n_devices
        n_pad = -(-n // step) * step
        if best_pad is None or n_pad < best_pad:
            best_nb, best_pad = nb, n_pad
        if n_pad == minimal:
            break
    return best_nb, best_pad


def column_block_ranges(n: int, n_devices: int) -> list[ColumnBlock]:
    """All devices' blocks — the reference's ``columnblocks`` table (src:18-19)."""
    return [local_column_block(n, n_devices, p) for p in range(n_devices)]


def cyclic_store_columns(n: int, n_devices: int, nb: int) -> np.ndarray:
    """Column order that makes contiguous sharding a block-cyclic layout.

    ``A[:, cyclic_store_columns(n, P, nb)]`` sharded in contiguous blocks of
    ``n // P`` columns gives device p the global column blocks
    ``{kb : kb % P == p}`` of width nb — the load-balanced layout SURVEY.md
    §2 prescribes in place of the reference's uneven sqrt-split blocks
    (test/runtests.jl:36-38): in the right-looking panel sweep every device
    keeps owning live panels until the end, instead of the leading blocks'
    owners going idle.

    Entry ``store[pos]`` is the global (natural) column stored at contiguous
    position ``pos``. Requires ``n % (nb * P) == 0``.
    """
    if n % (nb * n_devices) != 0:
        raise ValueError(
            f"cyclic layout needs n divisible by nb*P = {nb * n_devices}, got n={n}"
        )
    j = np.arange(n)
    blk = j // nb
    device = blk % n_devices
    local = (blk // n_devices) * nb + j % nb
    pos = device * (n // n_devices) + local
    store = np.empty(n, dtype=np.int64)
    store[pos] = j
    return store


def natural_store_positions(n: int, n_devices: int, nb: int) -> np.ndarray:
    """Inverse of :func:`cyclic_store_columns`: position of natural column j."""
    store = cyclic_store_columns(n, n_devices, nb)
    pos = np.empty(n, dtype=np.int64)
    pos[store] = np.arange(n)
    return pos


def area_balanced_splits(n_devices: int, n: int) -> list[ColumnBlock]:
    """The reference's uneven, area-balancing split (test/runtests.jl:36-38).

    ``splits(np, N, p) = round(N * (1 - sqrt((np - p) / np)))`` gives later
    blocks fewer columns, equalizing per-worker trailing-update *area* in the
    right-looking factorization. Kept as a semantic oracle; the sharded
    engines use even blocks (+ cyclic permutation) instead, since their blocks are
    even by construction.
    """
    def split(p: int) -> int:
        return round(n * (1.0 - math.sqrt((n_devices - p) / n_devices)))

    blocks = []
    for p in range(1, n_devices + 1):
        lo = max(1, split(p - 1) + 1)  # 1-based, as in lorange (runtests.jl:37)
        hi = min(n, split(p))          # hirange (runtests.jl:38)
        blocks.append(ColumnBlock(lo - 1, hi))  # half-open 0-based
    return blocks
