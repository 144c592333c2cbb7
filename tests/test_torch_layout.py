"""PyTorch port: ``dhqr_tpu_torch.parallel.layout``, the port's own copy of
the numpy-only ``dhqr_tpu.parallel.layout``, is held equal to the original
on every function over a grid of (n, P, nb), errors included; and the
port's mesh helpers that need no process group (the local column index,
the panel and column owners, the orthogonal padding) against the JAX
engine's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.parallel import layout as jlay  # noqa: E402
from dhqr_tpu.parallel import sharded_qr as jsq  # noqa: E402
from dhqr_tpu_torch.parallel import layout as tlay  # noqa: E402
from dhqr_tpu_torch.parallel import sharded_qr as tsq  # noqa: E402

GRID = [(n, P, nb) for n in (1, 7, 24, 45, 64, 100, 128, 200)
        for P in (1, 2, 3, 4, 8) for nb in (1, 3, 8, 16, 128)]


def _outcome(fn, *args):
    """A function's value, or the type and message of what it raised."""
    try:
        out = fn(*args)
    except (ValueError, ZeroDivisionError) as exc:
        return ("raised", type(exc).__name__, str(exc))
    if isinstance(out, np.ndarray):
        return ("array", out.dtype.str, out.tolist())
    if isinstance(out, list):
        return [(b.start, b.stop, b.width) for b in out]
    if isinstance(out, (jlay.ColumnBlock, tlay.ColumnBlock)):
        return (out.start, out.stop, out.width)
    return out


@pytest.mark.parametrize("name", ["plan_padding", "cyclic_store_columns",
                                  "natural_store_positions"])
def test_layout_copy_matches_jax_on_the_grid(name):
    for n, P, nb in GRID:
        assert _outcome(getattr(tlay, name), n, P, nb) == \
            _outcome(getattr(jlay, name), n, P, nb), (name, n, P, nb)


def test_block_functions_match_jax_on_the_grid():
    for n, P, nb in GRID:
        for p in range(P):
            assert _outcome(tlay.local_column_block, n, P, p) == \
                _outcome(jlay.local_column_block, n, P, p), (n, P, p)
        assert _outcome(tlay.column_block_ranges, n, P) == \
            _outcome(jlay.column_block_ranges, n, P), (n, P)
        assert _outcome(tlay.area_balanced_splits, P, n) == \
            _outcome(jlay.area_balanced_splits, P, n), (n, P)
        assert tlay.fit_block_size(n, nb) == jlay.fit_block_size(n, nb)
        blk = tlay.ColumnBlock(nb, n + nb)
        assert (blk.width, blk.contains(nb), blk.contains(n + nb)) == \
            (n, True, False)


def test_plan_padding_refuses_nonpositive_n():
    for n in (0, -3):
        assert _outcome(tlay.plan_padding, n, 2, 8) == \
            _outcome(jlay.plan_padding, n, 2, 8)


@pytest.mark.parametrize("layout", ["block", "cyclic"])
def test_local_index_and_owners_match_jax(layout):
    """The store-order global index of each local column (ascending, so the
    live columns are a suffix), and the panel and column owners."""
    for n, P, nb in ((24, 2, 4), (48, 4, 3), (64, 2, 8), (72, 4, 3)):
        nloc = n // P
        seen = []
        for p in range(P):
            got = tsq._local_gidx(p, n, nloc, nb, layout)
            want = np.asarray(jsq._local_gidx(p, n, nloc, nb, layout))
            assert got == want.tolist()
            assert got == sorted(got)
            seen += got
        assert sorted(seen) == list(range(n))
        for k in range(0, n, nb):
            assert tsq._panel_owner(k, n, nloc, nb, layout) == \
                jsq._panel_owner(k, n, nloc, nb, layout)
        for col in range(n):
            owner = tsq._col_owner(col, n, P, nb, layout)
            assert owner == jsq._col_owner(col, n, P, nb, layout)
            local = tsq._col_local(col, n, P, nb, layout)
            assert tsq._local_gidx(owner, n, nloc, nb, layout)[local] == col


def test_orthogonal_padding_matches_jax():
    A = np.random.default_rng(3).random((9, 5))
    for n_pad in (5, 6, 8):
        got = tsq._pad_cols_orthogonal(torch.from_numpy(A), n_pad).numpy()
        want = np.asarray(jsq._pad_cols_orthogonal(jnp.asarray(A), n_pad))
        assert np.array_equal(got, want)
