"""The yardstick's counts at the cells' shapes, worked by hand, and each
entry's nominal work per call."""

import pytest

from hqrbench import spec, work

PEAK = {"flops_per_s": 67e12, "bytes_per_s": 3.35e12}


def test_square_counts():
    n = 16384
    assert work.qr_flops(n, n) == pytest.approx(4 / 3 * n ** 3, rel=1e-15)
    assert work.qr_flops(n, n) == pytest.approx(5864062014805.333, rel=1e-15)
    # Q^T b: 4 n^2 - 2 n^2; back-substitution: n^2
    assert work.solve_flops(n, n) == 805306368.0
    assert spec.entry("qr_solve").flops(n, n) == pytest.approx(
        5864062014805.333 + 805306368.0, rel=1e-15)
    assert spec.entry("solve").flops(n, n) == 805306368.0


def test_tall_counts():
    m, n = 131072, 512
    assert work.qr_flops(m, n) == pytest.approx(68629998250.66667, rel=1e-15)
    assert work.solve_flops(m, n) == 268435456 - 524288 + 262144
    assert spec.entry("lstsq").flops(m, n) == pytest.approx(
        68898171562.66667, rel=1e-15)
    assert spec.entry("solve").flops(m, n) == 268173312.0


def test_panel_leaves_and_bound():
    # 16 kernel launches on 512 columns: 32-wide leaves, rows m - 32 c
    leaves = work.panel_leaves(131072, 512, 16)
    assert leaves[0] == (131072, 32) and leaves[-1] == (131072 - 480, 32)
    assert len(leaves) == 16
    assert work.panel_leaves(16384, 16384, 128)[1] == (16384 - 128, 128)
    assert work.panel_leaves(100, 10, 3) == []
    # a 131072 x 32 leaf: 2 r w^2 - (2/3) w^3 flops, 2 r w 4 + 4 w bytes;
    # its bytes bound it
    flops = 2 * 131072 * 32 ** 2 - (2 / 3) * 32 ** 3
    nbytes = 2 * 131072 * 32 * 4 + 32 * 4
    assert work.qr_flops(131072, 32) == pytest.approx(flops)
    assert work.panel_bytes(131072, 32, 4) == nbytes
    assert work.least_seconds(flops, nbytes, PEAK) == nbytes / 3.35e12
    total = sum(max(work.qr_flops(r, w) / 67e12,
                    work.panel_bytes(r, w, 4) / 3.35e12) for r, w in leaves)
    assert work.panel_least_seconds(131072, 512, 16, 4, PEAK) == \
        pytest.approx(total)
    assert work.panel_least_seconds(131072, 512, 15, 4, PEAK) is None


def test_trailing_and_solve_bounds():
    n = 16384
    leaves = work.panel_leaves(n, n, 128)
    flops = work.qr_flops(n, n) - sum(work.qr_flops(r, w) for r, w in leaves)
    # compute-bound: 5.83e12 flops against 9.2e10 bytes
    assert work.trailing_least_seconds(n, n, 128, 4, PEAK) == \
        pytest.approx(flops / 67e12)
    assert 0.086 < flops / 67e12 < 0.088
    # the solve is bytes-bound: H once, b once, x once
    assert work.solve_least_seconds(n, n, 4, PEAK) == pytest.approx(
        (n * n + 2 * n) * 4 / 3.35e12)
    assert work.solve_least_seconds(131072, 512, 4, PEAK) == pytest.approx(
        (131072 * 512 + 131072 + 512) * 4 / 3.35e12)


def test_peaks_file():
    peak = work.peaks()
    assert peak["flops_per_s"] == 67e12 and peak["bytes_per_s"] == 3.35e12
    assert "data sheet" in peak["source"]
