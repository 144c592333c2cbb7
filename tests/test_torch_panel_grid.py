"""PyTorch port: the grid schedule of the Hopper panel kernels, on the CPU.

``hopper_panel._panel_qr_grid_model`` is the CUDA kernel's schedule in
plain PyTorch: the active rows cut into CTA slices, per-slice compensated
norms and partial dots merged in slice order, and the one-round
``W = f (<x, y> - conj(alpha) y_j)``. It is held against the JAX package's
Pallas kernel in interpret mode and against the port's plain version, with
the JAX kernel tests' tolerances (2e-5 float32, 5e-5 complex64: the
summation orders differ). The leaf-width rule that plans the blocked
engine's kernel leaves is checked at the main path's shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.ops import pallas_panel as jpp  # noqa: E402
from dhqr_tpu_torch.ops import blocked as tbl  # noqa: E402
from dhqr_tpu_torch.ops import hopper_panel as hp  # noqa: E402
from dhqr_tpu_torch.utils.config import NotPortedError  # noqa: E402

TOL = {np.float32: 2e-5, np.complex64: 5e-5}
SLICES = [1, 3, 7, 132]


def _panel(m, nb, dtype, seed, decades=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, nb))
    if dtype == np.complex64:
        x = x + 1j * rng.standard_normal((m, nb))
    if decades:
        x = x * np.logspace(-6, 6, m)[:, None]
    return x.astype(dtype)


def _model(P, offset, n_slices):
    at = torch.from_numpy(P).T.contiguous()
    alpha = hp._panel_qr_grid_model(at, offset, n_slices)
    return at.T, alpha


def _plain(P, offset):
    at = torch.from_numpy(P).T.contiguous()
    alpha = hp._PLAIN[at.dtype](at, offset)
    return at.T, alpha


def _close(got, want, tol):
    np.testing.assert_allclose(got.resolve_conj().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("n_slices", SLICES)
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_grid_model_matches_pallas_interpret(dtype, n_slices):
    P = _panel(160, 32, dtype, seed=21)
    pf, alpha = _model(P, 0, n_slices)
    pf0, alpha0 = jpp.panel_qr_pallas(jnp.asarray(P), interpret=True)
    _close(pf, pf0, TOL[dtype])
    _close(alpha, alpha0, TOL[dtype])


@pytest.mark.parametrize("n_slices", SLICES)
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_grid_model_matches_plain_version(dtype, n_slices):
    P = _panel(300, 24, dtype, seed=22)
    pf, alpha = _model(P, 0, n_slices)
    pf1, alpha1 = _plain(P, 0)
    _close(pf, pf1.numpy(), TOL[dtype])
    _close(alpha, alpha1.numpy(), TOL[dtype])


# The kernel cuts rows [offset, m); where the pivot rows j = offset + jl
# fall against those slices is what an offset changes. (m, nb, offset,
# n_slices): 96 active rows in 3 slices of 32 with the pivots inside slice
# 0; the same at offset 5 (mid-slice of the offset-0 cut); and 93 rows in 7
# slices of 14, whose pivots 3..18 reach row 17, the first of slice 1.
OFFSET_CASES = [(96, 16, 0, 3), (101, 16, 5, 3), (96, 16, 3, 7)]


@pytest.mark.parametrize("m,nb,offset,n_slices", OFFSET_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_grid_model_offsets_match_pallas_interpret(dtype, m, nb, offset,
                                                   n_slices):
    per = -(-(m - offset) // n_slices)
    if (m, offset) == (96, 3):
        assert offset + per in range(offset, offset + nb)  # a pivot on an edge
    else:
        assert nb <= per  # every pivot inside slice 0
    P = _panel(m, nb, dtype, seed=23)
    pf, alpha = _model(P, offset, n_slices)
    pf0, alpha0 = jpp._panel_qr_pallas_impl(jnp.asarray(P), offset,
                                            interpret=True)
    _close(pf, pf0, TOL[dtype])
    _close(alpha, alpha0, TOL[dtype])
    assert np.array_equal(pf.numpy()[:offset], P[:offset])  # rows above kept


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_grid_model_ragged_last_slice(dtype):
    """8193 rows over 132 CTAs: 131 slices of 63 rows, the last of 3."""
    assert hp.kernel_grid(8193) == (131, 63)
    P = _panel(8193, 6, dtype, seed=24)
    pf, alpha = _model(P, 0, 132)
    pf1, alpha1 = _plain(P, 0)
    _close(pf, pf1.numpy(), TOL[dtype])
    _close(alpha, alpha1.numpy(), TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_grid_model_zero_column(dtype):
    """A zero column gives v = 0 and alpha = -0 (f = 0, no NaN); the other
    columns are factored as the plain version factors them."""
    P = _panel(120, 8, dtype, seed=25)
    P[:, 2] = 0
    pf, alpha = _model(P, 0, 7)
    pf1, alpha1 = _plain(P, 0)
    assert np.all(np.isfinite(pf.numpy())) and float(abs(alpha[2])) == 0.0
    assert not np.any(pf.numpy()[2:, 2])
    _close(pf, pf1.numpy(), TOL[dtype])
    _close(alpha, alpha1.numpy(), TOL[dtype])


@pytest.mark.parametrize("n_slices", [7, 132])
@pytest.mark.parametrize("m", [4096, 767])
def test_grid_model_compensated_norm_12_decades(m, n_slices):
    """|alpha_0| within 5e-7 of the f64 column norm on a 12-decade column,
    the slices' (s, err) pairs merged by TwoSum (the 5e-7 bar of
    tests/test_pallas_panel.py)."""
    P = _panel(m, 4, np.float32, seed=3, decades=True)
    _, alpha = _model(P, 0, n_slices)
    s64 = np.linalg.norm(P[:, 0].astype(np.float64))
    assert abs(abs(float(alpha[0])) - s64) / s64 < 5e-7


def test_grid_model_is_deterministic():
    """The fixed merge order gives the same bits on every run."""
    P = _panel(200, 12, np.float32, seed=26)
    pf, alpha = _model(P, 2, 7)
    pf2, alpha2 = _model(P, 2, 7)
    assert torch.equal(pf, pf2) and torch.equal(alpha, alpha2)


# -- the leaf-width rule ------------------------------------------------------

def test_kernel_grid_partition():
    assert hp.kernel_grid(16384) == (132, 125)  # 125 rows x 512 B = 64 KB
    assert hp.kernel_grid(8192) == (131, 63)    # c64: 63 rows x 1 KB
    assert hp.kernel_grid(129) == (5, 26)       # a short panel: a few CTAs
    assert hp.kernel_grid(65536) == (132, 497)
    assert hp.kernel_grid(20) == (1, 20)
    assert hp.kernel_grid(16384, sms=114) == (114, 144)
    for rows in (1, 31, 32, 33, 4224, 4225, 99999):
        ctas, per = hp.kernel_grid(rows)
        assert 1 <= ctas <= min(132, hp.KERNEL_MAX_CTAS)
        assert (ctas - 1) * per < rows <= ctas * per


def test_kernel_flat_width_at_the_main_path_shapes():
    f32, c64 = torch.float32, torch.complex64
    assert hp.kernel_flat_width(16384, f32) == 128
    assert hp.kernel_flat_width(65536, f32) == 64   # 497 x 512 B > 227 KB
    assert hp.kernel_flat_width(8192, c64) == 128
    assert hp.kernel_flat_width(65536, c64) == 32
    assert hp.kernel_flat_width(2**24, f32) == 16   # too tall at any leaf:
    assert not hp.kernel_resident(2**24, 16, f32)   # streamed
    assert hp.kernel_flat_width(2**27, f32) == 0    # past int32 indices
    assert hp.kernel_flat_width(1024, torch.float64) == 0
    assert hp.kernel_flat_width(5, f32) == 128      # a panel shorter than 16
    # the card's own values decide: fewer SMs, taller slices
    assert hp.kernel_flat_width(57000, f32) == 128
    assert hp.kernel_flat_width(57000, f32, sms=114) == 64
    assert hp.kernel_flat_width(16384, f32, smem_per_block=48 * 1024) == 64


@pytest.mark.parametrize("m,n,dtype,leaves,width", [
    (16384, 16384, torch.float32, 128, 128),
    (65536, 256, torch.float32, 4, 64),
    (8192, 4096, torch.complex64, 32, 128),
])
def test_panel_plan_at_the_main_path_shapes(m, n, dtype, leaves, width):
    plan = tbl.panel_plan(m, n, 128, True, dtype)
    assert {leaf for _, _, leaf in plan} == {width}
    assert sum(tbl.kernel_leaves(w, leaf) for _, w, leaf in plan) == leaves


def test_panel_plan_routes_too_tall_panels_off_the_kernel():
    """Only ``kernel=False`` routes a panel off the kernel. A panel whose
    slices do not fit shared memory even at the narrowest leaf stays on
    it, streamed, at that leaf; one past int32 element indices raises
    NotPortedError on a card instead of taking the plain engine there."""
    rows_at_16 = (hp.H100_SMEM_PER_BLOCK - hp.KERNEL_STATIC_SMEM) // (16 * 4)
    m = 132 * rows_at_16 + 1000
    plan = tbl.panel_plan(m, 2048, 128, True, torch.float32)
    assert plan[0][2] == 16 and not hp.kernel_resident(m, 16, torch.float32)
    assert plan[-1][2] == 16 and hp.kernel_resident(m - 1920, 16,
                                                   torch.float32)
    assert tbl._resolve_kernel("auto", m, torch.float32, torch.device("cuda"))
    assert tbl._resolve_kernel("always", m, torch.float32, "cpu")
    with pytest.raises(NotPortedError, match="Queue B2"):
        tbl._resolve_kernel("auto", 2**27, torch.float32, torch.device("cuda"))
    assert not tbl._resolve_kernel("auto", 2**27, torch.float32, "cpu")
    assert all(leaf == 0 for _, _, leaf in
               tbl.panel_plan(4096, 256, 128, False, torch.float32))


def test_wrapper_refuses_a_panel_too_tall_for_shared_memory():
    """Too tall for shared memory is no longer a refusal (the kernel
    streams the slice); the wrapper refuses only a panel past int32
    element indices, before it allocates anything."""
    assert hp.panel_kernel_supported(65536, 128, torch.float32)
    with pytest.raises(ValueError, match="2\\^31"):
        hp._panel_qr_kernel(torch.zeros((2**24, 128), device="meta"), 0)


@pytest.mark.parametrize("dtype,rows,resident_widths", [
    (torch.float32, 16384, (128, 64, 32, 16)),
    (torch.float32, 65536, (64, 32, 16)),
    (torch.float32, 300000, (16,)),
    (torch.float32, 524288, ()),
    (torch.complex64, 8192, (128, 64, 32, 16)),
    (torch.complex64, 32768, (64, 32, 16)),
    (torch.complex64, 262144, ()),
])
def test_kernel_resident_rule(dtype, rows, resident_widths):
    """Each CTA's slice (rows per CTA x width x element bytes) fits the
    H100's 227 KB less the static reserve, or the launch streams it."""
    for width in hp.KERNEL_LEAF_WIDTHS:
        assert hp.kernel_resident(rows, width, dtype) == \
            (width in resident_widths)
    expect = max(resident_widths, default=hp.KERNEL_LEAF_WIDTHS[-1])
    assert hp.kernel_flat_width(rows, dtype) == expect


def test_tall_lstsq_plans_streamed_leaves():
    """A 524288 x 128 f32 ``lstsq`` (chip_smoke phase 3) is one panel split
    into eight streamed 16-wide leaves."""
    plan = tbl.panel_plan(524288, 128, 128, True, torch.float32)
    assert plan == [(0, 128, 16)]
    assert not hp.kernel_resident(524288, 16, torch.float32)
    assert tbl.kernel_leaves(128, 16) == 8


# -- the lookahead schedule's capped grid -------------------------------------

@pytest.mark.parametrize("cap,dtype,ctas,per,leaf", [
    (66, torch.float32, 66, 249, 128),    # 249 x 512 B = 125 KB: resident
    (33, torch.float32, 33, 497, 64),     # 497 x 512 B > 227 KB: 64 wide
    (16, torch.float32, 16, 1024, 32),    # 1024 x 256 B > 227 KB: 32 wide
    (66, torch.complex64, 66, 125, 128),  # 8192 rows c64
    (16, torch.complex64, 16, 512, 32),
])
def test_capped_plan_at_h100_values(cap, dtype, ctas, per, leaf):
    """The side-stream panel of the lookahead schedule is planned on at
    most ``cap`` SMs: more rows per CTA, so the leaf narrows where the
    wider slice no longer fits shared memory."""
    rows = 16384 if dtype == torch.float32 else 8192
    sms, smem = hp.device_limits("cpu", cap)
    assert (sms, smem) == (cap, hp.H100_SMEM_PER_BLOCK)
    assert hp.kernel_grid(rows, sms) == (ctas, per)
    assert hp._plan(rows, leaf, 0, dtype, "cpu", cap) == (ctas, per, True)
    assert hp.kernel_flat_width(rows, dtype, sms, smem) == leaf
    wider = [w for w in hp.KERNEL_LEAF_WIDTHS if w > leaf]
    assert not any(hp.kernel_resident(rows, w, dtype, sms) for w in wider)
    assert hp.device_limits("cpu", 1000) == hp.device_limits("cpu")


@pytest.mark.parametrize("m,n,dtype,cap,launches", [
    (16384, 16384, torch.float32, 66, 128),
    # capped at 16: 32-wide leaves above 14016 rows (18 panels of 4), 64
    # above 7008 (55 of 2), 128 below (53 of 1), and two uncapped panels
    (16384, 16384, torch.float32, 16, 18 * 4 + 55 * 2 + 53 + 2),
    (8192, 4096, torch.complex64, 66, 32),
])
def test_lookahead_plan_launches(m, n, dtype, cap, launches):
    """The lookahead path's plan: the first panel and the last (nothing
    right of it) on the whole card, every other panel capped; its kernel
    launches follow from it as the default path's do."""
    plan = tbl.panel_plan(m, n, 128, True, dtype, "cpu", cap)
    default = tbl.panel_plan(m, n, 128, True, dtype, "cpu")
    assert [p[:2] for p in plan] == [p[:2] for p in default]
    assert plan[0] == default[0] and plan[-1] == default[-1]
    assert sum(tbl.kernel_leaves(w, leaf) for _, w, leaf in plan) == launches
    assert [tbl._beside_gemm(i, k, w, n) for i, (k, w, _) in
            enumerate(plan)] == [False] + [True] * (len(plan) - 2) + [False]


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_grid_model_at_a_capped_grid_matches_plain_version(dtype):
    """The grid model cut as the capped launch cuts the panel (16 CTAs of
    1024 rows at 16384 rows; here 16 slices of a 1000-row panel) agrees
    with the plain version as the uncapped grid does."""
    P = _panel(1000, 16, dtype, seed=27)
    ctas = hp._plan(1000, 16, 0, torch.float32, "cpu", 16)[0]
    assert ctas == 16
    pf, alpha = _model(P, 0, ctas)
    pf1, alpha1 = _plain(P, 0)
    _close(pf, pf1.numpy(), TOL[dtype])
    _close(alpha, alpha1.numpy(), TOL[dtype])
    pf2, alpha2 = hp._panel_qr_grid_leaf(torch.from_numpy(P), 0, sms=16)
    assert torch.equal(pf2, pf) and torch.equal(alpha2, alpha)
