"""PyTorch port: the float64 panel kernel's plain twin and the float64 main
path on it, against the benchmark's plain reference
(``hqrbench/reference/householder.py``: LAPACK's geqrf panels) and the
JAX package's plain float64 panels (``householder._panel_qr_masked``; the
JAX package has no float64 kernel).

On a CPU tensor ``use_pallas="always"`` runs the twin in the kernel's
place, so these are the float64 kernel route's CPU tests; ``chip_smoke.py``
holds the CUDA kernel against the twin on the card. Shapes are the
source's own test sizes (``test/runtests.jl``: m = 1.1 n, 110 x 100 and
440 x 400 of its sweep up to 4400 x 4000).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu.ops import householder as jhh  # noqa: E402
from dhqr_tpu_torch.ops import blocked as tbl  # noqa: E402
from dhqr_tpu_torch.ops import hopper_panel as hp  # noqa: E402
from hqrbench.reference import householder as ref  # noqa: E402

F64 = torch.float64
# The twin against LAPACK's geqrf and the JAX panels, relative to the
# panel's largest entry: a few hundred roundings of 1.1e-16 at these
# heights (the float32 kernel's own tolerance, 2e-5, is ~1e9 times wider).
TOL_PANEL = 1e-13
# The main path against the reference, the judge's numbers: a backward
# stable f64 factorization reads ~1e-15 here, float32 ~1e-7.
TOL_FACTOR = 1e-13
TOL_FIT = 1e-13
# x against x_ref scales with cond(A) (1e3-1e4 for these uniform draws):
# f64 reads ~1e-13, float32 ~1e-4.
TOL_X = 1e-9


def _uniform(m, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).random((m, n)))


def _close(got, want, tol):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale


def _ref_panel(P, off):
    """The reference's panel (geqrf, sqrt(tau) v storage) of the rows from
    ``off`` down, the rows above kept: the masked panel's factors, each v
    signed as the kernel's (below)."""
    H = P.clone()
    alpha = H.new_zeros(P.shape[1])
    ref._panel(H[off:], alpha)
    return H, alpha


def _signed(pf, off):
    """``pf`` with each stored v made to start >= 0. geqrf's v starts at
    +sqrt(tau), the kernel's at f (a_jj - alpha_j), whose sign is a_jj's;
    v and -v make the same reflector I - v v^T, so the factors agree up to
    that sign per column."""
    out = pf.clone()
    for j in range(pf.shape[1]):
        if out[off + j, j] < 0:
            out[off + j:, j].neg_()
    return out


def _norms_sq(pf, off):
    """||v_j||^2 of each stored reflector (rows off + j down of column j)."""
    return torch.stack([pf[off + j:, j].square().sum()
                        for j in range(pf.shape[1])])


@pytest.mark.parametrize("shape,off", [((110, 100), 0), ((110, 100), 7),
                                       ((440, 128), 0), ((440, 128), 37),
                                       ((440, 128), 311)])
def test_twin_matches_reference_and_jax(shape, off):
    """Offsets up to 311 of 440 rows: the last column keeps two active rows
    (on one row geqrf takes tau = 0, H = I, where the kernel reflects)."""
    P = _uniform(*shape, seed=sum(shape) + off)
    pf, alpha = hp._panel_qr_kernel(P, off)
    assert pf.dtype == F64 and alpha.dtype == F64
    H, a = _ref_panel(P, off)
    _close(_signed(pf, off), H, TOL_PANEL)
    _close(alpha, a, TOL_PANEL)
    jpf, jalpha = jhh._panel_qr_masked(jnp.asarray(P.numpy()), off)
    _close(pf, torch.from_numpy(np.asarray(jpf)), TOL_PANEL)
    _close(alpha, torch.from_numpy(np.asarray(jalpha)), TOL_PANEL)
    assert torch.equal(pf[:off], P[:off])  # rows above the offset kept
    torch.testing.assert_close(_norms_sq(pf, off),
                               torch.full((shape[1],), 2.0, dtype=F64),
                               rtol=0, atol=1e-14)


def test_twin_zero_column_and_tall_leaf():
    """A zero column stores v = 0 and alpha = 0 (LAPACK's tau = 0), and the
    columns after it factor as usual; a 4096 x 16 leaf (the shape of the
    blocked engine's narrowest, tallest leaves) holds the same bar."""
    P = _uniform(440, 32, seed=5)
    P[:, 9] = 0.0
    pf, alpha = hp._panel_qr_kernel(P, 0)
    H, a = _ref_panel(P, 0)
    _close(_signed(pf, 0), H, TOL_PANEL)
    _close(alpha, a, TOL_PANEL)
    assert float(alpha[9]) == 0.0 and not pf[9:, 9].any()
    norms = _norms_sq(pf, 0)
    assert torch.allclose(norms[torch.arange(32) != 9],
                          torch.full((31,), 2.0, dtype=F64), rtol=0,
                          atol=1e-14)
    T = _uniform(4096, 16, seed=6)
    pf, alpha = hp._panel_qr_kernel(T, 3)
    H, a = _ref_panel(T, 3)
    _close(_signed(pf, 3), H, TOL_PANEL)
    _close(alpha, a, TOL_PANEL)


def test_twin_compensated_norm_is_exact_to_rounding():
    """The float64 twin's squares are exact (Veltkamp split at 2^27 + 1):
    on a column spanning 24 decades |alpha_0| is the norm to a few ulps,
    where an uncompensated sum would lose the small entries."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4097, 4)) * np.logspace(-12, 12, 4097)[:, None]
    _, alpha = hp.panel_qr_kernel(torch.from_numpy(x))
    col = x[:, 0]
    big = np.abs(col).max()
    want = big * np.sqrt(np.sum((col / big) ** 2))
    assert abs(abs(float(alpha[0])) - want) / want < 1e-15


@pytest.mark.parametrize("shape", [(110, 100), (440, 400)])
def test_qr_solve_f64_on_the_kernel_route(shape):
    """``qr`` + ``solve`` in float64 with ``use_pallas="always"`` (the
    twin, 128-wide panels) against the reference, by the judge's numbers;
    float32 through the same route fails each tolerance by orders of
    magnitude."""
    m, n = shape
    A = _uniform(m, n, seed=m)
    b = _uniform(m, 1, seed=m + 1)[:, 0]
    H_ref, a_ref = ref.qr(A)
    x_ref = ref.solve(H_ref, a_ref, b)
    errs = {}
    for dtype in (torch.float64, torch.float32):
        fact = dt.qr(A.to(dtype), device="cpu", use_pallas="always",
                     precision="highest")
        x = fact.solve(b.to(dtype))
        assert fact.H.dtype == dtype and x.dtype == dtype
        errs[dtype] = (ref.factor_error(A, fact.H, fact.alpha),
                       *ref.solution_errors(A, x, x_ref))
    factor_err, x_err, fit_err = errs[torch.float64]
    assert factor_err < TOL_FACTOR and fit_err < TOL_FIT and x_err < TOL_X
    f32 = errs[torch.float32]
    assert f32[0] > 100 * TOL_FACTOR and f32[1] > 100 * TOL_X \
        and f32[2] > 100 * TOL_FIT


def test_f64_routing():
    """float64 takes the kernel under "auto" on a CUDA device and under
    "always" anywhere; complex128 stays the dtype "always" refuses; the
    plan gives float64 c64's leaf widths (8-byte elements)."""
    cuda = torch.device("cuda")  # only its type is read; no card needed
    cpu = torch.device("cpu")
    assert tbl._resolve_kernel("auto", 4400, F64, cuda)
    assert not tbl._resolve_kernel("auto", 4400, F64, cpu)
    assert tbl._resolve_kernel("always", 4400, F64, cpu)
    with pytest.raises(hp.KernelRefusal):
        tbl._resolve_kernel("always", 4400, torch.complex128, cuda)
    assert hp.KERNELS[F64] == "panel_qr_f64" and F64 in hp._PLAIN
    for rows in (4400, 16384, 65536, 2**18, 2**27 + 8191):
        assert hp.kernel_flat_width(rows, F64) == \
            hp.kernel_flat_width(rows, torch.complex64)
    assert hp.kernel_variant(4400, 128, F64) == "registers"  # 34 rows/CTA
    assert hp.kernel_variant(16384, 128, F64) == "registers"  # 125: 8 x 4 x 2
    # one column per lane: at most 24 rows per warp in f64 (48 floats)
    assert hp.kernel_variant(50000, 32, F64) == "registers"  # 379 rows/CTA
    assert hp.kernel_variant(60000, 32, F64) == "shared"  # 455 rows/CTA
    assert hp.kernel_variant(60000, 32, torch.complex64) == "registers"
    assert hp.kernel_variant(131072, 16, F64) == "shared"  # 993 x 128 B
    assert hp.kernel_variant(131072, 32, F64) == "streamed"  # 993 x 256 B
    assert hp.kernel_variant(262144, 16, F64) == "streamed"
    plan = tbl.panel_plan(4400, 4000, 128, True, F64, cuda)
    assert [w for _, w, _ in plan] == [128] * 31 + [32]
    assert all(leaf == 128 for _, _, leaf in plan)


@pytest.mark.parametrize("off", [0, 3, 96])
def test_twin_in_place_entry_is_the_wrapper_in_place(off):
    """The float64 in-place entry on a view of the source's 440 x 400
    problem (a 128-wide panel at column 128): the wrapper's factors and
    alpha where they lie, bit for bit, and H outside the view's rows
    ``off:`` untouched."""
    H = _uniform(440, 400, seed=45)
    H0 = H.clone()
    alpha = torch.zeros(400, dtype=F64)
    view = H[128:, 128:256]
    pf, a = hp._panel_qr_kernel(view, off)
    assert hp._panel_qr_kernel_in_place(view, off, alpha[128:256]) \
        == "in_place"
    assert torch.equal(view[off:], pf[off:])
    assert torch.equal(alpha[128:256], a)
    outside = torch.ones(H.shape, dtype=torch.bool)
    outside[128 + off:, 128:256] = False
    assert torch.equal(H[outside], H0[outside])
    assert not alpha[:128].any() and not alpha[256:].any()


@pytest.mark.parametrize("m,n,nb,flat", [(440, 400, 128, None),
                                         (2048, 256, 256, 32)])
def test_twin_in_place_panels_match_the_transposed_route(m, n, nb, flat):
    """The engine's float64 panels in place in H against the transposed
    route (tests/test_torch_blocked.py holds float32 and complex64): the
    same bits without the recursion, roundoff in its GEMMs with it."""
    A = _uniform(m, n, seed=46)
    H, alpha = tbl._blocked_qr_impl(A.clone(), nb, kernel=True, flat=flat)
    H0, alpha0 = tbl._blocked_qr_impl(A.clone(), nb, kernel=True, flat=flat,
                                      leaf=hp._panel_qr_kernel)
    if flat is None:
        assert torch.equal(H, H0) and torch.equal(alpha, alpha0)
    _close(H, H0, TOL_PANEL)
    _close(alpha, alpha0, TOL_PANEL)
