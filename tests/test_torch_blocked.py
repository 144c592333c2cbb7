"""PyTorch port: ops/blocked.py against the JAX package's blocked engine.

Tolerances: atol/rtol 5e-4 for float32/complex64 factors — the bar of
tests/test_pallas_panel.py::test_blocked_qr_with_pallas_panels, since the
two engines differ in GEMM and panel summation order over several panels —
and 1e-10 for float64 (the same arithmetic at double precision).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu.ops import blocked as jbl  # noqa: E402
from dhqr_tpu.utils.testing import random_problem  # noqa: E402
from dhqr_tpu_torch.ops import blocked as tbl  # noqa: E402
from dhqr_tpu_torch.ops import hopper_panel as hp  # noqa: E402


def _close(got, want, tol):
    np.testing.assert_allclose(got.resolve_conj().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("mode", ["never", "always"])
def test_blocked_220x200_matches_jax(mode):
    """nb=64 (4 panels, ragged last one); "always" runs the kernel's plain
    version on these CPU tensors, "never" the masked panel loop."""
    A, _ = random_problem(220, 200, np.float32, seed=5)
    H, alpha = tbl.blocked_householder_qr(A, 64, use_pallas=mode, device="cpu")
    H0, alpha0 = jbl.blocked_householder_qr(jnp.asarray(A), 64,
                                            use_pallas="never")
    _close(H, H0, 5e-4)
    _close(alpha, alpha0, 5e-4)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 5e-4)])
def test_blocked_many_panels_matches_jax_scanned_path(dtype, tol):
    """600 x 576 at nb=64 is 9 panels, more than the JAX engine's
    MAX_UNROLLED_PANELS, so JAX takes its two-level scanned path while the
    port runs its one shrinking-slice loop."""
    assert 576 // 64 > jbl.MAX_UNROLLED_PANELS
    A, _ = random_problem(600, 576, dtype, seed=6)
    H, alpha = tbl.blocked_householder_qr(A, 64, use_pallas="never",
                                          device="cpu")
    H0, alpha0 = jbl.blocked_householder_qr(jnp.asarray(A), 64,
                                            use_pallas="never")
    _close(H, H0, tol)
    _close(alpha, alpha0, tol)


def test_blocked_complex64_always_matches_jax():
    A, _ = random_problem(220, 200, np.complex64, seed=7)
    H, alpha = tbl.blocked_householder_qr(A, 64, use_pallas="always",
                                          device="cpu")
    H0, alpha0 = jbl.blocked_householder_qr(jnp.asarray(A), 64,
                                            use_pallas="never")
    _close(H, H0, 5e-4)
    _close(alpha, alpha0, 5e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_narrow_tall_leaf_matches_jax(dtype):
    """4096 x 16 is one 16-wide panel: the narrow leaf that the card
    streams past shared memory, past 2^31 elements too. The port's kernel
    route runs the kernel's plain version on these CPU tensors, the JAX
    package its Pallas kernel in interpret mode; the factors and the
    least-squares solution agree to 5e-4 (the file's f32/c64 bar)."""
    A, b = random_problem(4096, 16, dtype, seed=16)
    H, alpha = tbl.blocked_householder_qr(A, 128, use_pallas="always",
                                          device="cpu")
    H0, alpha0 = jbl.blocked_householder_qr(jnp.asarray(A), 128,
                                            use_pallas="always")
    _close(H, H0, 5e-4)
    _close(alpha, alpha0, 5e-4)
    x = dt.lstsq(A, b, use_pallas="always", device="cpu")
    x0 = dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b), use_pallas="always")
    _close(x, x0, 5e-4)


def test_donate_factors_in_place():
    A, _ = random_problem(96, 64, np.float64, seed=8)
    At = torch.from_numpy(A.copy())
    ptr = At.data_ptr()
    H, alpha = tbl.blocked_householder_qr(At, 32, donate=True, device="cpu")
    assert H.data_ptr() == ptr and H is At
    H2, _ = tbl.blocked_householder_qr(A, 32, device="cpu")
    assert H2.data_ptr() != ptr
    torch.testing.assert_close(H, H2, atol=0, rtol=0)
    # without donate the caller's tensor is left alone
    B = torch.from_numpy(A.copy())
    tbl.blocked_householder_qr(B, 32, device="cpu")
    assert np.array_equal(B.numpy(), A)


@pytest.mark.parametrize("nrhs", [None, 3])
def test_blocked_apply_qt_and_q_match_jax(nrhs):
    A, b = random_problem(150, 100, np.float64, seed=9)
    if nrhs:
        b = np.random.default_rng(1).random((150, nrhs))
    H0, alpha0 = jbl.blocked_householder_qr(jnp.asarray(A), 32,
                                            use_pallas="never")
    H, alpha = np.asarray(H0), np.asarray(alpha0)
    qt = tbl.blocked_apply_qt(H, alpha, b, 32, device="cpu")
    _close(qt, jbl.blocked_apply_qt(H0, alpha0, jnp.asarray(b), 32), 1e-12)
    q = tbl.blocked_apply_q(H, alpha, b, 32, device="cpu")
    _close(q, jbl.blocked_apply_q(H0, alpha0, jnp.asarray(b), 32), 1e-12)


def test_building_blocks_match_jax():
    rng = np.random.default_rng(10)
    Y = np.tril(rng.standard_normal((40, 8)) + 1j * rng.standard_normal((40, 8)))
    C = rng.standard_normal((40, 5)) + 1j * rng.standard_normal((40, 5))
    Yt, Ct = torch.from_numpy(Y), torch.from_numpy(C)
    _close(tbl.wy_upper(Yt), jbl.wy_upper(jnp.asarray(Y)), 1e-12)
    _close(tbl.apply_block_reflector_h(Yt, Ct),
           jbl.apply_block_reflector_h(jnp.asarray(Y), jnp.asarray(C)), 1e-12)
    _close(tbl.apply_block_reflector(Yt, Ct),
           jbl.apply_block_reflector(jnp.asarray(Y), jnp.asarray(C)), 1e-12)
    P = rng.standard_normal((12, 4))
    _close(tbl.shifted_tril(torch.from_numpy(P), 3),
           jbl.shifted_tril(jnp.asarray(P), 3), 0)
    # in place writes the same values into C's storage
    C2 = Ct.clone()
    out = tbl.apply_block_reflector_h(Yt, C2, inplace=True)
    assert out.data_ptr() == C2.data_ptr()
    torch.testing.assert_close(C2, tbl.apply_block_reflector_h(Yt, Ct))


def test_kernel_routing_modes():
    cuda = torch.device("cuda")  # only its type is read; no card needed
    cpu = torch.device("cpu")
    assert tbl._resolve_kernel("auto", 1024, torch.float32, cuda)
    assert tbl._resolve_kernel("auto", 1024, torch.complex64, cuda)
    assert tbl._resolve_kernel("auto", 1024, torch.float64, cuda)
    assert not tbl._resolve_kernel("auto", 1024, torch.complex128, cuda)
    assert not tbl._resolve_kernel("auto", 1024, torch.float32, cpu)
    assert tbl._resolve_kernel("always", 1024, torch.float32, cpu)
    assert not tbl._resolve_kernel("never", 1024, torch.float32, cuda)
    with pytest.raises(hp.KernelRefusal):
        tbl._resolve_kernel("always", 1024, torch.complex128, cpu)
    with pytest.raises(ValueError):
        tbl._resolve_kernel("sometimes", 1024, torch.float32, cpu)
    # past 2^31 elements (2^27 x 16) and 2^31 rows: still the kernel, whose
    # row and element indices are 64-bit
    assert tbl._resolve_kernel("auto", 2**27, torch.float32, cuda)
    assert tbl._resolve_kernel("auto", 2**31 + 4097, torch.complex64, cuda)


def test_engine_follows_its_panel_plan(monkeypatch):
    """The plan is the routing: every panel it puts on the kernel reaches
    the kernel wrapper, once per leaf, and no other panel does."""
    calls = []
    plain = dict(hp._PLAIN)

    def counting(at, offset):
        calls.append(tuple(at.shape))
        return plain[at.dtype](at, offset)

    monkeypatch.setitem(hp._PLAIN, torch.float32, counting)
    A, _ = random_problem(300, 200, np.float32, seed=11)
    tbl.blocked_householder_qr(A, 64, use_pallas="always", device="cpu")
    plan = tbl.panel_plan(300, 200, 64, True, torch.float32)
    assert [(w, 300 - k) for k, w, leaf in plan if leaf] == \
        [(nb, m) for nb, m in calls]
    assert {leaf for _, _, leaf in plan} == {128}  # short panels: widest leaf
    assert sum(tbl.kernel_leaves(w, leaf) for _, w, leaf in plan if leaf) \
        == len(calls)
    assert tbl.kernel_leaves(128) == 1 and tbl.kernel_leaves(256) == 2
    assert tbl.kernel_leaves(384) == 4  # 192 -> 96 + 96, twice
    assert tbl.kernel_leaves(128, 64) == 2 and tbl.kernel_leaves(256, 64) == 4


def test_wide_panels_split_into_kernel_leaves(monkeypatch):
    """A 256-wide panel is factored by the geqrt3 recursion with two
    128-wide kernel leaves, and matches the flat plain loop."""
    calls = []
    plain = dict(hp._PLAIN)

    def counting(at, offset):
        calls.append((tuple(at.shape), offset))
        return plain[at.dtype](at, offset)

    monkeypatch.setitem(hp._PLAIN, torch.float32, counting)
    A, _ = random_problem(300, 256, np.float32, seed=12)
    At = torch.from_numpy(A)
    pf, alpha = tbl._panel_factor_kernel(At, 0, tbl.KERNEL_FLAT_WIDTH)
    assert calls == [((128, 300), 0), ((128, 300), 128)]
    pf0, alpha0 = tbl._panel_factor(At, 0)
    torch.testing.assert_close(pf, pf0, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(alpha, alpha0, atol=5e-4, rtol=5e-4)


def test_auto_block_size_is_128():
    """128-wide panels; 128 is the widest kernel leaf, and the leaf narrows
    where a 128-wide slice would not fit shared memory."""
    assert tbl.auto_block_size(16384, torch.float32) == 128
    assert tbl.DEFAULT_BLOCK_SIZE == 128 and tbl.KERNEL_FLAT_WIDTH == 128
    assert tbl.KERNEL_FLAT_WIDTH == max(hp.KERNEL_LEAF_WIDTHS)
    assert [leaf for _, _, leaf in
            tbl.panel_plan(65536, 256, 128, True, torch.float32)] == [64, 64]


# -- the kernel's leaf in place in H ------------------------------------------

# (m, n, block_size, flat): the geqrt3 recursion over 32-wide leaves (a
# 256-wide panel, and 128-wide ones past a ragged first), and flat
# 128-wide panels, which take no recursion.
IN_PLACE_SHAPES = [(2048, 256, 256, 32), (1000, 300, 128, 32),
                   (600, 384, 128, None)]
IN_PLACE_TOL = {np.float32: 2e-5, np.complex64: 5e-5, np.float64: 1e-12}


def in_place_and_transposed(m, n, nb, flat, dtype, seed=41):
    """The engine's factors on the kernel's own leaf (in place in H) and
    with the wrapper as a stand-in leaf (the transposed copies, the
    out-of-place recursion and the write-back), on the plain twin."""
    A = torch.from_numpy(random_problem(m, n, dtype, seed=seed)[0])
    got = tbl._blocked_qr_impl(A.clone(), nb, kernel=True, flat=flat)
    want = tbl._blocked_qr_impl(A.clone(), nb, kernel=True, flat=flat,
                                leaf=hp._panel_qr_kernel)
    return got, want


def check_in_place_route(m, n, nb, flat, dtype):
    (H, alpha), (H0, alpha0) = in_place_and_transposed(m, n, nb, flat, dtype)
    if flat is None:  # no recursion: the same operations bit for bit
        assert torch.equal(H, H0) and torch.equal(alpha, alpha0)
    tol = IN_PLACE_TOL[dtype]
    torch.testing.assert_close(H, H0, atol=tol, rtol=tol)
    torch.testing.assert_close(alpha, alpha0, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("m,n,nb,flat", IN_PLACE_SHAPES)
def test_in_place_panels_match_the_transposed_route(m, n, nb, flat, dtype):
    """The recursion in place in H gives the factors of the transposed
    route: the leaves are the same bits, and only the GEMMs' operand
    layouts differ (H's row stride where a contiguous half stood)."""
    check_in_place_route(m, n, nb, flat, dtype)


def test_layout_launches_follow_the_plan():
    """``plan_layouts`` is ``LAYOUT_LAUNCHES`` of a factorization (the
    H100's plan on the CPU): the tall lstsq's 16 leaves 32 wide in place,
    the square qr's 128 panels in place, capped or not, and streamed
    16-wide leaves on the transposed copy."""
    lsq = tbl.panel_plan(131072, 512, 128, True, torch.float32)
    assert [leaf for *_, leaf in lsq] == [32] * 4
    assert tbl.plan_layouts(131072, lsq, torch.float32) == {
        "in_place": 16, "transposed": 0}
    for cap in (None, hp.LOOKAHEAD_CTAS):
        sq = tbl.panel_plan(16384, 16384, 128, True, torch.float32, None,
                            cap)
        assert tbl.plan_layouts(16384, sq, torch.float32, None, cap) == {
            "in_place": 128, "transposed": 0}
    tall = tbl.panel_plan(524288, 128, 128, True, torch.float32)
    assert tbl.plan_layouts(524288, tall, torch.float32) == {
        "in_place": 0, "transposed": 8}
    ref = tbl.panel_plan(4400, 4000, 128, True, torch.float64)
    assert tbl.plan_layouts(4400, ref, torch.float64) == {
        "in_place": 32, "transposed": 0}
    assert tbl.leaf_layouts(4096, 128, 32, torch.complex64) == {
        "in_place": 4, "transposed": 0}


def test_engine_leaves_take_the_planned_layouts(monkeypatch):
    """Every kernel leaf of the engine goes through the in-place entry, in
    the layout the plan predicts: with the lookahead cap at one CTA, the
    panel beside the GEMM gets 16-wide streamed leaves, which take the
    transposed copy; the others stay in place. The factors are the default
    schedule's to roundoff."""
    layouts = []
    real = tbl._panel_qr_kernel_in_place

    def spy(panel, offset, alpha, sms=None):
        layouts.append(real(panel, offset, alpha, sms))
        return layouts[-1]

    monkeypatch.setattr(tbl, "_panel_qr_kernel_in_place", spy)
    A = torch.from_numpy(random_problem(4000, 192, np.float32, seed=42)[0])
    H, alpha = tbl._blocked_qr_impl(A.clone(), 64, kernel=True,
                                    lookahead=True, lookahead_ctas=1)
    plan = tbl.panel_plan(4000, 192, 64, True, torch.float32, "cpu", 1)
    assert [leaf for *_, leaf in plan] == [128, 16, 128]
    want = tbl.plan_layouts(4000, plan, torch.float32, "cpu", 1)
    assert want == {"in_place": 2, "transposed": 4}
    assert {name: layouts.count(name) for name in hp.LAYOUTS} == want
    H0, alpha0 = tbl._blocked_qr_impl(A.clone(), 64, kernel=True)
    torch.testing.assert_close(H, H0, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(alpha, alpha0, atol=5e-4, rtol=5e-4)


def test_a_stand_in_leaf_keeps_the_out_of_place_contract(monkeypatch):
    """A ``leaf=`` passed for a measurement is called as the wrapper is,
    on a panel it must not modify (the out-of-place recursion copies the
    result back), and the in-place entry is never reached."""
    seen = []

    def leaf(panel, offset, sms=None):
        before = panel.clone()
        out = hp._panel_qr_kernel(panel, offset, sms)
        seen.append(torch.equal(panel, before))
        return out

    def no_in_place(*args, **kwargs):
        raise AssertionError("the in-place entry took a stand-in's panel")

    monkeypatch.setattr(tbl, "_panel_qr_kernel_in_place", no_in_place)
    A = torch.from_numpy(random_problem(600, 256, np.float32, seed=43)[0])
    H, alpha = tbl._blocked_qr_impl(A.clone(), 256, kernel=True, flat=64,
                                    leaf=leaf)
    assert seen == [True] * 4
    monkeypatch.undo()
    H0, alpha0 = tbl._blocked_qr_impl(A.clone(), 256, kernel=True, flat=64)
    torch.testing.assert_close(H, H0, atol=2e-5, rtol=2e-5)


def test_rank_hook_counts_the_in_place_leaves(monkeypatch):
    """``parallel/_ranks.run_grads`` counts the kernel's calls by patching
    the engine's entries: the in-place leaves count as the wrapper's calls
    did, once per leaf of the plan, with grad off and on."""
    from dhqr_tpu_torch.parallel import _ranks

    monkeypatch.setattr(_ranks, "_mesh_getter", lambda device: None)
    A, b = random_problem(300, 96, np.float32, seed=44)
    case = {"inputs": [A, b],
            "steps": [("lstsq", (_ranks.Arg(0), _ranks.Arg(1)),
                       {"block_size": 32, "use_pallas": "always",
                        "device": "cpu"})],
            "weights": [np.ones(96, np.float32)]}
    [(status, result)] = _ranks.run_grads("cpu", [case])
    plan = tbl.panel_plan(300, 96, 32, True, torch.float32)
    want = sum(tbl.kernel_leaves(w, leaf) for _, w, leaf in plan if leaf)
    assert status == "ok" and tuple(result["calls"]) == (want, want) == (3, 3)
    assert tbl._panel_qr_kernel_in_place is hp._panel_qr_kernel_in_place
