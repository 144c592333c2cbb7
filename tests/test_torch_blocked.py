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
    assert not tbl._resolve_kernel("auto", 1024, torch.float64, cuda)
    assert not tbl._resolve_kernel("auto", 1024, torch.float32, cpu)
    assert tbl._resolve_kernel("always", 1024, torch.float32, cpu)
    assert not tbl._resolve_kernel("never", 1024, torch.float32, cuda)
    with pytest.raises(ValueError):
        tbl._resolve_kernel("always", 1024, torch.float64, cpu)
    with pytest.raises(ValueError):
        tbl._resolve_kernel("sometimes", 1024, torch.float32, cpu)
    with pytest.raises(NotImplementedError):  # NotPortedError: int32 indices
        tbl._resolve_kernel("auto", 2**27, torch.float32, cuda)


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
