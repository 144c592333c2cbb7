"""PyTorch port: ``ops/tsqr.py`` and ``lstsq(engine="tsqr")`` against
``dhqr_tpu``.

Tolerances: float64/complex128 x and R match the JAX package's to 1e-10
(relative; the same leaves, combine and signs); float32/complex64 within
rtol 2e-4 / atol 2e-5 (x) and 2e-4 of ||R|| — the bounds the JAX
package's own test holds its kernel leaves to — for both the plain panel
engine (``use_pallas="never"``) and the kernel route (``"always"``: the
kernel's plain version on the CPU, Pallas in interpret mode on the JAX
side). Every x meets the reference's 8x criterion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu.utils.testing import (  # noqa: E402
    TOLERANCE_FACTOR,
    normal_equations_residual,
    oracle_residual,
    random_problem,
)
from dhqr_tpu_torch.interop import to_numpy  # noqa: E402
from dhqr_tpu_torch.ops import blocked, tsqr  # noqa: E402


def _rel(x, ref):
    return np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n_blocks", [2, 8])
def test_tsqr_lstsq_matches_jax(dtype, n_blocks):
    A, b = random_problem(256, 16, dtype, seed=21)
    x = to_numpy(dt.tsqr_lstsq(A, b, n_blocks=n_blocks, block_size=8,
                               device="cpu"))
    xj = np.asarray(dhqr_tpu.tsqr_lstsq(jnp.asarray(A), jnp.asarray(b),
                                        n_blocks=n_blocks, block_size=8))
    assert _rel(x, xj) <= 1e-10
    assert normal_equations_residual(A, x, b) < \
        TOLERANCE_FACTOR * oracle_residual(A, b)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_tsqr_r_matches_jax_and_the_gram_identity(dtype):
    A, _ = random_problem(320, 20, dtype, seed=23)
    R = to_numpy(dt.tsqr_r(A, n_blocks=4, block_size=8, device="cpu"))
    Rj = np.asarray(dhqr_tpu.tsqr_r(jnp.asarray(A), n_blocks=4, block_size=8))
    np.testing.assert_allclose(R, Rj, atol=1e-10 * np.abs(Rj).max())
    G = A.conj().T @ A
    np.testing.assert_allclose(R.conj().T @ R, G, rtol=1e-9,
                               atol=1e-9 * np.linalg.norm(G))


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_kernel_leaves_match_jax(dtype, fresh_compile_state):
    A, b = random_problem(256, 16, dtype, seed=24)
    for mode in ("never", "always"):
        x = to_numpy(dt.tsqr_lstsq(A, b, n_blocks=4, use_pallas=mode,
                                   device="cpu"))
        xj = np.asarray(dhqr_tpu.tsqr_lstsq(jnp.asarray(A), jnp.asarray(b),
                                            n_blocks=4, use_pallas=mode))
        np.testing.assert_allclose(x, xj, rtol=2e-4, atol=2e-5)
        R = to_numpy(dt.tsqr_r(A, n_blocks=4, use_pallas=mode, device="cpu"))
        Rj = np.asarray(dhqr_tpu.tsqr_r(jnp.asarray(A), n_blocks=4,
                                        use_pallas=mode))
        np.testing.assert_allclose(R, Rj, rtol=2e-4,
                                   atol=2e-4 * np.linalg.norm(Rj))


def test_kernel_leaf_calls_follow_the_panel_plans(monkeypatch):
    """With the kernel route, the panel wrapper is called exactly as often
    as the port's own plan predicts for the leaves and the combine (the
    count chip_smoke.py holds the card's launches to)."""
    calls = []
    real = blocked._panel_qr_kernel

    def counting(panel, offset):
        calls.append(panel.shape)
        return real(panel, offset)

    monkeypatch.setattr(blocked, "_panel_qr_kernel", counting)
    A, b = random_problem(1024, 48, np.float32, seed=25)
    x = to_numpy(dt.tsqr_lstsq(A, b, n_blocks=4, block_size=32,
                               use_pallas="always", device="cpu"))
    plans = tsqr.tsqr_panel_plans(1024, 48, 4, 32, True, torch.float32)
    want = sum(count * sum(blocked.kernel_leaves(w, leaf)
                           for _, w, leaf in plan if leaf)
               for plan, count in plans)
    assert len(calls) == want == 4 * 2 + 2
    assert [plan[0] for plan, _ in plans] == [(0, 32, 128), (0, 32, 128)]
    assert normal_equations_residual(A, x, b) < \
        TOLERANCE_FACTOR * oracle_residual(A, b)


def test_shape_checks_multi_rhs_and_policy():
    A = np.zeros((100, 10))
    for mod, arr in ((dt, A), (dhqr_tpu, jnp.asarray(A))):
        kw = {"device": "cpu"} if mod is dt else {}
        with pytest.raises(ValueError):
            mod.tsqr_lstsq(arr, arr[:, 0], n_blocks=3, **kw)  # 100 % 3
        with pytest.raises(ValueError):
            mod.tsqr_lstsq(arr, arr[:, 0], n_blocks=16, **kw)  # 100/16 < 10
        with pytest.raises(ValueError, match="refine"):
            mod.tsqr_lstsq(arr, arr[:, 0], n_blocks=4, policy="fast", **kw)
    rng = np.random.default_rng(21)
    A = rng.standard_normal((256, 16))
    B = rng.standard_normal((256, 3))
    X = to_numpy(dt.tsqr_lstsq(A, B, n_blocks=4, device="cpu"))
    np.testing.assert_allclose(X, np.linalg.lstsq(A, B, rcond=None)[0],
                               atol=1e-9)
    b = B[:, 0]
    x0 = to_numpy(dt.tsqr_lstsq(A, b, n_blocks=4, block_size=8, device="cpu"))
    x1 = to_numpy(dt.tsqr_lstsq(A, b, n_blocks=4, block_size=8, device="cpu",
                                policy=dt.PrecisionPolicy(trailing="high")))
    np.testing.assert_allclose(x1, x0, rtol=1e-12, atol=1e-14)  # f64: same math


@pytest.mark.parametrize("shape", [(256, 24), (300, 40), (96, 64)])
def test_lstsq_engine_tsqr_matches_jax(shape):
    """The router's n_blocks rule (at most 8, each block tall, dividing m)
    gives the JAX package's tree; refine and qr() refuse tsqr as there."""
    A, b = random_problem(*shape, np.float64, seed=26)
    x = to_numpy(dt.lstsq(A, b, engine="tsqr", device="cpu"))
    xj = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b),
                                   engine="tsqr"))
    assert _rel(x, xj) <= 1e-10
    with pytest.raises(ValueError, match="tsqr"):
        dt.lstsq(A, b, engine="tsqr", refine=1, device="cpu")
    with pytest.raises(ValueError, match="lstsq-only"):
        dt.qr(A, engine="tsqr", device="cpu")
