"""PyTorch port: ``ops/cholqr.py`` (CholeskyQR2 / shifted CholeskyQR3) and
``lstsq(engine="cholqr2" | "cholqr3")`` against ``dhqr_tpu``.

Tolerances: float64/complex128 results match the JAX package's to 1e-10
(relative; the same passes in the same order, only BLAS summation order
differs); float32/complex64 to 1e-3 (x, forward error ~ cond(A)^2 eps_f32
through the Gram matrix at these shapes) and 1e-4 (R, relative to its
largest entry). Every solution also meets the reference's 8x criterion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu.ops import cholqr as jcq  # noqa: E402
from dhqr_tpu.utils.testing import (  # noqa: E402
    TOLERANCE_FACTOR,
    normal_equations_residual,
    oracle_residual,
    random_problem,
)
from dhqr_tpu_torch.interop import to_numpy  # noqa: E402
from dhqr_tpu_torch.numeric.guards import any_nonfinite  # noqa: E402
from dhqr_tpu_torch.ops import cholqr as tcq  # noqa: E402

X_TOL = {np.float64: 1e-10, np.complex128: 1e-10,
         np.float32: 1e-3, np.complex64: 1e-3}
R_TOL = {np.float64: 1e-10, np.complex128: 1e-10,
         np.float32: 1e-4, np.complex64: 1e-4}
FLOOR = {np.float64: 1e-12, np.complex128: 1e-12,
         np.float32: 1e-6, np.complex64: 1e-6}


def _rel(x, ref):
    return np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref)


def _criterion(A, x, b, dtype):
    res = normal_equations_residual(A, x, b)
    assert res < TOLERANCE_FACTOR * max(oracle_residual(A, b), FLOOR[dtype])


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("dtype", list(X_TOL))
def test_cholesky_qr2_matches_jax(dtype, shift):
    A, _ = random_problem(200, 24, dtype, seed=31)
    Q, R = dt.cholesky_qr2(A, shift=shift, device="cpu")
    Qj, Rj = (np.asarray(t) for t in dhqr_tpu.cholesky_qr2(jnp.asarray(A),
                                                            shift=shift))
    assert np.abs(to_numpy(R) - Rj).max() <= R_TOL[dtype] * np.abs(Rj).max()
    assert np.abs(to_numpy(Q) - Qj).max() <= 10 * R_TOL[dtype]
    q = to_numpy(Q)
    np.testing.assert_allclose(q.conj().T @ q, np.eye(24),
                               atol=100 * R_TOL[dtype])


@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("dtype", list(X_TOL))
def test_cholesky_qr_lstsq_matches_jax(dtype, refine):
    A, b = random_problem(240, 20, dtype, seed=32)
    x = to_numpy(dt.cholesky_qr_lstsq(A, b, refine=refine, device="cpu"))
    xj = np.asarray(dhqr_tpu.cholesky_qr_lstsq(jnp.asarray(A), jnp.asarray(b),
                                               refine=refine))
    assert _rel(x, xj) <= X_TOL[dtype]
    _criterion(A, x, b, dtype)


def test_multi_rhs_and_policy_surface():
    A, _ = random_problem(128, 16, np.float64, seed=33)
    B = np.random.default_rng(33).standard_normal((128, 3))
    X = to_numpy(dt.cholesky_qr_lstsq(A, B, shift=True, device="cpu"))
    np.testing.assert_allclose(X, np.linalg.lstsq(A, B, rcond=None)[0],
                               atol=1e-9)
    b = B[:, 0]
    x_fast = to_numpy(dt.cholesky_qr_lstsq(A, b, policy="fast", device="cpu"))
    xj = np.asarray(dhqr_tpu.cholesky_qr_lstsq(jnp.asarray(A), jnp.asarray(b),
                                               policy="fast"))
    assert _rel(x_fast, xj) <= 1e-10
    for mod, arr in ((dt, A), (dhqr_tpu, jnp.asarray(A))):
        kw = {"device": "cpu"} if mod is dt else {}
        with pytest.raises(ValueError, match="not both"):
            mod.cholesky_qr_lstsq(arr, b, policy="fast", refine=1, **kw)
        with pytest.raises(ValueError, match="not both"):
            mod.cholesky_qr2(arr, policy="fast", gram_precision="high", **kw)
        with pytest.raises(ValueError):
            mod.cholesky_qr2(arr[:8], **kw)  # m < n
    for dtype in (np.float32, np.float64, np.complex64):
        for shift in (False, True):
            tdtype = torch.from_numpy(np.zeros(1, dtype)).dtype
            assert tcq.cholqr_max_cond(tdtype, shift) == pytest.approx(
                jcq.cholqr_max_cond(dtype, shift), rel=1e-12)


def test_float32_gram_precisions_keep_the_window():
    """float32 with a cheaper Gram product: "high" (3 bf16 passes) stays
    within the 8x criterion after one refinement sweep; "default" (one pass)
    squares a 2^-8 rounding through the Cholesky and is only checked to be
    finite at this conditioning."""
    A, b = random_problem(256, 16, np.float32, seed=34)
    x = to_numpy(dt.cholesky_qr_lstsq(A, b, policy="balanced", device="cpu"))
    _criterion(A, x, b, np.float32)
    x = to_numpy(dt.cholesky_qr_lstsq(A, b, gram_precision="default",
                                      device="cpu"))
    assert np.isfinite(x).all()


def test_breakdown_past_the_window_is_nan():
    """cond(A) = 1e5 in float32, past CholeskyQR2's ~3e3 window: NaN, no
    exception, caught by any_nonfinite — as in the JAX package. The
    shifted CholeskyQR3 (window ~8e5) stays finite."""
    rng = np.random.default_rng(35)
    U, _ = np.linalg.qr(rng.standard_normal((256, 16)))
    V, _ = np.linalg.qr(rng.standard_normal((16, 16)))
    A = ((U * np.logspace(0, -5, 16)) @ V.T).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32)
    x = dt.cholesky_qr_lstsq(A, b, device="cpu")
    xj = dhqr_tpu.cholesky_qr_lstsq(jnp.asarray(A), jnp.asarray(b))
    assert any_nonfinite(x) and not np.isfinite(np.asarray(xj)).all()
    Q, R = dt.cholesky_qr2(A, device="cpu")
    assert any_nonfinite(Q, R)
    x3 = dt.lstsq(A, b, engine="cholqr3", device="cpu")
    assert not any_nonfinite(x3)


@pytest.mark.parametrize("engine", ["cholqr2", "cholqr3"])
@pytest.mark.parametrize("refine", [0, 2])
def test_lstsq_engine_routes_match_jax(engine, refine):
    A, b = random_problem(256, 16, np.float64, seed=36)
    x = to_numpy(dt.lstsq(A, b, engine=engine, refine=refine, device="cpu"))
    xj = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b),
                                   engine=engine, refine=refine))
    assert _rel(x, xj) <= 1e-10
    _criterion(A, x, b, np.float64)
    for bad in (dict(use_pallas="always"), dict(trailing_precision="high"),
                dict(apply_precision="high"), dict(layout="cyclic")):
        with pytest.raises(ValueError):
            dt.lstsq(A, b, engine=engine, refine=refine, device="cpu", **bad)
        with pytest.raises(ValueError):
            dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b), engine=engine,
                           refine=refine, **bad)
