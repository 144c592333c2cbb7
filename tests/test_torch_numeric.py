"""PyTorch port: ``dhqr_tpu_torch/numeric/`` (the NumericalError taxonomy
and the guards) against ``dhqr_tpu.numeric``.

Tolerances: the flags and the NaN pattern of a failed Cholesky are exact;
a Cholesky factor matches the JAX package's to 1e-12 (relative to its
largest entry) in float64/complex128; the condition bounds to 1e-10
(relative; the same R diagonal up to rounding); the residual ratio to
1e-9 (both are host numpy over the same x up to 1e-12).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu.numeric.guards as jg  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
import dhqr_tpu_torch.numeric.guards as tg  # noqa: E402
from dhqr_tpu.utils.testing import random_problem  # noqa: E402

ERRORS = ["NumericalError", "NonFiniteInput", "Breakdown", "IllConditioned",
          "ResidualGateFailed"]


@pytest.mark.parametrize("name", ERRORS)
def test_error_types_match_jax(name):
    tcls, jcls = getattr(dt, name), getattr(dhqr_tpu, name)
    assert [c.__name__ for c in tcls.__mro__] == \
        [c.__name__ for c in jcls.__mro__]
    kw = dict(engine="cholqr2", cond_estimate=3, attempts=[("a", 1)])
    if name == "ResidualGateFailed":
        kw["residual_ratio"] = 9
    t, j = tcls("broke", **kw), jcls("broke", **kw)
    assert isinstance(t, RuntimeError) and str(t) == str(j) == "broke"
    assert vars(t) == vars(j)
    assert isinstance(t.cond_estimate, float) and t.attempts == (("a", 1),)


def _spd(n, dtype, seed, cond=10.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        X = X + 1j * rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(X)
    d = np.logspace(0, np.log10(cond), n)
    return ((Q * d) @ Q.conj().T).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
def test_checked_cholesky_matches_jax(dtype):
    G = _spd(12, dtype, seed=1)
    L = tg.checked_cholesky(torch.from_numpy(G)).numpy()
    Lj = np.asarray(jg.checked_cholesky(jnp.asarray(G)))
    tol = 1e-12 if np.finfo(dtype).bits >= 64 else 1e-5
    np.testing.assert_allclose(L, Lj, atol=tol * np.abs(Lj).max())
    np.testing.assert_allclose(L @ L.conj().T, G, atol=10 * tol * np.abs(G).max())


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_checked_cholesky_breakdown_is_nan_not_an_exception(dtype):
    """A matrix that is not positive definite: no exception, the same
    NaN pattern as lax.linalg.cholesky (lower triangle NaN, upper zero),
    and any_nonfinite catches it; a batch fails per matrix."""
    G = _spd(8, dtype, seed=2)
    G[5, 5] = -1.0
    L = tg.checked_cholesky(torch.from_numpy(G))
    Lj = np.asarray(jg.checked_cholesky(jnp.asarray(G)))
    np.testing.assert_array_equal(np.isnan(L.numpy()), np.isnan(Lj))
    assert tg.any_nonfinite(L) and jg.any_nonfinite(Lj)
    assert np.isnan(L.numpy()).sum() == 8 * 9 // 2
    good = _spd(8, dtype, seed=3)
    batch = tg.checked_cholesky(torch.from_numpy(np.stack([G, good])))
    assert tg.any_nonfinite(batch[0]) and not tg.any_nonfinite(batch[1])


def _screen_cases():
    A, b = random_problem(30, 6, np.float32, seed=4)
    nan_a = A.copy()
    nan_a[3, 2] = np.nan
    zero = A.copy()
    zero[:, 4] = 0.0
    tiny = A.copy()
    tiny[:, 1] = 1e-25  # finite: |a|^2 underflows, the screen must pass it
    inf_b = b.copy()
    inf_b[7] = np.inf
    return {"clean": (A, b), "nan_a": (nan_a, b), "zero_col": (zero, b),
            "tiny_col": (tiny, b), "inf_b": (A, inf_b), "no_b": (A, None)}


@pytest.mark.parametrize("case", list(_screen_cases()))
def test_screen_input_matches_jax(case):
    A, b = _screen_cases()[case]
    got = tg.screen_input(A, b, device="cpu")
    want = jg.screen_input(jnp.asarray(A),
                           None if b is None else jnp.asarray(b))
    assert got == want
    assert all(isinstance(f, bool) for f in got)


def test_any_nonfinite_and_condition_bounds_match_jax():
    A, _ = random_problem(40, 12, np.float64, seed=5)
    bad = A.copy()
    bad[0, 0] = np.inf
    for arrs in ((A,), (A, bad), (bad.astype(np.complex64),)):
        assert tg.any_nonfinite(*arrs) == jg.any_nonfinite(
            *(jnp.asarray(a) for a in arrs))
    d = np.array([3.0, -0.5, 2e-3, 7.0])
    assert tg.diag_condition_bound(torch.from_numpy(d)) == pytest.approx(
        jg.diag_condition_bound(jnp.asarray(d)), rel=1e-12)
    est = tg.estimate_condition(A, device="cpu")
    assert est == pytest.approx(jg.estimate_condition(jnp.asarray(A)),
                                rel=1e-10)
    assert est <= np.linalg.cond(A) * (1 + 1e-12)  # a lower bound
    assert tg.estimate_condition(bad, device="cpu") is None
    assert jg.estimate_condition(jnp.asarray(bad)) is None


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_residual_ratio_matches_jax(dtype):
    A, b = random_problem(60, 20, dtype, seed=6)
    x = dt.lstsq(A, b, device="cpu")
    xn = x.numpy()
    got = tg.residual_ratio(torch.from_numpy(A), torch.from_numpy(b), x)
    assert got == pytest.approx(jg.residual_ratio(jnp.asarray(A),
                                                  jnp.asarray(b), xn),
                                rel=1e-9)
    assert got <= 8.0
    assert tg.residual_ratio(A, b, np.zeros_like(xn)) > 8.0
