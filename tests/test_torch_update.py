"""PyTorch port: ``solvers/update.py`` — ``UpdatableQR`` (the Givens append
and hyperbolic removal sweeps, the balanced split, the CSNE solve, the
refactor policy through ``guarded_qr``, the rollback on a typed refusal)
against ``dhqr_tpu.solvers.update``.

The same seeded stream runs through both packages (the port on the CPU).
Tolerances: in float64 / complex128, R within 1e-10 of the JAX package's
(relative, Frobenius) after every step, with the same ``refactored`` /
``reason`` / ``updates_since_refactor``, and ``solve`` within 1e-10; one
sweep pair within 1e-12. In float32, the sweeps keep ``R^H R`` on the
exactly-updated Gram within 5e-6, and every solve meets the reference's
8x criterion, as the JAX package's own tests hold it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu import faults as jfaults  # noqa: E402
from dhqr_tpu.solvers import update as jupdate  # noqa: E402
from dhqr_tpu.utils import config as jconfig  # noqa: E402
from dhqr_tpu.utils.testing import (  # noqa: E402
    TOLERANCE_FACTOR,
    normal_equations_residual,
    oracle_residual,
    random_problem,
)

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch import faults  # noqa: E402
from dhqr_tpu_torch.solvers import update as tupdate  # noqa: E402
from dhqr_tpu_torch.solvers.update import UpdatableQR  # noqa: E402
from dhqr_tpu_torch.utils import config as tconfig  # noqa: E402


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _positive_diag(R):
    """R with each row scaled to a positive real diagonal: R is unique up
    to those row signs (the guarded QR's R carries the Householder signs,
    a sweep's rows come out positive)."""
    d = np.diagonal(R)
    return R * (np.abs(d) / d)[:, None].conj()


def _gate(A, x, b):
    return normal_equations_residual(A, np.asarray(x), b) / \
        oracle_residual(A, b)


def _vec(rng, k, dtype, scale=1.0):
    v = rng.standard_normal(k)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(k)
    return (scale * v).astype(dtype)


def test_exports_and_defaults_match_jax():
    assert dt.UpdatableQR is UpdatableQR
    assert tupdate.DEFAULT_REFACTOR_AFTER == jupdate.DEFAULT_REFACTOR_AFTER \
        == 32
    assert tupdate.__all__ == jupdate.__all__


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sweeps_match_jax(dtype):
    rng = np.random.default_rng(11)
    A = _vec(rng, 96 * 24, dtype).reshape(96, 24)
    u, v = _vec(rng, 96, dtype), _vec(rng, 24, dtype)
    G = A.conj().T @ A
    R = np.linalg.cholesky(G).conj().T
    real = np.finfo(dtype).dtype
    for sgn in (1.0, -1.0):
        want = jupdate._update_state_impl(
            *(jnp.asarray(t) for t in (A, G, R, u, v)),
            jnp.asarray(sgn, dtype=real))
        got = tupdate.update_program()(
            *(torch.from_numpy(t) for t in (A, G, R, u, v)), sgn)
        for g, w in zip(got, want):
            assert _rel(g.numpy(), np.asarray(w)) <= 1e-12
        assert np.all(np.tril(got[2].numpy(), -1) == 0)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_givens_refresh_matches_gram_to_working_precision(dtype):
    rng = np.random.default_rng(11)
    A = torch.from_numpy(_vec(rng, 96 * 24, dtype).reshape(96, 24))
    u = torch.from_numpy(_vec(rng, 96, dtype))
    v = torch.from_numpy(_vec(rng, 24, dtype))
    G = A.mH @ A
    R = torch.linalg.cholesky(G).mH
    for sgn in (1.0, -1.0):
        A2, G2, R2 = tupdate._update_state_impl(A, G, R, u, v, sgn)
        gram = (R2.mH @ R2).numpy()
        assert _rel(gram, G2.numpy()) < 5e-6
        assert np.all(np.tril(R2.numpy(), -1) == 0)
        exact = (A2.mH @ A2).numpy()
        assert _rel(G2.numpy(), exact) < 5e-6


def _stream(pkg, A, steps, refactor_after, sites=(), dtype=np.float64):
    """Run the seeded stream; per step the provenance and R."""
    rng = np.random.default_rng(21)
    m, n = A.shape
    if pkg == "torch":
        fact = UpdatableQR(A, refactor_after=refactor_after, device="cpu")
        flt, cfg = faults, tconfig.FaultConfig
        conv = lambda t: t  # noqa: E731
        to_np = lambda t: t.numpy()  # noqa: E731
    else:
        fact = jupdate.UpdatableQR(jnp.asarray(A),
                                   refactor_after=refactor_after)
        flt, cfg = jfaults, jconfig.FaultConfig
        conv = jnp.asarray
        to_np = np.asarray
    out = []
    with flt.injected(cfg(sites=tuple(sites))):
        for step in range(steps):
            u, v = _vec(rng, m, dtype, 0.3), _vec(rng, n, dtype, 0.3)
            op = "update" if step % 2 == 0 else "downdate"
            info = getattr(fact, op)(conv(u), conv(v))
            out.append(({k: info[k] for k in ("op", "refactored", "reason",
                                              "updates_since_refactor")},
                        to_np(fact.r_matrix())))
    return fact, out


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_sixteen_step_stream_matches_jax(dtype):
    rng = np.random.default_rng(4)
    A = _vec(rng, 96 * 12, dtype).reshape(96, 12)
    sites = [("numeric.breakdown", 1.0, 1, 9)]  # one injected refactor
    mine, got = _stream("torch", A, 16, 5, sites, dtype)
    theirs, want = _stream("jax", A, 16, 5, sites, dtype)
    for (gi, gr), (wi, wr) in zip(got, want):
        assert gi == wi
        assert _rel(gr, wr) <= 1e-10
    reasons = [gi["reason"] for gi, _ in got]
    assert "threshold" in reasons and "injected_breakdown" in reasons
    assert mine.refactor_count == theirs.refactor_count
    assert mine.last_refactor["attempts"] == theirs.last_refactor["attempts"]
    b = _vec(rng, 96, dtype)
    x, xj = mine.solve(b), theirs.solve(jnp.asarray(b))
    assert _rel(x.numpy(), np.asarray(xj)) <= 1e-10
    assert mine.cond_estimate() == pytest.approx(theirs.cond_estimate(),
                                                 rel=1e-10)


def test_update_downdate_round_trip_within_gate():
    rng = np.random.default_rng(3)
    A, b = random_problem(512, 16, np.float32, seed=3)
    fact = UpdatableQR(A, device="cpu")
    R0 = fact.r_matrix().clone()
    x0 = fact.solve(b)
    assert _gate(A, x0, b) < TOLERANCE_FACTOR
    u = rng.standard_normal(512).astype(np.float32)
    v = rng.standard_normal(16).astype(np.float32)
    info = fact.update(u, v)
    assert info["op"] == "update" and info["updates_since_refactor"] == 1
    info = fact.downdate(u, v)
    assert info["op"] == "downdate" and not info["refactored"]
    x1 = fact.solve(b)
    assert _gate(A, x1, b) < TOLERANCE_FACTOR
    assert _rel(x1.numpy(), x0.numpy()) < 1e-4
    assert _rel(_positive_diag(fact.r_matrix().numpy()),
                _positive_diag(R0.numpy())) < 1e-3


def test_hyperbolic_downdate_breakdown_is_nan_loud_and_refactors():
    rng = np.random.default_rng(12)
    A = rng.standard_normal((64, 8)).astype(np.float32)
    R = torch.from_numpy(np.linalg.cholesky(A.T @ A).T.astype(np.float32))
    z = torch.from_numpy((100.0 * rng.standard_normal(8)).astype(np.float32))
    assert not torch.isfinite(tupdate._hyperbolic_remove(R, z)).all()
    fact = UpdatableQR(A, device="cpu")
    v = np.eye(8, dtype=np.float32)[0]
    info = fact.downdate(A[:, 0] * (1 - 1e-5), v)
    assert info["refactored"] and info["reason"] in ("breakdown",
                                                     "condition"), info
    col = fact.matrix[:, 0].numpy().copy()
    with pytest.raises(dt.NumericalError):
        fact.downdate(col, v)
    np.testing.assert_array_equal(fact.matrix[:, 0].numpy(), col)
    x = fact.solve(rng.standard_normal(64).astype(np.float32))
    assert torch.isfinite(x).all()
    # the JAX package takes the same branches on the same data
    jfact = jupdate.UpdatableQR(jnp.asarray(A))
    jinfo = jfact.downdate(jnp.asarray(A[:, 0] * (1 - 1e-5)),
                           jnp.asarray(v))
    assert jinfo["reason"] == info["reason"]


def test_update_stream_64_steps_within_gate():
    """64 rank-1 updates, a solve within the 8x criterion at every step,
    scheduled refactors riding the guarded ladder."""
    rng = np.random.default_rng(4)
    A, b = random_problem(384, 12, np.float32, seed=4)
    fact = UpdatableQR(A, device="cpu")
    for step in range(64):
        u = (0.1 * rng.standard_normal(384)).astype(np.float32)
        v = (0.1 * rng.standard_normal(12)).astype(np.float32)
        fact.update(u, v)
        x = fact.solve(b)
        live = fact.matrix.numpy()
        assert _gate(live, x, b) < TOLERANCE_FACTOR, step
    assert fact.refactor_count >= 3
    assert fact.last_refactor["reason"] == "threshold"


def test_refactor_policy_threshold_and_injected_breakdown():
    A, _ = random_problem(256, 8, np.float32, seed=5)
    rng = np.random.default_rng(5)
    fact = UpdatableQR(A, refactor_after=2, device="cpu")
    u = rng.standard_normal(256).astype(np.float32)
    v = rng.standard_normal(8).astype(np.float32)
    assert fact.update(u, v)["refactored"] is False
    info = fact.update(u, v)
    assert info["refactored"] and info["reason"] == "threshold"
    assert fact.last_refactor["reason"] == "threshold"
    before = tupdate.COUNTERS.get("update_breakdowns")
    with faults.injected(tconfig.FaultConfig(
            sites=(("numeric.breakdown", 1.0, 1),))):
        info = fact.update(u, v)
    assert info["refactored"] and info["reason"] == "injected_breakdown"
    assert fact.last_refactor["engine"] == "householder"
    assert tupdate.COUNTERS.get("update_breakdowns") == before + 1


def test_refactor_refuses_typed_and_rolls_back():
    A, _ = random_problem(64, 4, np.float32, seed=6)
    fact = UpdatableQR(A, refactor_after=1, device="cpu")
    before = fact.matrix.clone()
    u = -A[:, 0]
    v = np.eye(4, dtype=np.float32)[0]
    with pytest.raises(dt.IllConditioned):
        fact.update(u, v)
    assert torch.equal(fact.matrix, before)
    x = fact.solve(np.ones(64, np.float32))
    assert torch.isfinite(x).all()
    with pytest.raises(dt.NonFiniteInput):
        fact.update(np.full(64, np.nan, np.float32), v)
    with pytest.raises(dt.NonFiniteInput):
        fact.solve(np.full(64, np.inf, np.float32))


def test_refusals_match_jax():
    A, _ = random_problem(16, 4, np.float64, seed=7)
    for kw in ({"refactor_after": 0}, {"refine": -1}):
        for make in (lambda: UpdatableQR(A, device="cpu", **kw),
                     lambda: jupdate.UpdatableQR(jnp.asarray(A), **kw)):
            with pytest.raises(ValueError):
                make()
    with pytest.raises(ValueError, match="tall"):
        UpdatableQR(A.T, device="cpu")
    bad = A.copy()
    bad[1, 1] = np.nan
    with pytest.raises(dt.NonFiniteInput):
        UpdatableQR(bad, device="cpu")
    fact = UpdatableQR(A, device="cpu")
    with pytest.raises(ValueError, match="rank-1 vectors"):
        fact.update(np.ones(15), np.ones(4))
    with pytest.raises(ValueError, match="length-m"):
        fact.solve(np.ones(4))


def test_solve_program_matches_jax():
    A, b = random_problem(80, 10, np.float64, seed=8)
    R = np.linalg.cholesky(A.T @ A).T
    for refine in (0, 1, 2):
        x = tupdate.solve_program(refine)(*(torch.from_numpy(t)
                                            for t in (A, R, b)))
        xj = jupdate.solve_program(refine)(*(jnp.asarray(t)
                                             for t in (A, R, b)))
        assert _rel(x.numpy(), np.asarray(xj)) <= 1e-10
