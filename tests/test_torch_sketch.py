"""PyTorch port: the sketched least-squares solver against the JAX
package's ``dhqr_tpu.solvers.sketch``, on the CPU.

The operators are numpy PCG64 draws in both packages, so they are held
bit-equal. The solutions go through different float32 arithmetic (XLA's
``segment_sum`` and butterfly against ``index_add_`` and torch's, a
different Cholesky and triangular solves) and twelve CGLS iterations that
contract towards the same least-squares solution: x within 1e-4 relative
(2-norm) of the JAX solution, and within the reference's 8x criterion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu.solvers import sketch as jsk  # noqa: E402
from dhqr_tpu.utils.config import SketchConfig as JSketchConfig  # noqa: E402
from dhqr_tpu.utils.testing import oracle_residual, random_problem  # noqa: E402
from dhqr_tpu_torch.interop import sketch_config_from_fields  # noqa: E402
from dhqr_tpu_torch.solvers import sketch as tsk  # noqa: E402
from dhqr_tpu_torch.utils.config import SketchConfig  # noqa: E402
from dhqr_tpu_torch.utils.testing import normal_equations_residual  # noqa: E402

TOL_X = 1e-4


@pytest.mark.parametrize("m,s,seed", [(1000, 80, 7), (4096, 1024, 0),
                                      (777, 64, 3), (5000, 136, 12)])
def test_operators_bit_equal_to_jax(m, s, seed):
    for name in ("count_sketch_operator", "srht_operator"):
        got = getattr(tsk, name)(m, s, seed)
        want = getattr(jsk, name)(m, s, seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_sketch_rules_match_jax():
    for m, n, f in [(10_000, 16, 1.0), (10_000, 16, 2.0), (64, 16, 2.0),
                    (10_000, 2, 1.0), (4096, 64, 2.0)]:
        assert tsk.sketch_dim(m, n, f) == jsk.sketch_dim(m, n, f)
    for op, m in [("auto", 1000), ("auto", 1024), ("srht", 1000),
                  ("countsketch", 1024)]:
        assert tsk.resolve_operator(op, m) == jsk.resolve_operator(op, m)
    assert tsk.OPERATORS == jsk.OPERATORS
    assert tsk.SKETCH_DEFAULT_BLOCK == jsk.SKETCH_DEFAULT_BLOCK
    x = np.random.default_rng(40).standard_normal((64, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsk._fwht(torch.from_numpy(x)).numpy(),
                                  np.asarray(jsk._fwht(jnp.asarray(x))))


@pytest.mark.parametrize("m,n,operator", [
    (4096, 64, "countsketch"), (4096, 32, "srht"), (4000, 48, "auto")])
def test_sketched_lstsq_matches_jax(m, n, operator):
    A, b = random_problem(m, n, np.float32, seed=41)
    x = dt.sketched_lstsq(A, b, operator=operator, seed=5, device="cpu")
    x0 = np.asarray(dhqr_tpu.sketched_lstsq(jnp.asarray(A), jnp.asarray(b),
                                            operator=operator, seed=5))
    assert x.dtype == torch.float32
    rel = np.linalg.norm(x.numpy() - x0) / np.linalg.norm(x0)
    assert rel <= TOL_X, rel
    res = normal_equations_residual(A, x.numpy(), b)
    assert np.isfinite(res) and res <= 8.0 * oracle_residual(A, b)


def test_sketched_lstsq_complex64_meets_criterion():
    A, b = random_problem(2048, 32, np.complex64, seed=42)
    x = dt.sketched_lstsq(A, b, device="cpu")
    x0 = np.asarray(dhqr_tpu.sketched_lstsq(jnp.asarray(A), jnp.asarray(b)))
    assert np.linalg.norm(x.numpy() - x0) / np.linalg.norm(x0) <= TOL_X
    res = normal_equations_residual(A, x.numpy(), b)
    assert res <= 8.0 * oracle_residual(A, b)


def test_policy_and_refine_compose_as_jax():
    A, b = random_problem(2000, 24, np.float32, seed=43)
    for kw in ({"policy": "balanced"}, {"refine": 0}, {"refine": 3},
               {"s": 200, "operator": "countsketch"}):
        x = dt.sketched_lstsq(A, b, device="cpu", **kw)
        x0 = np.asarray(dhqr_tpu.sketched_lstsq(jnp.asarray(A),
                                                jnp.asarray(b), **kw))
        tol = 1e-3 if kw.get("refine") == 0 else TOL_X  # x0 alone
        assert np.linalg.norm(x.numpy() - x0) / np.linalg.norm(x0) <= tol, kw


def _message(fn, exc=ValueError):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("case", [
    "square", "wide", "vector", "b_matrix", "b_short", "s_small", "s_big",
    "operator", "refine", "policy_and_precision", "policy_and_refine"])
def test_sketched_lstsq_rejections_match_jax(case):
    A, b = random_problem(300, 20, np.float32, seed=44)
    args, kw = (A, b), {}
    if case == "square":
        args = (A[:20], b[:20])
    elif case == "wide":
        args = (A.T, b[:20])
    elif case == "vector":
        args = (A[:, 0], b)
    elif case == "b_matrix":
        args = (A, np.stack([b, b], 1))
    elif case == "b_short":
        args = (A, b[:-1])
    elif case == "s_small":
        kw = {"s": 20}
    elif case == "s_big":
        kw = {"s": 301}
    elif case == "operator":
        kw = {"operator": "gaussian"}
    elif case == "refine":
        kw = {"refine": -1}
    elif case == "policy_and_precision":
        kw = {"policy": "accurate", "precision": "high"}
    else:
        kw = {"policy": "accurate", "refine": 2}
    want = _message(lambda: dhqr_tpu.sketched_lstsq(
        *(jnp.asarray(a) for a in args), **kw))
    got = _message(lambda: dt.sketched_lstsq(*args, device="cpu", **kw))
    if case in ("vector", "b_matrix", "b_short", "square", "wide"):
        # the same sentence; shapes print as tuples here, as JAX's shapes do
        assert got.split("(")[0] == want.split("(")[0]
    else:
        assert got == want


def test_sketch_config_from_env_matches_jax(monkeypatch):
    env = {"DHQR_SKETCH_SEED": "9", "DHQR_SKETCH_OPERATOR": " SRHT ",
           "DHQR_SKETCH_FACTOR": "3.5", "DHQR_SKETCH_REFINE": "4",
           "DHQR_SKETCH_MIN_ASPECT": "16"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = SketchConfig.from_env(), JSketchConfig.from_env()
    assert got == SketchConfig(seed=9, operator="srht", factor=3.5,
                               refine=4, min_aspect=16.0)
    import dataclasses

    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert sketch_config_from_fields(**dataclasses.asdict(want)) == got
    assert SketchConfig.from_env(refine=1).refine == 1
    for bad in ({"operator": "x"}, {"factor": 0}, {"refine": -1},
                {"min_aspect": 0.5}):
        assert _message(lambda: SketchConfig(**bad)) == \
            _message(lambda: JSketchConfig(**bad))


def test_lstsq_engine_sketch_routes_to_sketched_lstsq(monkeypatch):
    A, b = random_problem(3000, 40, np.float32, seed=45)
    monkeypatch.setenv("DHQR_SKETCH_SEED", "3")
    x = dt.lstsq(A, b, engine="sketch", device="cpu")
    want = dt.sketched_lstsq(A, b, SketchConfig.from_env(), device="cpu")
    assert torch.equal(x, want)
    x2 = dt.lstsq(A, b, engine="sketch", refine=2, device="cpu")
    want2 = dt.sketched_lstsq(A, b, seed=3, refine=14, device="cpu")
    assert torch.equal(x2, want2)
    x0 = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b),
                                   engine="sketch"))
    assert np.linalg.norm(x.numpy() - x0) / np.linalg.norm(x0) <= TOL_X


def test_operator_draws_once_per_tuple():
    A, b = random_problem(1500, 16, np.float32, seed=46)
    draws = tsk.COUNTERS.get("sketch_operator_draws")
    calls = tsk.COUNTERS.get("sketch_calls")
    dt.sketched_lstsq(A, b, seed=123457, device="cpu")
    dt.sketched_lstsq(A, b, seed=123457, device="cpu")
    assert tsk.COUNTERS.get("sketch_operator_draws") == draws + 1
    dt.sketched_lstsq(A, b, seed=123458, device="cpu")
    assert tsk.COUNTERS.get("sketch_operator_draws") == draws + 2
    assert tsk.COUNTERS.get("sketch_calls") == calls + 3


@pytest.mark.parametrize("kw", [
    {"use_pallas": "always"}, {"panel_impl": "recursive"},
    {"lookahead": True}, {"agg_panels": 2}, {"blocked": False},
    {"apply_precision": "high"}, {"layout": "cyclic"}])
def test_lstsq_engine_sketch_rejections_match_jax(kw):
    A, b = random_problem(300, 20, np.float32, seed=47)
    want = _message(lambda: dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b),
                                           engine="sketch", **kw))
    got = _message(lambda: dt.lstsq(A, b, engine="sketch", device="cpu",
                                    **kw))
    assert got.split("(")[0] == want.split("(")[0]


def test_sketch_is_lstsq_only_and_tall_only():
    A, b = random_problem(300, 20, np.float32, seed=48)
    with pytest.raises(ValueError, match="lstsq-only"):
        dt.qr(A, engine="sketch", device="cpu")
    with pytest.raises(ValueError, match="m < n"):
        dt.lstsq(A.T, b[:20], engine="sketch", device="cpu")
