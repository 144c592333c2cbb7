"""PyTorch port: the public API (qr / solve / lstsq / QRFactorization)
against ``dhqr_tpu`` on the same inputs.

Two oracles per case: the reference's 8x normal-equations criterion
against LAPACK (``dhqr_tpu.utils.testing``), and the JAX package's own x:
||x_port - x_jax|| / ||x_jax|| <= 1e-10 for float64/complex128 (same
algorithm, double precision) and <= 1e-3 for float32/complex64 (the
forward error of an f32 solve is ~cond(A) * eps_f32, and cond(A) of
``random_problem`` at these shapes is ~1e2-1e3).
"""

import dataclasses

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
from dhqr_tpu_torch.interop import (  # noqa: E402
    config_from_fields,
    factorization_from_numpy,
    to_numpy,
)

FWD_TOL = {np.float64: 1e-10, np.complex128: 1e-10,
           np.float32: 1e-3, np.complex64: 1e-3}
FLOOR = {np.float64: 1e-12, np.complex128: 1e-12,
         np.float32: 1e-6, np.complex64: 1e-6}
DTYPES = list(FWD_TOL)


def _rel(x, ref):
    ref = np.asarray(ref)
    return np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref)


def _criterion(A, x, b, dtype):
    res = normal_equations_residual(A, x, b)
    assert res < TOLERANCE_FACTOR * max(oracle_residual(A, b), FLOOR[dtype]), res


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(110, 100), (440, 400)])
def test_qr_solve_and_lstsq_match_jax(shape, dtype):
    A, b = random_problem(*shape, dtype, seed=shape[0] + 1)
    fact = dt.qr(A, device="cpu")
    x = to_numpy(fact.solve(b))
    x2 = to_numpy(dt.lstsq(A, b, device="cpu"))
    np.testing.assert_array_equal(x, x2)  # the same operations in order
    _criterion(A, x, b, dtype)
    xj = np.asarray(dhqr_tpu.qr(jnp.asarray(A)).solve(jnp.asarray(b)))
    assert _rel(x, xj) <= FWD_TOL[dtype]
    xj2 = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b)))
    assert _rel(x2, xj2) <= FWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_unblocked_engine_matches_jax(dtype):
    A, b = random_problem(88, 80, dtype, seed=22)
    x = to_numpy(dt.lstsq(A, b, blocked=False, device="cpu"))
    _criterion(A, x, b, dtype)
    xj = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b),
                                   blocked=False))
    assert _rel(x, xj) <= FWD_TOL[dtype]
    fact = dt.qr(A, blocked=False, device="cpu")
    factj = dhqr_tpu.qr(jnp.asarray(A), blocked=False)
    np.testing.assert_allclose(to_numpy(fact.H), np.asarray(factj.H),
                               atol=1e-3 if dtype == np.complex64 else 1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_minimum_norm_matches_jax(dtype):
    A, b = random_problem(40, 60, dtype, seed=23)
    x = to_numpy(dt.lstsq(A, b, device="cpu"))
    xj = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b)))
    assert _rel(x, xj) <= 1e-10
    np.testing.assert_allclose(A @ x, b, atol=1e-10)  # exact solve
    x_pinv = np.linalg.pinv(A) @ b  # the minimum-norm solution
    assert _rel(x, x_pinv) <= 1e-10


def test_refine_one_sweep_matches_jax():
    A, b = random_problem(220, 200, np.float32, seed=24)
    x = to_numpy(dt.lstsq(A, b, refine=1, device="cpu"))
    _criterion(A, x, b, np.float32)
    xj = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b), refine=1))
    assert _rel(x, xj) <= FWD_TOL[np.float32]
    with pytest.raises(ValueError):
        dt.lstsq(A, b, refine=-1, device="cpu")
    with pytest.raises(ValueError):
        dt.qr(A, refine=1, device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex64])
def test_factorizations_cross_between_packages(dtype):
    """A JAX-made (H, alpha) solves in the port like in JAX, and the port's
    (H, alpha) solves in JAX like in the port: the packed storage is the
    same on both sides."""
    A, b = random_problem(130, 96, dtype, seed=25)
    fj = dhqr_tpu.qr(jnp.asarray(A), block_size=32)
    ft = factorization_from_numpy(np.asarray(fj.H), np.asarray(fj.alpha),
                                  block_size=32, device="cpu")
    xj = np.asarray(fj.solve(jnp.asarray(b)))
    assert _rel(to_numpy(ft.solve(b)), xj) <= FWD_TOL[dtype] / 100
    mine = dt.qr(A, block_size=32, device="cpu")
    back = dhqr_tpu.QRFactorization(jnp.asarray(to_numpy(mine.H)),
                                    jnp.asarray(to_numpy(mine.alpha)),
                                    block_size=32)
    assert _rel(np.asarray(back.solve(jnp.asarray(b))),
                to_numpy(mine.solve(b))) <= FWD_TOL[dtype] / 100


def test_factorization_methods_match_jax():
    A, b = random_problem(120, 90, np.float64, seed=26)
    fact = dt.qr(A, block_size=32, device="cpu")
    fj = dhqr_tpu.qr(jnp.asarray(A), block_size=32)
    np.testing.assert_allclose(to_numpy(fact.r_matrix()),
                               np.asarray(fj.r_matrix()), atol=1e-12)
    np.testing.assert_allclose(to_numpy(fact.q_columns()),
                               np.asarray(fj.q_columns()), atol=1e-12)
    np.testing.assert_allclose(to_numpy(fact.matmul_qt(b)),
                               np.asarray(fj.matmul_qt(jnp.asarray(b))),
                               atol=1e-12)
    B = np.random.default_rng(2).random((120, 3))
    np.testing.assert_allclose(to_numpy(fact.matmul_q(B)),
                               np.asarray(fj.matmul_q(jnp.asarray(B))),
                               atol=1e-12)
    assert float(fact.condition_estimate()) == pytest.approx(
        float(fj.condition_estimate()), rel=1e-12)
    assert int(fact.rank()) == int(fj.rank()) == 90
    X = to_numpy(dt.solve(fact, B))
    np.testing.assert_allclose(X, np.asarray(fj.solve(jnp.asarray(B))),
                               atol=1e-10)
    assert fact.shape == (120, 90) and fact.H.device.type == "cpu"


def test_solve_refine_needs_the_matrix():
    A, b = random_problem(60, 40, np.float64, seed=27)
    fact = dt.qr(A, device="cpu")
    with pytest.raises(ValueError):
        fact.solve(b, refine=1)
    fact.matrix = torch.from_numpy(A)
    x = to_numpy(fact.solve(b, refine=1))
    _criterion(A, x, b, np.float64)


UNPORTED = [
    {"plan": "auto"},
]

# Knobs that raised NotPortedError until the precision policies, the
# tall-skinny engines, the schedules, the reconstruct panel engine, the
# sketched solver, the guarded ladder and the compressed wire were ported;
# each now runs (a wire format is the mesh's: one device ignores it, as
# the JAX package does).
PORTED = [
    {"policy": "accurate"}, {"engine": "tsqr"}, {"engine": "cholqr2"},
    {"precision": "default"}, {"precision": "high"},
    {"trailing_precision": "high"}, {"apply_precision": "high"},
    {"engine": "sketch"}, {"lookahead": True}, {"agg_panels": 2},
    {"panel_impl": "reconstruct"}, {"panel_impl": "reconstruct:64"},
    {"guards": "screen"}, {"guards": "fallback"}, {"guards": "full"},
    {"comms": "bf16"},
]


@pytest.mark.parametrize("entry", ["qr", "lstsq"])
@pytest.mark.parametrize("knob", PORTED, ids=lambda d: "-".join(
    f"{k}={v}" for k, v in d.items()))
def test_ported_knobs_run_and_match_jax(entry, knob):
    """float64, where every precision name is full precision on both
    sides: the port's x matches the JAX package's within 1e-10 (relative),
    and the 8x criterion holds. qr() refuses the lstsq-only engines with
    the JAX package's ValueError."""
    A, b = random_problem(96, 24, np.float64, seed=28)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    if entry == "qr":
        if "engine" in knob:
            with pytest.raises(ValueError, match="lstsq-only"):
                dt.qr(A, device="cpu", **knob)
            with pytest.raises(ValueError):
                dhqr_tpu.qr(Aj, **knob)
            return
        x = to_numpy(dt.qr(A, block_size=16, device="cpu", **knob).solve(b))
        xj = np.asarray(dhqr_tpu.qr(Aj, block_size=16, **knob).solve(bj))
    else:
        x = to_numpy(dt.lstsq(A, b, block_size=16, device="cpu", **knob))
        xj = np.asarray(dhqr_tpu.lstsq(Aj, bj, block_size=16, **knob))
    assert _rel(x, xj) <= 1e-10
    if knob.get("engine") != "sketch":  # 12 CGLS sweeps from a 96-row
        # sketch stop short of f64 LAPACK on both sides; its 8x bar is
        # held in float32 (tests/test_torch_sketch.py)
        _criterion(A, x, b, np.float64)


@pytest.mark.parametrize("entry", ["qr", "lstsq"])
@pytest.mark.parametrize("knob", UNPORTED, ids=lambda d: "-".join(
    f"{k}={v}" for k, v in d.items()))
def test_unported_knobs_raise_not_implemented(entry, knob):
    A, b = random_problem(40, 30, np.float32, seed=28)
    call = (lambda **kw: dt.qr(A, device="cpu", **kw)) if entry == "qr" \
        else (lambda **kw: dt.lstsq(A, b, device="cpu", **kw))
    with pytest.raises(NotImplementedError) as info:
        call(**knob)
    assert "ROADMAP.md" in str(info.value)
    assert isinstance(info.value, dt.NotPortedError)


def test_mesh_and_bad_values():
    # mesh= takes the port's ColumnMesh (the mesh tier itself runs in
    # tests/test_torch_sharded*.py, on gloo process groups)
    A, b = random_problem(40, 30, np.float32, seed=29)
    with pytest.raises(TypeError, match="ColumnMesh"):
        dt.qr(A, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="ColumnMesh"):
        dt.lstsq(A, b, mesh=object(), device="cpu")
    for bad in ({"engine": "magic"}, {"norm": "sloppy"},
                {"use_pallas": "maybe"}, {"panel_impl": "nope"},
                {"blocked": False, "panel_impl": "recursive"}):
        with pytest.raises(ValueError):
            dt.qr(A, device="cpu", **bad)
    with pytest.raises(ValueError):
        dt.qr(A, blocked=False, use_pallas="always", device="cpu")
    with pytest.raises(ValueError):
        dt.qr(A, blocked=False, donate=True, device="cpu")
    # overlap_depth is mesh-only: a ValueError on one device, as in JAX;
    # on a mesh it runs the depth-k pipeline (tests/test_torch_pipeline.py)
    with pytest.raises(ValueError, match="mesh-only"):
        dt.qr(A, device="cpu", overlap_depth=2, lookahead=True)
    with pytest.raises(TypeError, match="ColumnMesh"):
        dt.qr(A, device="cpu", overlap_depth=2, lookahead=True,
              mesh=object())


def test_config_mirrors_the_jax_config(monkeypatch):
    """Same fields, same defaults; a config built from the JAX one's field
    values is the port's default config."""
    jfields = {f.name: f.default for f in dataclasses.fields(
        dhqr_tpu.utils.config.DHQRConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(dt.DHQRConfig)}
    assert jfields == tfields
    jcfg = dhqr_tpu.utils.config.DHQRConfig()
    assert config_from_fields(**dataclasses.asdict(jcfg)) == dt.DHQRConfig()
    monkeypatch.setenv("DHQR_BLOCK_SIZE", "64")
    monkeypatch.setenv("DHQR_BLOCKED", "0")
    monkeypatch.setenv("DHQR_USE_PALLAS", "never")
    monkeypatch.setenv("DHQR_NORM", "fast")
    monkeypatch.setenv("DHQR_REFINE", "2")
    cfg = dt.DHQRConfig.from_env(panel_impl="loop")
    assert (cfg.block_size, cfg.blocked, cfg.use_pallas, cfg.norm,
            cfg.refine) == (64, False, "never", "fast", 2)
    jenv = dhqr_tpu.utils.config.DHQRConfig.from_env(panel_impl="loop")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jenv)


def test_config_object_and_norm_fast():
    A, b = random_problem(150, 120, np.float64, seed=30)
    cfg = dt.DHQRConfig(block_size=32, norm="fast")
    x = to_numpy(dt.lstsq(A, b, config=cfg, device="cpu"))
    _criterion(A, x, b, np.float64)
    fact = dt.qr(A, config=cfg, panel_impl="recursive", device="cpu")
    assert fact.block_size == 32
    _criterion(A, to_numpy(fact.solve(b)), b, np.float64)
