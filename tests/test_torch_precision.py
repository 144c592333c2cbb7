"""PyTorch port: precision policies (``dhqr_tpu_torch/precision.py``), the
bf16 passes of ``ops/gemm.py`` and the policy-split engines, against
``dhqr_tpu.precision`` and the JAX engines.

Tolerances: policy parsing is exact (the same dataclass fields). A bf16
pass's error against the float64 product is bounded elementwise by
``(c + 2 k u32) (|A| |B|)``, with c = 2^-7 for one pass (each operand
rounded to 8 bits) and 4 * 2^-16 for three (the dropped a_lo b_lo and the
rounding of the low parts), k the inner dimension and u32 = 2^-24 the f32
accumulation. In float64 every precision name is full precision, so the
port matches the JAX package to 1e-10 there.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu.precision as jprec  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
import dhqr_tpu_torch.precision as tprec  # noqa: E402
from dhqr_tpu.utils.testing import (  # noqa: E402
    TOLERANCE_FACTOR,
    normal_equations_residual,
    oracle_residual,
    random_problem,
)
from dhqr_tpu_torch.interop import config_from_fields, to_numpy  # noqa: E402
from dhqr_tpu_torch.ops import gemm  # noqa: E402

# Every spelling tests/test_precision.py resolves, and the wire segments.
SPECS = ["accurate", "balanced", "fast", "highest/default/r2",
         "highest/highest", "high", "highest/high/r1", "default/high",
         "float32", "highest/default/r1/bf16", "highest/bf16",
         "highest/dcn:bf16", "high/r3"]
BAD_SPECS = [("warp9", ValueError, "must be one of"),
             ("highest/high/default/r1", ValueError, "unknown policy"),
             ("", ValueError, "unknown policy"),
             (3, TypeError, "policy must be")]


def _fields(pol):
    return dataclasses.asdict(pol)


@pytest.mark.parametrize("spec", SPECS)
def test_spec_strings_resolve_like_jax(spec):
    assert _fields(tprec.resolve_policy(spec)) == _fields(
        jprec.resolve_policy(spec))


@pytest.mark.parametrize("spec,exc,match", BAD_SPECS)
def test_bad_specs_raise_like_jax(spec, exc, match):
    for module in (tprec, jprec):
        with pytest.raises(exc, match=match):
            module.resolve_policy(spec)


def test_presets_ladder_and_constants_match_jax():
    assert {k: _fields(v) for k, v in tprec.PRECISION_POLICIES.items()} == \
        {k: _fields(v) for k, v in jprec.PRECISION_POLICIES.items()}
    assert [_fields(p) for p in tprec.POLICY_LADDER] == \
        [_fields(p) for p in jprec.POLICY_LADDER]
    for name in ("TRAILING_PRECISIONS", "MXU_PASSES", "COMMS_MODES",
                 "WIRE_ITEMSIZE"):
        assert getattr(tprec, name) == getattr(jprec, name), name
    for comms in (None, "none", "f32", "bf16", "dcn:int8"):
        assert tprec.resolve_comms(comms) == jprec.resolve_comms(comms)
    for module in (tprec, jprec):
        with pytest.raises(ValueError, match="comms must be"):
            module.resolve_comms("fp8")
        with pytest.raises(ValueError, match="PrecisionPolicy.trailing"):
            module.PrecisionPolicy(trailing="bf16")
        with pytest.raises(ValueError, match="refine must be"):
            module.PrecisionPolicy(refine=-1)
    pol = tprec.PrecisionPolicy(trailing="high")
    assert tprec.resolve_policy(pol) is pol
    assert tprec.resolve_policy("balanced") is \
        tprec.PRECISION_POLICIES["balanced"]


def test_factor_args_merge_escalation_and_comms_arg_match_jax():
    for args in ((None, "high", "default"), ("fast", "highest", None),
                 ("accurate", "highest", None), ("highest/high", "highest",
                                                 None)):
        assert tprec.apply_policy_to_factor_args(*args) == \
            jprec.apply_policy_to_factor_args(*args)
    for module in (tprec, jprec):
        with pytest.raises(ValueError, match="not both"):
            module.apply_policy_to_factor_args("fast", "highest", "high")
        with pytest.raises(ValueError, match="not both"):
            module.apply_policy_to_factor_args("fast", "high", None)
        with pytest.raises(ValueError, match="not both"):
            module.apply_policy_to_comms_arg("highest/bf16", "int8")
    for pol in (None, "fast", "accurate", "highest/default/r2",
                tprec.PrecisionPolicy(apply="high")):
        jpol = jprec.PrecisionPolicy(**_fields(pol)) \
            if isinstance(pol, tprec.PrecisionPolicy) else pol
        assert [_fields(p) for p in tprec.escalation_policies(pol)] == \
            [_fields(p) for p in jprec.escalation_policies(jpol)]
    assert tprec.apply_policy_to_comms_arg("highest/bf16", None) == "bf16"
    assert tprec.apply_policy_to_comms_arg(None, "f32") is None


def _rand(shape, dtype, rng):
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_bf16_passes_within_their_rounding_bounds(dtype):
    """The plain passes (CPU tensors): "high" is closer to the float64
    product than "default", each inside its elementwise bound, both in
    f32; matmul with a vector operand and addmm agree with the matrix
    form."""
    rng = np.random.default_rng(11)
    k = 200
    a, b = _rand((48, k), dtype, rng), _rand((k, 40), dtype, rng)
    wide = torch.complex128 if a.is_complex() else torch.float64
    exact = a.to(wide) @ b.to(wide)
    # |A||B| of the real embedding bounds every real and imaginary part
    scale = (a.abs().double() @ b.abs().double()) * (2 if a.is_complex()
                                                     else 1)
    errs = {}
    for prec, c in (("high", 4 * 2.0 ** -16), ("default", 2.0 ** -7)):
        got = gemm.matmul(a, b, prec)
        assert got.dtype == a.dtype
        diff = (got.to(wide) - exact).abs()
        assert bool((diff <= (c + 2 * k * 2.0 ** -24) * scale).all()), prec
        errs[prec] = float(diff.max())
        v = a[3].clone()
        torch.testing.assert_close(gemm.matmul(v, b, prec),
                                   gemm.matmul(v[None], b, prec)[0])
        c0 = _rand((48, 40), dtype, rng)
        out = gemm.addmm(c0, a, b, prec, alpha=-1)
        assert not torch.equal(out, c0)
        torch.testing.assert_close(out, c0 - got, rtol=1e-5, atol=1e-4)
        inplace = c0.clone()
        gemm.addmm(inplace[:, 5:], a, b[:, 5:], prec, inplace=True)
        assert torch.equal(inplace[:, :5], c0[:, :5])
        torch.testing.assert_close(inplace[:, 5:], out[:, 5:], rtol=1e-5,
                                   atol=1e-4)
    assert errs["high"] < errs["default"] / 50
    full = gemm.matmul(a, b, "highest")
    assert torch.equal(full, torch.matmul(a, b))


def test_double_precision_ignores_the_names():
    rng = np.random.default_rng(12)
    a, b = _rand((20, 30), np.float64, rng), _rand((30, 10), np.float64, rng)
    for prec in ("high", "default"):
        assert torch.equal(gemm.matmul(a, b, prec), torch.matmul(a, b))
    with pytest.raises(ValueError, match="precision must be"):
        gemm.matmul(a, b, "tf32")


def _backward_error(fact, A):
    QR = fact.matmul_q(torch.cat([fact.r_matrix(), fact.H.new_zeros(
        (fact.shape[0] - fact.shape[1], fact.shape[1]))]))
    At = torch.from_numpy(A)
    return float(torch.linalg.norm(QR - At) / torch.linalg.norm(At))


def test_trailing_precision_backward_error_is_ordered():
    """float32 256 x 64, 16-wide panels (four panels, three trailing
    updates): ||QR - A|| / ||A|| is ordered highest <= high <= default, and
    "default" stays inside 1e-2."""
    A, _ = random_problem(256, 64, np.float32, seed=13)
    err = {t: _backward_error(dt.qr(A, block_size=16, trailing_precision=t,
                                    device="cpu"), A)
           for t in ("highest", "high", "default")}
    assert err["highest"] <= err["high"] <= err["default"] < 1e-2, err
    assert err["highest"] < 1e-5


def _residual(A, x, b):
    return normal_equations_residual(A, x, b)


def test_balanced_meets_the_criterion_and_matches_jax():
    """float32 300 x 64: ``balanced`` (3 bf16 passes + one sweep) within
    8x of LAPACK, and within 1e-3 (relative) of the JAX package's x, which
    computes every name in full f32 on the CPU."""
    A, b = random_problem(300, 64, np.float32, seed=14)
    x = to_numpy(dt.lstsq(A, b, block_size=16, policy="balanced",
                          device="cpu"))
    assert _residual(A, x, b) < TOLERANCE_FACTOR * oracle_residual(A, b)
    xj = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b),
                                   block_size=16, policy="balanced"))
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-3


def test_fast_refinement_sweep_lowers_the_residual():
    """float32 300 x 64 with 16-wide panels: ``fast`` factors with one
    bf16 pass per trailing GEMM; its one refinement sweep must lower the
    normal-equations residual of the unrefined solve. Measured on the CPU
    at this shape: from 2241x to 300x the LAPACK oracle's (a second sweep:
    298x). On an inconsistent system plain refinement stops at the fixed
    point of the perturbed factorization, ~||E|| ||r||, so a bf16
    factorization does not reach 8x this way; the JAX package never
    measured ``fast`` off the TPU."""
    A, b = random_problem(300, 64, np.float32, seed=14)
    x0 = to_numpy(dt.lstsq(A, b, block_size=16, policy="highest/default",
                           device="cpu"))
    x1 = to_numpy(dt.lstsq(A, b, block_size=16, policy="fast", device="cpu"))
    assert np.isfinite(x1).all()
    assert _residual(A, x1, b) < _residual(A, x0, b)


def test_policy_config_exclusivity_env_and_donate(monkeypatch):
    A, b = random_problem(48, 32, np.float64, seed=7)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    for bad in (dict(trailing_precision="high"), dict(refine=1),
                dict(precision="high"), dict(apply_precision="high")):
        with pytest.raises(ValueError, match="not both"):
            dt.lstsq(A, b, block_size=16, policy="fast", device="cpu", **bad)
        with pytest.raises(ValueError, match="not both"):
            dt.qr(A, block_size=16, policy="fast", device="cpu", **bad)
        with pytest.raises(ValueError, match="not both"):
            dhqr_tpu.lstsq(Aj, bj, block_size=16, policy="fast", **bad)
    with pytest.raises(ValueError, match="donate"):
        dt.qr(A, block_size=16, policy="fast", donate=True, device="cpu")
    monkeypatch.setenv("DHQR_POLICY", "highest/high/r1")
    monkeypatch.setenv("DHQR_TRAILING_PRECISION", "default")
    monkeypatch.setenv("DHQR_APPLY_PRECISION", "high")
    cfg = dt.DHQRConfig.from_env()
    jcfg = dhqr_tpu.DHQRConfig.from_env()
    assert (cfg.policy, cfg.trailing_precision, cfg.apply_precision) == (
        jcfg.policy, jcfg.trailing_precision, jcfg.apply_precision) == (
        "highest/high/r1", "default", "high")
    monkeypatch.delenv("DHQR_TRAILING_PRECISION")
    monkeypatch.delenv("DHQR_APPLY_PRECISION")
    cfg = dt.DHQRConfig.from_env()
    x = to_numpy(dt.lstsq(A, b, config=cfg, block_size=16, device="cpu"))
    xj = np.asarray(dhqr_tpu.lstsq(Aj, bj, config=dhqr_tpu.DHQRConfig.from_env(),
                                   block_size=16))
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-12)
    # a JAX config carrying a PrecisionPolicy object crosses to the port
    jcfg = dhqr_tpu.DHQRConfig(policy=jprec.PrecisionPolicy(trailing="high",
                                                            refine=1))
    port = config_from_fields(**dataclasses.asdict(jcfg))
    assert port.policy == tprec.PrecisionPolicy(trailing="high", refine=1)


def test_qr_policy_records_the_solve_fields_like_jax():
    A, b = random_problem(64, 48, np.float64, seed=8)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    fact = dt.qr(A, block_size=16, policy="balanced", device="cpu")
    fj = dhqr_tpu.qr(Aj, block_size=16, policy="balanced")
    assert (fact.refine, fact.precision) == (fj.refine, fj.precision) == (
        1, "highest")
    assert fact.matrix is not None
    np.testing.assert_allclose(to_numpy(fact.solve(b)),
                               np.asarray(fj.solve(bj)), rtol=1e-10,
                               atol=1e-12)
    plain = dt.qr(A, block_size=16, device="cpu")
    assert plain.refine == 0 and plain.matrix is None
    with pytest.raises(ValueError, match="refinement needs the original"):
        plain.solve(b, refine=1)
    pol = tprec.PrecisionPolicy(apply="high")
    fact = dt.qr(A, block_size=16, policy=pol, device="cpu")
    assert fact.precision == dhqr_tpu.qr(
        Aj, block_size=16, policy=jprec.PrecisionPolicy(apply="high")
    ).precision == "high"
    np.testing.assert_allclose(to_numpy(fact.solve(b)),
                               to_numpy(plain.solve(b)), rtol=1e-12,
                               atol=1e-14)


def test_apply_precision_reaches_the_float32_solves():
    """float32: an ``apply="default"`` factorization's Q^H applies run as
    one bf16 pass — its solve differs from the full-precision solve, by
    less than 5e-2 (relative; the solve amplifies the 2^-8 rounding by
    cond(A))."""
    A, b = random_problem(96, 32, np.float32, seed=9)
    full = dt.qr(A, block_size=16, device="cpu").solve(b)
    cheap = dt.qr(A, block_size=16, device="cpu",
                  policy=tprec.PrecisionPolicy(apply="default")).solve(b)
    rel = float(torch.linalg.norm(cheap - full) / torch.linalg.norm(full))
    assert 0 < rel < 5e-2
