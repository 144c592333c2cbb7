"""PyTorch port: ``numeric/ladder.py`` — ``guarded_lstsq`` / ``guarded_qr``,
the engine and policy ladder, the typed refusals, and the ``guards=``
branches of ``qr`` / ``lstsq`` — against ``dhqr_tpu.numeric``.

Each single-device case of ``tests/test_numeric.py`` runs through both
packages on the same seeded numpy input (the port on the CPU, the JAX
package on the conftest's CPU backend), under the same fault schedule and
with tracing armed. Held equal: the ``(engine, outcome, policy)`` sequence
of the attempts, the typed error's class, and the span names of the
call's trace, in order. ``x`` agrees to 1e-10 relative in float64 and
1e-4 in float32. Then what is the port's own: a kernel that fails to launch
propagates out of the ladder (never a rung), rung 0 is the unguarded
program, and a 2-rank gloo mesh takes the guarded path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
from dhqr_tpu import faults as jfaults  # noqa: E402
from dhqr_tpu.numeric import guards as jguards  # noqa: E402
from dhqr_tpu.numeric import ladder as jladder  # noqa: E402
from dhqr_tpu.obs import trace as jtrace  # noqa: E402
from dhqr_tpu.parallel import column_mesh, row_mesh  # noqa: E402
from dhqr_tpu.utils import config as jconfig  # noqa: E402
from dhqr_tpu.utils.testing import (  # noqa: E402
    TOLERANCE_FACTOR,
    normal_equations_residual,
    oracle_residual,
)

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch import faults  # noqa: E402
from dhqr_tpu_torch import obs  # noqa: E402
from dhqr_tpu_torch.armor import CorruptionDetected  # noqa: E402
from dhqr_tpu_torch.interop import to_numpy  # noqa: E402
from dhqr_tpu_torch.models import qr_model  # noqa: E402
from dhqr_tpu_torch.numeric import guards as tguards  # noqa: E402
from dhqr_tpu_torch.numeric import ladder as tladder  # noqa: E402
from dhqr_tpu_torch.ops import blocked, hopper_panel, tsqr  # noqa: E402
from dhqr_tpu_torch.parallel._ranks import (  # noqa: E402
    COLS,
    ROWS,
    results_equal_across_ranks,
    run_calls,
    run_ranks,
)
from dhqr_tpu_torch.utils import config as tconfig  # noqa: E402


def _problem(m=48, n=10, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.random((m, n)).astype(dtype), rng.random(m).astype(dtype)


def _ill_conditioned(m, n, cond, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.geomspace(1.0, 1.0 / cond, n)
    return ((U * s) @ V.T).astype(dtype), \
        rng.standard_normal(m).astype(dtype)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _run(side, kind, A, b=None, sites=None, **kw):
    """One guarded call on ``side`` ("torch" / "jax") under the fault
    ``sites`` with tracing armed: ``(result or None, error or None, span
    names)``."""
    if side == "torch":
        ladder, flt, trace, cfg_mod = tladder, faults, obs, tconfig
        args = (A,) if b is None else (A, b)
        kw = dict(kw, device="cpu")
    else:
        ladder, flt, trace, cfg_mod = jladder, jfaults, jtrace, jconfig
        args = (jnp.asarray(A),) if b is None else \
            (jnp.asarray(A), jnp.asarray(b))
    fn = ladder.guarded_lstsq if kind == "lstsq" else ladder.guarded_qr
    res = err = None
    with trace.observed() as rec:
        with flt.injected(cfg_mod.FaultConfig(sites=tuple(sites or ()))):
            try:
                res = fn(*args, **kw)
            except Exception as exc:  # the outcome compared across sides
                err = exc
        tid = res.trace_id if res is not None else \
            getattr(err, "trace_id", None)
        spans = [s.name for s in rec.spans_for(tid)] if tid else []
    return res, err, spans


def _path(attempts):
    return [(a.engine, a.outcome, a.policy) for a in attempts]


def _both(kind, A, b=None, sites=None, x_tol=None, **kw):
    """Run both sides and hold them equal; returns the two results (or
    the port's error). ``x_tol`` replaces the dtype's tolerance on x for
    an ill-conditioned A, whose solutions agree only to cond(A) * eps."""
    tres, terr, tspans = _run("torch", kind, A, b, sites, **kw)
    jres, jerr, jspans = _run("jax", kind, A, b, sites, **kw)
    assert type(terr).__name__ == type(jerr).__name__, (terr, jerr)
    assert tspans == jspans
    if terr is not None:
        assert _path(getattr(terr, "attempts", ())) == \
            _path(getattr(jerr, "attempts", ()))
        return terr, jerr
    assert _path(tres.attempts) == _path(jres.attempts)
    assert (tres.engine, tres.policy) == (jres.engine, jres.policy)
    if kind == "lstsq":
        x, xj = to_numpy(tres.x), np.asarray(jres.x)
        tol = 1e-10 if A.dtype == np.float64 else 1e-4
        assert _rel(x, xj) <= (tol if x_tol is None else x_tol)
    return tres, jres


# ------------------------------------------------------------ screening


def test_guard_mode_validation_matches_jax():
    A, b = _problem()
    terr, jerr = _both("lstsq", A, b, guards="bogus")
    assert isinstance(terr, ValueError) and str(terr) == str(jerr)
    assert "guards must be one of" in str(terr)


@pytest.mark.parametrize("mode", ["screen", "fallback", "full"])
@pytest.mark.parametrize("where", ["A", "b"])
def test_nonfinite_input_refused_typed(mode, where):
    A, b = _problem()
    if where == "A":
        A[0, 0] = np.nan
    else:
        b[3] = np.inf
    terr, jerr = _both("lstsq", A, b, guards=mode)
    assert isinstance(terr, dt.NonFiniteInput)
    assert str(terr) == str(jerr) and terr.attempts == ()
    with pytest.raises(dt.NonFiniteInput):
        dt.lstsq(A, b, guards=mode, device="cpu")


def test_zero_column_refused_ill_conditioned():
    A, b = _problem()
    A[:, 2] = 0.0
    terr, _ = _both("lstsq", A, b, guards="fallback")
    assert isinstance(terr, dt.IllConditioned)
    assert terr.cond_estimate == float("inf")
    terr, _ = _both("qr", A, guards="full")
    assert isinstance(terr, dt.IllConditioned)


def test_injected_nan_site_takes_the_organic_path():
    A, b = _problem()
    terr, _ = _both("lstsq", A, b, sites=[("numeric.nan", 1.0, 1)],
                    guards="fallback")
    assert isinstance(terr, dt.NonFiniteInput) and "injected" in str(terr)


# ------------------------------------------------------------ the ladder


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_happy_path_one_rung(dtype):
    A, b = _problem(dtype=dtype)
    for engine in ("householder", "cholqr2", "tsqr"):
        tres, _ = _both("lstsq", A, b, engine=engine, guards="fallback")
        assert tres.escalations == 0 and tres.engine == engine


def test_injected_breakdown_escalates_and_records_path():
    A, b = _problem()
    tres, _ = _both("lstsq", A, b, sites=[("numeric.breakdown", 1.0, 1)],
                    engine="cholqr2", guards="fallback")
    assert tres.engine == "cholqr3" and tres.escalations == 1
    assert tres.attempts[0].detail == "injected numeric.breakdown"
    x = to_numpy(tres.x)
    assert normal_equations_residual(A, x, b) < \
        TOLERANCE_FACTOR * oracle_residual(A, b)


@pytest.mark.parametrize("count", [2, 3])
def test_deeper_escalation_lands_on_the_same_rung(count):
    A, b = _problem(m=64, n=8, seed=2, dtype=np.float64)
    tres, _ = _both("lstsq", A, b, sites=[("numeric.breakdown", 1.0, count)],
                    engine="cholqr2", guards="full")
    assert tres.engine == ("tsqr", "householder")[count - 2]
    assert tres.residual_ratio <= TOLERANCE_FACTOR


@pytest.mark.parametrize("policy", [None, "fast", "balanced"])
def test_policy_escalation_tail_matches_jax(policy):
    """Every rung but the last broken: the policy tail (accurate, then
    one more refinement sweep) and its dedupe against the engine rungs."""
    A, b = _problem(m=40, n=8, seed=3)
    kw = {} if policy is None else {"policy": policy}
    terr, _ = _both("lstsq", A, b, sites=[("numeric.breakdown", 1.0, None)],
                    engine="householder", guards="fallback", **kw)
    assert isinstance(terr, dt.Breakdown) and terr.cond_estimate is not None
    tres, _ = _both("lstsq", A, b, sites=[("numeric.breakdown", 1.0, 1)],
                    engine="householder", guards="fallback", **kw)
    assert tres.escalations == 1


def test_exhausted_ladder_raises_typed_breakdown_with_attempts():
    A, b = _problem()
    terr, jerr = _both("lstsq", A, b,
                       sites=[("numeric.breakdown", 1.0, None)],
                       engine="cholqr2", guards="fallback")
    assert isinstance(terr, dt.Breakdown) and terr.engine == "cholqr2"
    assert len(terr.attempts) >= 4
    assert all(a.outcome == "breakdown" for a in terr.attempts)
    assert terr.cond_estimate == pytest.approx(jerr.cond_estimate, rel=1e-4)


def test_organic_cholqr2_breakdown_recovers_within_8x():
    """No injection: cond 1e12 in float64 is past the CholeskyQR2 window
    (~7e7) and inside the shifted form's; both packages detect the NaN
    factors and land on the same stable rung. Two backward-stable solves
    of a cond-1e12 problem agree to cond * eps ~ 1e-4, so x is held to
    1e-3 here and each answer to the 8x criterion."""
    A, b = _ill_conditioned(96, 16, cond=1e12)
    tres, jres = _both("lstsq", A, b, engine="cholqr2", guards="full",
                       x_tol=1e-3)
    assert jres.residual_ratio <= TOLERANCE_FACTOR
    assert tres.attempts[0].outcome == "breakdown"
    assert tres.residual_ratio <= TOLERANCE_FACTOR
    x_raw = to_numpy(dt.lstsq(A, b, engine="cholqr2", device="cpu"))
    assert not np.all(np.isfinite(x_raw))


def test_organic_breakdown_past_the_window_is_ill_conditioned():
    """Every rung broken on an organic cholqr2 failure whose condition
    bound exceeds the window: IllConditioned, as in the JAX package."""
    A, b = _ill_conditioned(96, 16, cond=1e12)
    terr, _ = _both("lstsq", A, b,
                    sites=[("numeric.breakdown", 1.0, None, 2)],
                    engine="cholqr2", guards="fallback")
    assert isinstance(terr, dt.IllConditioned)
    assert terr.cond_estimate > 1e8


def test_residual_gate_failed_when_every_rung_is_garbage(monkeypatch):
    A, b = _problem()
    monkeypatch.setattr(tguards, "residual_ratio", lambda A_, b_, x_: 99.0)
    monkeypatch.setattr(jguards, "residual_ratio", lambda A_, b_, x_: 99.0)
    terr, _ = _both("lstsq", A, b, engine="cholqr2", guards="full")
    assert isinstance(terr, dt.ResidualGateFailed)
    assert terr.residual_ratio == 99.0
    assert all(a.outcome == "residual_gate" for a in terr.attempts)


def test_rung0_config_error_propagates_not_masked():
    A, b = _problem()
    terr, jerr = _both("lstsq", A, b, engine="cholqr2", layout="cyclic",
                       guards="fallback")
    assert isinstance(terr, ValueError) and "layout" in str(terr)


def test_inapplicable_fallback_rung_is_recorded():
    """A fallback rung that refuses the problem (tsqr on a matrix with too
    few rows per block) is recorded as inapplicable and the ladder goes
    on, in both packages alike."""
    A, b = _problem(m=12, n=10, seed=5)
    tres, _ = _both("lstsq", A, b, sites=[("numeric.breakdown", 1.0, 2)],
                    engine="cholqr2", guards="fallback")
    assert tres.engine in ("tsqr", "householder")


def test_minimum_norm_path_is_guarded_too():
    rng = np.random.default_rng(3)
    A = rng.random((6, 12)).astype(np.float32)
    b = rng.random(6).astype(np.float32)
    tres, _ = _both("lstsq", A, b, guards="fallback")
    assert tres.engine == "householder" and tres.escalations == 0
    A[0, 0] = np.nan
    terr, _ = _both("lstsq", A, b, guards="fallback")
    assert isinstance(terr, dt.NonFiniteInput)


def test_transport_corruption_escalates(monkeypatch):
    """A rung refused by the armor seam (its typed error) is recorded as
    "corruption" and the ladder escalates; when every rung fails so, the
    armor error itself is raised with the attempts."""
    A, b = _problem()
    real = qr_model.lstsq
    calls = []

    def flaky(*args, **kw):
        calls.append(kw["config"].engine)
        if len(calls) == 1:
            raise CorruptionDetected("payload corrupted", label="l0")
        return real(*args, **kw)

    monkeypatch.setattr(qr_model, "lstsq", flaky)
    res = tladder.guarded_lstsq(A, b, engine="cholqr2", device="cpu")
    assert _path(res.attempts)[0][:2] == ("cholqr2", "corruption")
    assert res.engine == "cholqr3"
    monkeypatch.setattr(qr_model, "qr", lambda *a, **k: (_ for _ in ()).throw(
        CorruptionDetected("lost", label="l1")))
    with pytest.raises(CorruptionDetected) as info:
        tladder.guarded_qr(A, device="cpu", policy="fast")
    assert [a.outcome for a in info.value.attempts] == ["corruption"] * 2


def test_warm_guarded_repeat_is_bit_identical():
    A, b = _problem(m=40, n=8, seed=5)
    first = tladder.guarded_lstsq(A, b, engine="cholqr2", device="cpu")
    second = tladder.guarded_lstsq(A, b, engine="cholqr2", device="cpu")
    assert torch.equal(first.x, second.x)


def test_counters_account_the_ladder():
    A, b = _problem()
    before = tladder.COUNTERS.snapshot()
    with faults.injected(tconfig.FaultConfig(
            sites=(("numeric.breakdown", 1.0, 1),))):
        tladder.guarded_lstsq(A, b, engine="cholqr2", device="cpu")
    after = tladder.COUNTERS.snapshot()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert delta["guarded_calls"] == 1 and delta["fallbacks"] == 1
    assert delta["recovered"] == 1 and delta.get("exhausted", 0) == 0


# ---------------------------------------------------------- guarded qr


def test_guarded_qr_happy_path_and_escalation():
    A, _ = _problem(m=32, n=8, seed=7)
    tres, jres = _both("qr", A, guards="full")
    assert tres.engine == "householder" and tres.escalations == 0
    assert tres.cond_estimate == pytest.approx(jres.cond_estimate, rel=1e-4)
    fact = dt.qr(A, guards="fallback", device="cpu")
    assert tuple(fact.H.shape) == A.shape
    tres, _ = _both("qr", A, sites=[("numeric.breakdown", 1.0, 1)],
                    policy="fast", guards="fallback")
    assert tres.escalations == 1 and tres.attempts[1].policy == "accurate"
    terr, _ = _both("qr", A, sites=[("numeric.breakdown", 1.0, None)],
                    policy="fast", guards="fallback")
    assert isinstance(terr, dt.Breakdown) and len(terr.attempts) == 2


def test_guarded_qr_factors_match_jax():
    A, _ = _problem(m=40, n=12, seed=8, dtype=np.float64)
    tres, jres = _both("qr", A, guards="full", block_size=4)
    fact, jfact = tres.factorization, jres.factorization
    assert _rel(to_numpy(fact.H), np.asarray(jfact.H)) <= 1e-10
    assert _rel(to_numpy(fact.alpha), np.asarray(jfact.alpha)) <= 1e-10


def test_guarded_qr_zero_pivot_raises_ill_conditioned():
    A = np.asarray([[1.0, 1.0], [0.0, 0.0], [0.0, 0.0]], np.float64)
    terr, _ = _both("qr", A, guards="fallback")
    assert isinstance(terr, dt.IllConditioned)
    assert "zero diagonal" in str(terr)
    assert [a.outcome for a in terr.attempts] == ["zero_pivot"]


def test_guarded_qr_rejects_donate():
    A, _ = _problem(m=32, n=8)
    with pytest.raises(ValueError, match="donate"):
        dt.qr(A, donate=True, guards="fallback", device="cpu")
    with pytest.raises(ValueError, match="donate"):
        dhqr_tpu.qr(jnp.asarray(A), donate=True, guards="fallback")


def test_plan_stays_refused_under_guards():
    """plan= under guards: rung 0 runs the plan, as in the JAX package,
    and an injected rung-0 breakdown under the plan is one gate failure
    against the call's torch-cpu key (a static-default call records
    none)."""
    from dhqr_tpu.tune import Plan as JPlan
    from dhqr_tpu_torch.tune import Plan, plan_gate_stats, plan_key
    from dhqr_tpu_torch.tune import reset_gate_failures

    A, b = _problem(m=96, n=24, dtype=np.float64)
    x = to_numpy(dt.lstsq(A, b, guards="fallback", device="cpu",
                          plan=Plan(block_size=8)))
    xj = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b),
                                   guards="fallback",
                                   plan=JPlan(block_size=8)))
    assert np.linalg.norm(x - xj) <= 1e-10 * np.linalg.norm(xj)
    reset_gate_failures()
    try:
        sites = tconfig.FaultConfig(sites=(("numeric.breakdown", 1.0, 1),))
        with faults.injected(sites):
            res = dt.guarded_lstsq(A, b, device="cpu",
                                   plan=Plan(block_size=8))
        assert [a.outcome for a in res.attempts][0] == "breakdown"
        key = plan_key("lstsq", 96, 24, "float64", device="cpu")
        assert plan_gate_stats()["failures"] == {key: 1}
        with faults.injected(sites):
            dt.guarded_lstsq(A, b, device="cpu")
        assert plan_gate_stats()["failures"] == {key: 1}
    finally:
        reset_gate_failures()


# ------------------------------------------- the kernel is never a rung


def _failing_kernel(panel, offset, *args):
    raise RuntimeError("panel_qr_f32 launch: cudaErrorLaunchFailure")


def _patch_kernel(monkeypatch, kernel):
    """Both of the blocked engine's kernel entries: the wrapper and the
    leaf that factors in place in H."""
    for name in ("_panel_qr_kernel", "_panel_qr_kernel_in_place"):
        monkeypatch.setattr(blocked, name, kernel)


def test_kernel_failure_on_rung0_propagates(monkeypatch):
    """The kernel route raises (as a failed build or launch does on the
    card): guarded_lstsq re-raises it, records no attempt and counts no
    fallback — no quiet move to the plain version or another engine."""
    A, b = _problem(m=64, n=16)
    _patch_kernel(monkeypatch, _failing_kernel)
    before = tladder.COUNTERS.snapshot().get("fallbacks", 0)
    with obs.observed() as rec:
        with pytest.raises(RuntimeError, match="launch"):
            tladder.guarded_lstsq(A, b, use_pallas="always", device="cpu")
        with pytest.raises(RuntimeError, match="launch"):
            dt.qr(A, use_pallas="always", guards="fallback", device="cpu")
        names = [s.name for t in rec.trace_ids() for s in rec.spans_for(t)]
    assert "rung" not in names and names.count("screen") == 2
    assert tladder.COUNTERS.snapshot().get("fallbacks", 0) == before


def test_kernel_failure_on_a_fallback_rung_propagates(monkeypatch):
    """The same on the tsqr rung, whose leaves take the kernel on the
    card: the two injected breakdowns before it stay recorded, the kernel's
    error ends the call."""
    A, b = _problem(m=64, n=8)
    _patch_kernel(monkeypatch, _failing_kernel)
    monkeypatch.setattr(tsqr, "_resolve_kernel", lambda *a: True)
    with obs.observed() as rec:
        with faults.injected(tconfig.FaultConfig(
                sites=(("numeric.breakdown", 1.0, 2),))):
            with pytest.raises(RuntimeError, match="launch"):
                tladder.guarded_lstsq(A, b, engine="cholqr2", device="cpu")
        spans = [s for t in rec.trace_ids() for s in rec.spans_for(t)]
    rungs = [(s.attrs["engine"], s.attrs["outcome"]) for s in spans
             if s.name == "rung"]
    assert rungs == [("cholqr2", "breakdown"), ("cholqr3", "breakdown")]


def test_kernel_refusal_on_a_fallback_rung_propagates(monkeypatch):
    """A panel the kernel route refuses is a ``ValueError`` of its own
    type: on the tsqr rung it ends the call as the launch failure does,
    and is not recorded as an inapplicable rung."""
    A, b = _problem(m=64, n=8)

    def refusing_kernel(panel, offset, *args):
        raise hopper_panel.KernelRefusal(
            "the panel kernel takes contiguous buffers")

    _patch_kernel(monkeypatch, refusing_kernel)
    monkeypatch.setattr(tsqr, "_resolve_kernel", lambda *a: True)
    with obs.observed() as rec:
        with faults.injected(tconfig.FaultConfig(
                sites=(("numeric.breakdown", 1.0, 2),))):
            with pytest.raises(hopper_panel.KernelRefusal,
                               match="contiguous"):
                tladder.guarded_lstsq(A, b, engine="cholqr2", device="cpu")
        spans = [s for t in rec.trace_ids() for s in rec.spans_for(t)]
    rungs = [(s.attrs["engine"], s.attrs["outcome"]) for s in spans
             if s.name == "rung"]
    assert rungs == [("cholqr2", "breakdown"), ("cholqr3", "breakdown")]


def test_rung0_is_the_unguarded_program():
    """On the kernel's route (its plain version on the CPU), the guarded
    call's x is bit-identical to the unguarded one's, with the same
    launches counted by the wrapper."""
    A, b = _problem(m=96, n=40, seed=9)
    hopper_panel.reset_launches()
    x0 = dt.lstsq(A, b, use_pallas="always", block_size=16, device="cpu")
    l0 = dict(hopper_panel.LAUNCHES)
    hopper_panel.reset_launches()
    x1 = dt.lstsq(A, b, use_pallas="always", block_size=16,
                  guards="fallback", device="cpu")
    assert torch.equal(x0, x1) and dict(hopper_panel.LAUNCHES) == l0


# ------------------------------------------------------------ the mesh


def test_guarded_mesh_happy_path_two_gloo_ranks():
    """``guards=`` with ``mesh=`` on 2 gloo ranks: the column-sharded
    ``qr`` / ``lstsq`` and the row-sharded cholqr2 (with one injected
    breakdown: rung 1, cholqr3 on the mesh), each against the JAX
    package's guarded call on a 2-device mesh."""
    A, b = _problem(m=32, n=24, seed=61, dtype=np.float64)
    T, tb = _problem(m=64, n=8, seed=62, dtype=np.float64)
    breakdown = tconfig.FaultConfig(sites=(("numeric.breakdown", 1.0, 1),))
    cases = [
        [("lstsq", (A, b), dict(mesh=COLS, block_size=4, guards="full"))],
        [("qr", (A,), dict(mesh=COLS, block_size=4, guards="fallback")),
         (".solve", (b,), {})],
        [("faults.install", (breakdown,), {}),
         ("lstsq", (T, tb), dict(mesh=ROWS, engine="cholqr2",
                                 guards="fallback"))],
        [("faults.uninstall", (), {})],
    ]
    per_rank = run_ranks(run_calls, 2, device="cpu", timeout_s=240,
                         cases=cases)
    assert results_equal_across_ranks(per_rank)
    got = per_rank[0]
    assert all(o[0] == "ok" for o in got), got
    cols, rows = column_mesh(2), row_mesh(2)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    want = [np.asarray(dhqr_tpu.lstsq(Aj, bj, mesh=cols, block_size=4,
                                      guards="full")),
            np.asarray(dhqr_tpu.qr(Aj, mesh=cols, block_size=4,
                                   guards="fallback").solve(bj))]
    with jfaults.injected(jconfig.FaultConfig(
            sites=(("numeric.breakdown", 1.0, 1),))):
        want.append(np.asarray(dhqr_tpu.lstsq(
            jnp.asarray(T), jnp.asarray(tb), mesh=rows, engine="cholqr2",
            guards="fallback")))
    for (status, x), xj in zip(got[:3], want):
        assert _rel(x, xj) <= 1e-10
    assert normal_equations_residual(T, got[2][1], tb) <= \
        TOLERANCE_FACTOR * oracle_residual(T, tb)
