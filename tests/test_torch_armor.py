"""PyTorch port: the armor seam (``dhqr_tpu_torch.armor``) and the wire's
integrity tags against the JAX package's ``dhqr_tpu.armor``, on the CPU.

Twins of ``tests/test_armor.py``'s tests that are not slow: the port's
mesh calls run on 2 gloo ranks (``parallel/_ranks.py``, one spawn for the
module), the JAX package's on the conftest's CPU mesh, under the same
fault schedules:

* ``qr_gap`` and ``lstsq_gap`` agree with the JAX package's on the same
  float64 factors to 1e-8 relative, and separate honest from corrupted;
* armed clean dispatches are bit-identical to disarmed ones, and the
  seam token stays None;
* detection, recovery and typing decide the same: a one-shot corrupt is
  re-dispatched away, a persistent drop is typed with the same class,
  label prefix, recovery path and shard index, a NaN on the bf16 wire is
  poisoned by its tag, a compressed wire degrades and trips;
* the kth-visit schedule, the tag poisoning at the wire (psum, gather,
  bf16 and int8), and comms stripped from a stored plan after three trips
  behave as in the JAX package;
* the scheduler routes ``ShardFailure`` to retry and ``CorruptionDetected``
  to isolation, in the update stream too, and the guarded ladder
  escalates past transport corruption;
* the registry exports the ``armor.*`` names while armed;
* ``obs.pulse.measure`` without a mesh measures the card, not the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu import armor as jarmor  # noqa: E402
from dhqr_tpu import faults as jfaults  # noqa: E402
from dhqr_tpu import tune as jtune  # noqa: E402
from dhqr_tpu.armor import checks as jchecks  # noqa: E402
from dhqr_tpu.numeric import guarded_lstsq as jguarded_lstsq  # noqa: E402
from dhqr_tpu.numeric import guarded_qr as jguarded_qr  # noqa: E402
from dhqr_tpu.parallel.mesh import column_mesh  # noqa: E402
from dhqr_tpu.parallel.sharded_qr import sharded_blocked_qr  # noqa: E402
from dhqr_tpu.parallel.sharded_solve import sharded_lstsq  # noqa: E402
from dhqr_tpu.parallel.sharded_tsqr import (  # noqa: E402
    row_mesh,
    sharded_tsqr_lstsq,
)
from dhqr_tpu.utils import config as jconfig  # noqa: E402
from dhqr_tpu.utils.testing import (  # noqa: E402
    TOLERANCE_FACTOR,
    normal_equations_residual,
    oracle_residual,
)

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch import armor, faults, obs, tune  # noqa: E402
from dhqr_tpu_torch.armor import checks  # noqa: E402
from dhqr_tpu_torch.parallel import wire  # noqa: E402
from dhqr_tpu_torch.parallel._ranks import (  # noqa: E402
    COLS,
    ROWS,
    AsTensor,
    results_equal_across_ranks,
    run_calls,
    run_ranks,
)
from dhqr_tpu_torch.utils.config import ArmorConfig, FaultConfig  # noqa: E402

P = 2
_rng = np.random.default_rng(0)
A = _rng.random((64, 32)).astype(np.float32)
B = _rng.random(64).astype(np.float32)
_rng1 = np.random.default_rng(1)
TALL = _rng1.random((64, 8)).astype(np.float32)
TALL_B = _rng1.random(64).astype(np.float32)
_rng3 = np.random.default_rng(3)
A3 = _rng3.random((96, 32)).astype(np.float32)
B3 = _rng3.random(96).astype(np.float32)
_rng11 = np.random.default_rng(11)
G = _rng11.random((32, 8)).astype(np.float32)
G_B = _rng11.random(32).astype(np.float32)
PANEL = np.random.default_rng(5).standard_normal((64, 16)).astype(
    np.float32)

ARMED = ArmorConfig(enabled=True)
NO_REDISPATCH = ArmorConfig(enabled=True, redispatch=0)
LSTSQ = ("sharded_lstsq", (A, B, COLS), dict(block_size=8))
QR = ("sharded_blocked_qr", (A, COLS), dict(block_size=8))


def _sites(*sites):
    return FaultConfig(sites=tuple(sites))


#: The wire's collectives as a tag sees them: a broadcast (while a fault
#: site is armed, the one-hot sum of the owner's payload and the others'
#: zeros), a gather, and a dense sum (int8 carries bf16 there).
WIRE_FNS = ("broadcast", "all_gather", "psum_dense")


def _wire_step(fn, comms):
    x = AsTensor(PANEL)
    if fn == "broadcast":
        return ("parallel.wire.wire_broadcast", (x, 0, COLS),
                dict(comms=comms))
    if fn == "all_gather":
        return ("parallel.wire.wire_all_gather", (x, COLS),
                dict(comms=comms))
    return ("parallel.wire.wire_psum", (x, COLS),
            dict(comms=comms, onehot=False))


def _cases():
    corrupt3 = ("parallel.collective.corrupt", 1.0, 1, 3)
    drop = ("parallel.collective.drop", 1.0, None)
    return {
        "lstsq_disarmed": [LSTSQ],
        "lstsq_armed": {"steps": [LSTSQ], "armor": ARMED},
        "qr_disarmed": [QR],
        "qr_armed": {"steps": [QR], "armor": ARMED},
        "model_qr_disarmed": [("qr", (A,), dict(mesh=COLS, block_size=8)),
                              (".natural_H", (), {})],
        "model_qr_armed": {
            "steps": [("qr", (A,), dict(mesh=COLS, block_size=8)),
                      (".natural_H", (), {})], "armor": ARMED},
        "corrupt_lstsq": {"steps": [LSTSQ], "armor": ARMED,
                          "faults": _sites(corrupt3)},
        "corrupt_qr": {"steps": [QR], "armor": ARMED,
                       "faults": _sites(corrupt3)},
        "drop_lstsq": {"steps": [LSTSQ], "armor": ARMED,
                       "faults": _sites(drop)},
        "drop_qr": {"steps": [QR], "armor": ARMED, "faults": _sites(drop)},
        "nan_tsqr_bf16": {
            "steps": [("sharded_tsqr_lstsq", (TALL, TALL_B, ROWS),
                       dict(block_size=8, comms="bf16"))],
            "armor": ARMED,
            "faults": _sites(("parallel.collective.nan", 1.0, 1))},
        "nan_lstsq_bf16_degrade": {
            "steps": [("sharded_lstsq", (A3, B3, COLS),
                       dict(block_size=8, comms="bf16"))],
            "armor": ARMED,
            # one dispatch is 16 collective visits in both packages: the
            # NaN poisons all of the first and the re-dispatch's first
            "faults": _sites(("parallel.collective.nan", 1.0, 17))},
        "degrade_lstsq_bf16": {
            "steps": [("sharded_lstsq", (A, B, COLS),
                       dict(block_size=8, comms="bf16"))],
            "armor": ARMED,
            "faults": _sites(("parallel.collective.corrupt", 1.0, None))},
        "after_degrade": {
            "steps": [("sharded_lstsq", (A, B, COLS),
                       dict(block_size=8, comms="bf16"))],
            "armor": ARMED},
        "guarded_lstsq": {
            "steps": [("guarded_lstsq", (G, G_B),
                       dict(engine="cholqr2", mesh=ROWS))],
            "armor": NO_REDISPATCH, "faults": _sites(corrupt3)},
        "guarded_qr_drop": {
            "steps": [("guarded_qr", (A3,), dict(mesh=COLS))],
            "armor": NO_REDISPATCH, "faults": _sites(drop)},
        "registry": {
            "steps": [LSTSQ, ("obs.metrics.registry", (), {}),
                      (".snapshot", (), {})], "armor": ARMED},
        "registry_disarmed": [("obs.metrics.registry", (), {}),
                              (".snapshot", (), {})],
        **{f"tag_{fn}_{c}_{armed}": {
            "steps": [_wire_step(fn, c)],
            "faults": _sites(("parallel.collective.corrupt", 1.0, 1)),
            **({"armor": ARMED} if armed else {})}
           for fn in WIRE_FNS for c in ("bf16", "int8")
           for armed in (True, False)},
        **{f"tag_clean_{fn}_{c}": {"steps": [_wire_step(fn, c)],
                                   "armor": ARMED}
           for fn in WIRE_FNS for c in ("bf16", "int8")},
    }


CASES = _cases()


@pytest.fixture(scope="module")
def ranks():
    """{case: rank 0's outcome} from one spawn of P ranks; every rank's
    values are bit-identical (checked here)."""
    per_rank = run_ranks(run_calls, P, device="cpu", timeout_s=300,
                         cases=list(CASES.values()))
    assert results_equal_across_ranks(
        [[o[1].x if name.startswith("guarded") else o[1]
          for name, o in zip(CASES, r) if o[0] == "ok"] for r in per_rank])
    return dict(zip(CASES, per_rank[0]))


@pytest.fixture
def jarmed():
    state = jarmor.arm(jconfig.ArmorConfig(enabled=True))
    try:
        yield state
    finally:
        jarmor.disarm()
        jarmor.reset_wire_trips()


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    armor.disarm()
    armor.reset_wire_trips()
    tune.reset_gate_failures()
    jtune.reset_gate_failures()


def _ok(outcome):
    assert outcome[0] == "ok", outcome
    return outcome[1]


def _report(outcome):
    return outcome[-1]


def _jinj(*sites):
    return jfaults.injected(jconfig.FaultConfig(sites=tuple(sites)))


def _residual_ok(A_, b_, x):
    return normal_equations_residual(A_, np.asarray(x), b_) < \
        TOLERANCE_FACTOR * oracle_residual(A_, b_)


# ------------------------------------------------------------- invariants

def _jax_gap(H, alpha, A_):
    """The JAX package's gap function run op by op (its jitted form fuses
    the reductions and lands ~f32 eps away from the exact float64 value
    that the port, the op-by-op run and numpy all give)."""
    gap, _ = jchecks._qr_gap_impl.__wrapped__(
        jnp.asarray(H), jnp.asarray(alpha), jnp.asarray(A_), 8)
    return float(jnp.max(gap))


def test_qr_gap_matches_jax_on_the_same_factors():
    rng = np.random.default_rng(21)
    A64 = rng.standard_normal((96, 40))
    fact = dt.qr(A64, device="cpu", block_size=8)
    H, alpha = fact.H.numpy(), fact.alpha.numpy()
    for Hx in (H, H + np.where(np.arange(40) == 25, 100.0, 0.0)[None, :]
               * (np.arange(96)[:, None] == 4)):
        g, w = checks.qr_gap(torch.from_numpy(Hx), torch.from_numpy(alpha),
                             torch.from_numpy(A64), 8)
        gj, wj = jchecks.qr_gap(jnp.asarray(Hx), jnp.asarray(alpha),
                                jnp.asarray(A64), 8)
        if Hx is H:  # honest: both at roundoff, where the column is noise
            assert g < 1e-14 and gj < 1e-14
            continue
        assert w == wj and g == pytest.approx(_jax_gap(Hx, alpha, A64),
                                              rel=1e-8)
        assert g == pytest.approx(gj, rel=1e-6)
    honest = checks.qr_gap(fact.H, fact.alpha, torch.from_numpy(A64), 8)[0]
    bad, worst = checks.qr_gap(torch.from_numpy(Hx), fact.alpha,
                               torch.from_numpy(A64), 8)
    assert honest < 1e-12 and bad > 1e-2 and worst >= 25
    Hn = fact.H.clone()
    Hn[0, 0] = float("nan")
    assert checks.qr_gap(Hn, fact.alpha, torch.from_numpy(A64), 8)[0] \
        == float("inf")
    # complex factors: the ramp weights and the conjugations
    Ac = (rng.standard_normal((48, 16))
          + 1j * rng.standard_normal((48, 16)))
    fc = dt.qr(Ac, device="cpu", block_size=8)
    Hc = fc.H.clone()
    Hc[3, 11] += 50.0
    g, w = checks.qr_gap(Hc, fc.alpha, torch.from_numpy(Ac), 8)
    gj, wj = jchecks.qr_gap(jnp.asarray(Hc.numpy()),
                            jnp.asarray(fc.alpha.numpy()), jnp.asarray(Ac),
                            8)
    assert w == wj and g == pytest.approx(
        _jax_gap(Hc.numpy(), fc.alpha.numpy(), Ac), rel=1e-8)
    assert g == pytest.approx(gj, rel=1e-6)
    assert checks.qr_gap(fc.H, fc.alpha, torch.from_numpy(Ac), 8)[0] \
        < 1e-14


def test_lstsq_gap_and_finite_gap_match_jax():
    rng = np.random.default_rng(22)
    A64, b64 = rng.standard_normal((80, 12)), rng.standard_normal(80)
    x = np.linalg.lstsq(A64, b64, rcond=None)[0]
    for xx in (x, x + 10.0):
        got = checks.lstsq_gap(torch.from_numpy(A64), torch.from_numpy(b64),
                               torch.from_numpy(xx))
        want = jchecks.lstsq_gap(jnp.asarray(A64), jnp.asarray(b64),
                                 jnp.asarray(xx))
        assert got == pytest.approx(want, rel=1e-8)
    assert checks.lstsq_gap(torch.from_numpy(A64), torch.from_numpy(b64),
                            torch.from_numpy(x)) < 1e-12
    xt = torch.from_numpy(x)
    assert checks.finite_gap(xt) == 0.0
    xt[0] = float("inf")
    assert checks.finite_gap(xt) == float("inf")
    assert checks.lstsq_gap(torch.from_numpy(A64), torch.from_numpy(b64),
                            xt) == float("inf")


# -------------------------------------------------------- disarmed contract

def test_armed_clean_dispatches_are_bit_identical(ranks):
    assert armor.seam_token(None) is None
    assert armor.seam_token("bf16") is None
    for name in ("lstsq", "qr", "model_qr"):
        clean = _ok(ranks[f"{name}_disarmed"])
        armed = ranks[f"{name}_armed"]
        for got, want in zip(_ok(armed) if name != "lstsq" else
                             [_ok(armed)], clean if name != "lstsq"
                             else [clean]):
            np.testing.assert_array_equal(got, want)
        snap = _report(armed)["metrics"]
        assert snap["verifications"] == 1 and snap["detections"] == 0


# ------------------------------------------------------ detection/recovery

def test_one_shot_corrupt_recovers_by_redispatch_as_in_jax(ranks, jarmed):
    for case, jcall in (("corrupt_lstsq", lambda: sharded_lstsq(
            jnp.asarray(A), jnp.asarray(B), column_mesh(P), block_size=8)),
                        ("corrupt_qr", lambda: sharded_blocked_qr(
            jnp.asarray(A), column_mesh(P), block_size=8))):
        out = ranks[case]
        x = _ok(out)
        snap = _report(out)["metrics"]
        jarmor.arm(jconfig.ArmorConfig(enabled=True))
        with _jinj(("parallel.collective.corrupt", 1.0, 1, 3)):
            jcall()
        jsnap = jarmor.active().metrics_snapshot()
        keys = ("verifications", "detections", "recovered_redispatch",
                "recovered_degrade", "typed_failures")
        assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
        assert snap["detections"] == 1 and snap["recovered_redispatch"] == 1
    np.testing.assert_array_equal(
        _ok(ranks["corrupt_qr"])[0], _ok(ranks["qr_disarmed"])[0])
    assert _residual_ok(A, B, _ok(ranks["corrupt_lstsq"]))


def test_kth_visit_schedule_is_deterministic():
    from dhqr_tpu.faults.harness import FaultHarness as JHarness
    from dhqr_tpu_torch.faults.harness import FaultHarness

    site = ("parallel.collective.corrupt", 1.0, 1, 3)
    h = FaultHarness(FaultConfig(sites=(site,)))
    hj = JHarness(jconfig.FaultConfig(sites=(site,)))
    fires = [h.should_fire(site[0]) for _ in range(6)]
    assert fires == [hj.should_fire(site[0]) for _ in range(6)] == \
        [False, False, True, False, False, False]


@pytest.mark.parametrize("case", ["drop_lstsq", "drop_qr"])
def test_persistent_drop_types_as_in_jax(ranks, jarmed, case):
    out = ranks[case]
    assert out[0] == "raised", out
    err = _report(out)["error"]
    call = (lambda: sharded_lstsq(jnp.asarray(A), jnp.asarray(B),
                                  column_mesh(P), block_size=8)) \
        if case == "drop_lstsq" else (lambda: sharded_blocked_qr(
            jnp.asarray(A), column_mesh(P), block_size=8))
    with _jinj(("parallel.collective.drop", 1.0, None)):
        with pytest.raises(jarmor.ArmorError) as ei:
            call()
    jerr = ei.value
    assert out[1] == type(jerr).__name__
    assert err["shard_index"] == jerr.shard_index
    assert tuple(err["recovery"]) == jerr.recovery == ("redispatch",)
    assert err["label"].split("[")[0] == jerr.label.split("[")[0]
    assert err["label"].startswith(f"{jerr.label.split('[')[0]}[P={P},")
    assert _report(out)["metrics"]["typed_failures"] == 1
    assert issubclass(getattr(dt, out[1]), dt.NumericalError)


def test_nan_on_the_bf16_wire_is_poisoned_and_recovered(ranks, jarmed):
    out = ranks["nan_tsqr_bf16"]
    x = _ok(out)
    snap = _report(out)["metrics"]
    with _jinj(("parallel.collective.nan", 1.0, 1)):
        xj = sharded_tsqr_lstsq(jnp.asarray(TALL), jnp.asarray(TALL_B),
                                row_mesh(P), block_size=8, comms="bf16")
    jsnap = jarmed.metrics_snapshot()
    assert snap["detections"] == jsnap["detections"] >= 1
    assert snap["recovered_redispatch"] == jsnap["recovered_redispatch"]
    assert np.all(np.isfinite(x)) and np.all(np.isfinite(np.asarray(xj)))
    assert _residual_ok(TALL, TALL_B, x)


def test_nan_twice_degrades_the_wire_and_recovers(ranks, jarmed):
    """NaNs on the first dispatch and on its re-dispatch: the tags
    poison both, the f32 degrade recovers (``recovered_degrade``), and
    the label stays degraded with one trip on its plan key."""
    out = ranks["nan_lstsq_bf16_degrade"]
    x = _ok(out)
    rep = _report(out)
    with _jinj(("parallel.collective.nan", 1.0, 17)):
        sharded_lstsq(jnp.asarray(A3), jnp.asarray(B3), column_mesh(P),
                      block_size=8, comms="bf16")
    jsnap = jarmed.metrics_snapshot()
    keys = ("detections", "recovered_redispatch", "recovered_degrade",
            "typed_failures")
    assert {k: rep["metrics"][k] for k in keys} == \
        {k: jsnap[k] for k in keys}
    assert rep["metrics"]["recovered_degrade"] == 1
    key = f"lstsq|96|32|float32|{P}"
    assert rep["trips"][key] == 1 == jarmor.export_wire_trips()[key]
    assert _residual_ok(A3, B3, x)


def test_compressed_wire_degrades_label_and_notes_trips(ranks, jarmed):
    out = ranks["degrade_lstsq_bf16"]
    assert out[0] == "raised" and out[1] in ("CorruptionDetected",
                                             "ShardFailure")
    rep = _report(out)
    assert "degrade" in rep["error"]["recovery"] and rep["degraded"]
    with _jinj(("parallel.collective.corrupt", 1.0, None)):
        with pytest.raises(jarmor.ArmorError) as ei:
            sharded_lstsq(jnp.asarray(A), jnp.asarray(B), column_mesh(P),
                          block_size=8, comms="bf16")
    assert out[1] == type(ei.value).__name__
    assert tuple(rep["error"]["recovery"]) == ei.value.recovery
    assert rep["trips"][f"lstsq|64|32|float32|{P}"] >= 1
    # the degraded label dispatches uncompressed from now on: clean
    after = ranks["after_degrade"]
    assert np.all(np.isfinite(_ok(after)))
    assert _report(after)["metrics"]["detections"] == 0
    np.testing.assert_array_equal(_ok(after), _ok(ranks["lstsq_disarmed"]))


def _jax_wire(fn, comms, armed, faulted):
    """The JAX seam's twin of :func:`_wire_step` on the conftest's CPU
    mesh (the broadcast as the engines' one-hot sum)."""
    import contextlib

    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as PS

    from dhqr_tpu.parallel import wire as jwire
    from dhqr_tpu.utils.compat import shard_map

    mesh = column_mesh(P)
    ax = mesh.axis_names[0]

    def body(x):
        if fn == "broadcast":
            mine = lax.axis_index(ax) == 0
            return jwire.wire_psum(jnp.where(mine, x, 0), ax, comms)
        if fn == "all_gather":
            return jwire.wire_all_gather(x, ax, comms).reshape(
                -1, x.shape[1])
        return jwire.wire_psum(x, ax, comms, onehot=False)

    call = jax.jit(shard_map(body, mesh=mesh, in_specs=PS(),
                             out_specs=PS(), check_vma=False))
    arm = jarmor.armored(jconfig.ArmorConfig(enabled=True)) if armed \
        else contextlib.nullcontext()
    inj = _jinj(("parallel.collective.corrupt", 1.0, 1)) if faulted \
        else contextlib.nullcontext()
    with arm, inj:
        return np.asarray(call(jnp.asarray(PANEL)))


@pytest.mark.parametrize("fn", WIRE_FNS)
@pytest.mark.parametrize("comms", ["bf16", "int8"])
def test_tags_poison_a_corrupted_compressed_payload(ranks, fn, comms):
    """A corrupted compressed payload arrives all NaN where the JAX
    seam's does (its tag's rounding bound cannot absorb the hit), and
    as the same wrong numbers where it does not; disarmed, it arrives
    plausible and wrong; clean, within the format's rounding."""
    for armed in (True, False):
        got = _ok(ranks[f"tag_{fn}_{comms}_{armed}"])
        want = _jax_wire(fn, comms, armed, faulted=True)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = np.isfinite(want)
        if fin.any():
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                       atol=1e-5 * np.abs(want[fin]).max())
        if not armed:
            assert fin.all()
    nan_fns = ("all_gather", "psum_dense") if comms == "int8" \
        else WIRE_FNS
    assert np.isnan(_ok(ranks[f"tag_{fn}_{comms}_True"])).all() == \
        (fn in nan_fns)
    clean = _ok(ranks[f"tag_clean_{fn}_{comms}"])
    exact = {"broadcast": PANEL, "psum_dense": P * PANEL,
             "all_gather": np.concatenate([PANEL] * P)}[fn]
    tol = 2.0 ** -7 if comms == "bf16" or fn == "psum_dense" else 1 / 127
    assert np.abs(clean - exact).max() <= 2 * tol * np.abs(exact).max()
    np.testing.assert_allclose(clean, _jax_wire(fn, comms, True, False),
                               rtol=1e-6, atol=1e-6)


def test_tag_bounds_match_jax():
    from dhqr_tpu.parallel import wire as jwire

    assert (wire._TAG_EPS_BF16, wire._TAG_EPS_BF16_PER_RANK) == \
        (jwire._TAG_EPS_BF16, jwire._TAG_EPS_BF16_PER_RANK)
    x = torch.from_numpy(PANEL)
    np.testing.assert_allclose(wire._pack_tags(x).numpy(),  # sum order
                               np.asarray(jwire._pack_tags(
                                   jnp.asarray(PANEL))), rtol=1e-6)
    q, scale = wire._quant_int8(x)
    assert float(wire._int8_sum_bound(scale, 32)) == pytest.approx(
        float(jwire._int8_sum_bound(jnp.asarray(scale.numpy()), 32)),
        rel=1e-6)
    assert wire._int8_elems_per_scale(PANEL.shape) == \
        jwire._int8_elems_per_scale(PANEL)
    assert wire._int8_elems_per_scale((100,)) == 100


def test_resolve_plan_strips_comms_after_repeated_trips(tmp_path):
    db = tune.PlanDB(str(tmp_path / "plans.json"))
    db.record(tune.plan_key("lstsq", 512, 16, "float32", nproc=2,
                            device="cpu"),
              tune.Plan(engine="cholqr2", comms="bf16"))
    hit = tune.resolve_plan("lstsq", 512, 16, nproc=2, db=db,
                            on_miss="default", device="cpu")
    assert hit is not None and hit.comms == "bf16"
    for i in range(tune.PLAN_DEMOTE_AFTER):
        assert armor.note_wire_trip("lstsq", 512, 16, "float32", 2) == i + 1
    assert armor.wire_demoted("lstsq", 512, 16, torch.float32, 2)
    demoted = tune.resolve_plan("lstsq", 512, 16, nproc=2, db=db,
                                on_miss="default", device="cpu")
    assert demoted.comms is None and demoted.engine == "cholqr2"
    assert tune.plan_gate_stats()["wire_demoted_lookups"] == 1
    # fleet-state spelling round trip, merged by MAX, malformed skipped
    state = armor.export_wire_trips()
    assert state == {"lstsq|512|16|float32|2": 3}
    armor.reset_wire_trips()
    armor.adopt_wire_trips({**state, "bad": 1, "x|1|2|f|z": 4})
    jarmor.adopt_wire_trips({**state, "bad": 1, "x|1|2|f|z": 4})
    try:
        assert armor.export_wire_trips() == jarmor.export_wire_trips()
    finally:
        jarmor.reset_wire_trips()


def test_armor_config_and_arming_match_jax(monkeypatch):
    import dataclasses

    monkeypatch.setenv("DHQR_ARMOR", "1")
    monkeypatch.setenv("DHQR_ARMOR_RTOL", "1e-3")
    monkeypatch.setenv("DHQR_ARMOR_REDISPATCH", "2")
    monkeypatch.setenv("DHQR_ARMOR_TAGS", "off")
    assert dataclasses.asdict(ArmorConfig.from_env()) == \
        dataclasses.asdict(jconfig.ArmorConfig.from_env())
    for bad in (dict(rtol=0.0), dict(redispatch=-1)):
        with pytest.raises(ValueError) as te:
            ArmorConfig(**bad)
        with pytest.raises(ValueError) as je:
            jconfig.ArmorConfig(**bad)
        assert str(te.value) == str(je.value)
    assert armor.arm() is not None and not armor.wire_tags_armed()
    armor.disarm()
    assert armor.arm(ArmorConfig()) is None and armor.active() is None
    with armor.armored() as state:
        assert armor.active() is state and armor.wire_tags_armed()
        assert armor.effective_comms("x", "bf16") == "bf16"
    assert armor.active() is None
    assert armor.WIRE_RTOL == jarmor.WIRE_RTOL


# ------------------------------------------------------- scheduler routing

def test_update_stream_retries_shard_failure(monkeypatch):
    from dhqr_tpu_torch.serve.scheduler import AsyncScheduler
    from dhqr_tpu_torch.solvers.update import UpdatableQR

    rng = np.random.default_rng(5)
    A_ = rng.random((64, 8)).astype(np.float32)
    b_ = rng.random(64).astype(np.float32)
    fact = UpdatableQR(A_, device="cpu")
    calls = {"n": 0}
    real = UpdatableQR.solve

    def flaky(self, rhs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise dt.ShardFailure("injected shard loss", label="upd",
                                  shard_index=0)
        return real(self, rhs)

    monkeypatch.setattr(UpdatableQR, "solve", flaky)
    clock = [0.0]
    sched = AsyncScheduler(start=False, clock=lambda: clock[0],
                           device="cpu")
    try:
        fut = sched.submit("update", fact, ("solve", b_), deadline=30.0)
        clock[0] += 1.0
        sched.poll()
        assert calls["n"] == 1 and not fut.done()
        clock[0] += 1.0
        sched.poll()
        x = fut.result(timeout=60)
        stats = sched.stats()
        assert stats["retries"] == 1 and stats["poisoned"] == 0
        assert bool(torch.isfinite(x).all())
    finally:
        sched.shutdown(drain=False)


def test_scheduler_retries_shard_failure_but_isolates_corruption(
        monkeypatch):
    from dhqr_tpu_torch.serve import engine as tengine
    from dhqr_tpu_torch.serve.scheduler import AsyncScheduler

    rng = np.random.default_rng(7)
    A_ = rng.random((32, 8)).astype(np.float32)
    b_ = rng.random(32).astype(np.float32)
    calls = {"n": 0}
    real = tengine._dispatch_groups

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise dt.ShardFailure("injected shard loss", label="test",
                                  shard_index=1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tengine, "_dispatch_groups", flaky)
    clock = [0.0]
    sched = AsyncScheduler(start=False, clock=lambda: clock[0],
                           device="cpu")
    try:
        fut = sched.submit("lstsq", A_, b_, deadline=30.0)
        clock[0] += 1.0
        sched.poll()
        assert calls["n"] == 1 and not fut.done()
        clock[0] += 1.0
        sched.poll()
        x = fut.result(timeout=60)
        stats = sched.stats()
        assert stats["retries"] == 1 and stats["poisoned"] == 0
        assert bool(torch.isfinite(x).all())

        def corrupt(*args, **kwargs):
            raise dt.CorruptionDetected("corrupted", label="test")

        monkeypatch.setattr(tengine, "_dispatch_groups", corrupt)
        fut2 = sched.submit("lstsq", A_, b_, deadline=30.0)
        clock[0] += 1.0
        sched.poll()
        with pytest.raises(dt.CorruptionDetected):
            fut2.result(timeout=5)
        stats = sched.stats()
        assert stats["poisoned"] == 1 and stats["retries"] == 1
    finally:
        sched.shutdown(drain=False)


# ------------------------------------------------------- guarded ladder

def test_guarded_ladder_escalates_past_transport_corruption(ranks,
                                                            jarmed):
    res = _ok(ranks["guarded_lstsq"])
    jarmor.arm(jconfig.ArmorConfig(enabled=True, redispatch=0))
    with _jinj(("parallel.collective.corrupt", 1.0, 1, 3)):
        jres = jguarded_lstsq(jnp.asarray(G), jnp.asarray(G_B),
                              engine="cholqr2", mesh=row_mesh(P))
    assert [(a.engine, a.outcome) for a in res.attempts] == \
        [(a.engine, a.outcome) for a in jres.attempts]
    assert res.attempts[0].outcome == "corruption"
    assert np.isfinite(res.x).all()


def test_guarded_qr_transport_exhaustion_reraises_armor_error(ranks,
                                                               jarmed):
    out = ranks["guarded_qr_drop"]
    assert out[0] == "raised"
    err = _report(out)["error"]
    jarmor.arm(jconfig.ArmorConfig(enabled=True, redispatch=0))
    with _jinj(("parallel.collective.drop", 1.0, None)):
        with pytest.raises(jarmor.ArmorError) as ei:
            jguarded_qr(jnp.asarray(A3), mesh=column_mesh(P))
    assert out[1] == type(ei.value).__name__
    assert err["label"] and err["attempts"]
    assert err["attempts"] == [a.outcome for a in ei.value.attempts]
    assert all(a == "corruption" for a in err["attempts"])


# ------------------------------------------------------------ registry

def test_registry_exports_armor_names(ranks):
    snap = _ok(ranks["registry"])
    for dotted in ("armor.verifications", "armor.detections",
                   "armor.recovered_redispatch", "armor.recovered_degrade",
                   "armor.typed_failures", "armor.degraded_labels",
                   "armor.wire_trips"):
        assert dotted in snap, (dotted, sorted(snap))
    assert snap["armor.verifications"] >= 1
    assert not any(k.startswith("armor.")
                   for k in _ok(ranks["registry_disarmed"]))
    with armor.armored():
        assert "armor.verifications" in obs.registry().snapshot()


# ------------------------------------------------------ pulse's device

def test_pulse_without_a_mesh_measures_the_card_not_the_cpu(monkeypatch):
    """The old default (``torch.device("cpu")`` with no mesh) returned a
    CPU-only report for a call meant for the card. The device rule now
    applies: None is the card, and without CUDA that raises; the CPU is
    measured only when asked for."""
    from dhqr_tpu_torch.obs import pulse

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pulse.measure("card", lambda: ran.append(1))
    assert ran == []   # nothing measured, nothing reported
    with pulse.pulsed():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pulse.observed_dispatch("card", lambda: 1)
    out, report = pulse.measure("cpu", lambda: 7, device="cpu")
    assert out == 7 and report.device_kind == "cpu"
    with pytest.raises(ValueError, match="mesh's device"):
        pulse.measure("x", lambda: 1, mesh=type(
            "M", (), {"device": torch.device("cpu")})(), device="cuda")


def test_fault_sites_hit_element_zero_of_a_strided_payload():
    """A payload that is dense but not contiguous (a transposed panel, as
    the card's panel route hands the wire) takes the corrupt and nan hits
    at its element 0, as a contiguous one does."""
    x = torch.arange(48, dtype=torch.float32).reshape(8, 6).t()
    sites = tuple((f"parallel.collective.{s}", 1.0, 1)
                  for s in ("corrupt", "nan"))
    with faults.injected(FaultConfig(sites=sites[:1])):
        y = wire._inject_collective(x)
    assert (y != x).sum() == 1 and y[0, 0] == 1e4 * (1.0 + 47.0)
    with faults.injected(FaultConfig(sites=sites[1:])):
        y = wire._inject_collective(x)
    assert torch.isnan(y[0, 0]) and torch.isnan(y).sum() == 1
    assert not torch.isnan(x).any()
