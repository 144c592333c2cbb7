"""PyTorch port: the tuner (``dhqr_tpu_torch.tune``) against the JAX
package's ``dhqr_tpu.tune``, on the CPU.

Twins of ``tests/test_tune.py`` wherever the port has the surface, each
holding the port against the JAX package on the same inputs:

* ``Plan``: the dict payloads, ``describe`` strings and validation
  messages are equal;
* ``plan_key`` is equal for an explicit platform, and the port's default
  platform is ``torch-<device type>``;
* the plan database: a file written by either package loads in the
  other; tolerant loading, one warning per (path, reason), last-write-wins
  merging; the port ships a seed file with the JAX schema and no entries;
* ``candidate_plans``: ``torch-cpu`` grids equal JAX's ``cpu`` grids and
  ``torch-cuda`` grids JAX's ``tpu`` grids;
* stub-timed ``tune(measure=...)`` picks the same winner and writes the
  same entry, and ``resolve_plan`` hit, miss and demotion behave the same;
* ``qr`` / ``lstsq(plan=Plan(...), device="cpu")`` match the JAX package
  under the same plan (1e-10 relative in f64, 1e-4 in f32); ``plan=
  "auto"`` tunes once into the DB and then hits it; ``plan="default"`` is
  a no-op; the exclusivity rules raise the JAX package's messages;
* serve ``prewarm(plan="auto")`` tunes the bucket program, and the tuned
  dispatch that follows compiles nothing.

Timing-dependent behavior runs through injected stub timers; the few real
searches are tiny. Every DB is a temporary file.
"""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
from dhqr_tpu import tune as jtune  # noqa: E402
from dhqr_tpu.tune import search as jsearch  # noqa: E402
from dhqr_tpu.utils import config as jconfig  # noqa: E402
from dhqr_tpu.utils.testing import (  # noqa: E402
    TOLERANCE_FACTOR,
    normal_equations_residual,
    oracle_residual,
    random_problem,
)

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch import tune  # noqa: E402
from dhqr_tpu_torch.interop import to_numpy  # noqa: E402
from dhqr_tpu_torch.tune import registry as treg  # noqa: E402
from dhqr_tpu_torch.tune import search as tsearch  # noqa: E402
from dhqr_tpu_torch.utils import config as tconfig  # noqa: E402

PLAN_KWARGS = [
    {},
    dict(block_size=64, panel_impl="recursive", trailing_precision="high",
         lookahead=True, agg_panels=2),
    dict(block_size=32, lookahead=True, overlap_depth=2),
    dict(block_size=128, panel_impl="reconstruct:256"),
    dict(engine="tsqr", comms="bf16"),
    dict(engine="cholqr2", block_size=16),
    dict(engine="sketch"),
    dict(block_size=256, agg_panels=2, comms="int8"),
    dict(comms="dcn:bf16"),
    dict(comms="f32"),
]

BAD_PLANS = [
    dict(engine="cholqr3"), dict(engine="nope"), dict(block_size=0),
    dict(panel_impl="fused"), dict(trailing_precision="bf16"),
    dict(agg_panels=1), dict(engine="tsqr", panel_impl="recursive"),
    dict(engine="cholqr2", trailing_precision="high"),
    dict(engine="tsqr", lookahead=True),
    dict(lookahead=True, overlap_depth=1), dict(overlap_depth=2),
    dict(lookahead=True, agg_panels=2, overlap_depth=2),
    dict(engine="cholqr2", lookahead=True, overlap_depth=2),
    dict(comms="fp8"),
]


@pytest.fixture(autouse=True)
def _clean_state():
    """Gate failures, wire trips and the default DB are process state:
    every test starts and ends without them."""
    from dhqr_tpu_torch import armor

    for reset in (tune.reset_gate_failures, armor.reset_wire_trips,
                  tune.reset_default_db, jtune.reset_gate_failures,
                  jtune.reset_default_db):
        reset()
    yield
    for reset in (tune.reset_gate_failures, armor.reset_wire_trips,
                  tune.reset_default_db, jtune.reset_gate_failures,
                  jtune.reset_default_db):
        reset()


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    """Both packages' default DBs at temp files, seeds off, a tiny grid."""
    monkeypatch.setenv("DHQR_TUNE_DB", str(tmp_path / "plans.json"))
    monkeypatch.setenv("DHQR_TUNE_SEEDS", "0")
    monkeypatch.setenv("DHQR_TUNE_BUDGET", "6")
    monkeypatch.setenv("DHQR_TUNE_REPEATS", "1")
    tune.reset_default_db()
    jtune.reset_default_db()
    yield tmp_path


def _rel(x, y):
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("kw", PLAN_KWARGS, ids=lambda d: "-".join(
    f"{k}={v}" for k, v in d.items()) or "default")
def test_plan_payload_and_describe_match_jax(kw):
    p, pj = tune.Plan(**kw), jtune.Plan(**kw)
    assert p.to_dict() == pj.to_dict()
    assert p.describe() == pj.describe()
    assert tune.Plan.from_dict(pj.to_dict()) == p
    assert tune.Plan.from_dict(json.loads(json.dumps(p.to_dict()))) == p


@pytest.mark.parametrize("kw", BAD_PLANS, ids=lambda d: "-".join(
    f"{k}={v}" for k, v in d.items()))
def test_plan_validation_messages_match_jax(kw):
    with pytest.raises(ValueError) as te:
        tune.Plan(**kw)
    with pytest.raises(ValueError) as je:
        jtune.Plan(**kw)
    assert str(te.value) == str(je.value)


def test_plan_from_dict_rejects_unknown_fields():
    d = tune.DEFAULT_PLAN.to_dict()
    d["use_pallas"] = "always"
    with pytest.raises(ValueError) as te:
        tune.Plan.from_dict(d)
    with pytest.raises(ValueError) as je:
        jtune.Plan.from_dict(d)
    assert str(te.value) == str(je.value)
    assert tune.Plan.from_dict({**tune.Plan(
        block_size=32, lookahead=True, overlap_depth=2).to_dict(),
        "overlap_depth": "2"}).overlap_depth == 2


def test_plan_key_and_policy_tag_match_jax():
    for args in [("lstsq", 512, 64, "float32"), ("qr", 8, 8, np.float64),
                 ("serve_lstsq", 384, 128, "complex64")]:
        for pol in (None, "fast", "accurate"):
            tp = dt.resolve_policy(pol) if pol else None
            jp = dhqr_tpu.resolve_policy(pol) if pol else None
            assert tune.policy_tag(tp) == jtune.policy_tag(jp)
            assert tune.plan_key(*args, nproc=4, platform="cpu",
                                 policy_tag=tune.policy_tag(tp)) == \
                jtune.plan_key(*args, nproc=4, platform="cpu",
                               policy_tag=jtune.policy_tag(jp))
    assert tune.plan_key("lstsq", 512, 64, torch.float32, device="cpu") \
        == "torch-cpu:lstsq:512x64:float32:p1:-"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tune.plan_key("lstsq", 512, 64, "float32")


# --------------------------------------------------------------- database

def test_db_written_by_either_package_loads_in_the_other(tmp_path):
    key = tune.plan_key("lstsq", 256, 32, "float32", platform="cpu")
    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tdb = tune.PlanDB(tpath)
    tdb.record(key, tune.Plan(engine="cholqr2"), speedup=2.5, source="t")
    tdb.save()
    jdb = jtune.PlanDB(jpath)
    jdb.record(key, jtune.Plan(engine="cholqr2"), speedup=2.5, source="t")
    jdb.save()
    with open(tpath) as ft, open(jpath) as fj:
        assert ft.read() == fj.read()
    assert jtune.PlanDB(tpath).get(key) == jtune.Plan(engine="cholqr2")
    assert tune.PlanDB(jpath).get(key) == tune.Plan(engine="cholqr2")
    assert tune.PlanDB(jpath).get_entry(key)["speedup"] == 2.5
    # the JAX package's shipped seeds load clean in the port too
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        seeds = tune.PlanDB(seed_path=jtune.SEED_PATH)
    assert seeds.keys() == jtune.PlanDB(seed_path=jtune.SEED_PATH).keys()


@pytest.mark.parametrize("content,reason", [
    ("{ not json !!!", "unreadable"),
    (json.dumps({"schema": "dhqr-plan-db", "version": 999, "plans": {}}),
     "version"),
    (json.dumps({"whatever": 1}), "schema"),
], ids=["corrupt", "stale", "foreign"])
def test_db_tolerant_loading_warns_once(tmp_path, content, reason):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as fh:
        fh.write(content)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        db = tune.PlanDB(path)
        tune.PlanDB(path)
    assert len(db) == 0
    msgs = [str(x.message) for x in w if "plan DB" in str(x.message)]
    assert len(msgs) == 1 and reason in msgs[0]
    key = tune.plan_key("qr", 64, 16, "float32", platform="cpu")
    db.record(key, tune.Plan(block_size=16))
    db.save()
    assert jtune.PlanDB(path).get(key) == jtune.Plan(block_size=16)


def test_db_malformed_entry_dropped_others_kept(tmp_path):
    path = str(tmp_path / "mixed.json")
    good = tune.plan_key("lstsq", 128, 16, "float32", platform="cpu")
    with open(path, "w") as fh:
        json.dump({"schema": "dhqr-plan-db", "version": 1, "plans": {
            good: {"plan": tune.Plan(engine="tsqr").to_dict()},
            "cpu:bad:1": {"plan": {"engine": "warp-drive"}},
            "cpu:bad:2": ["not", "a", "dict"]}}, fh)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        db = tune.PlanDB(path)
    assert db.get(good) == tune.Plan(engine="tsqr") and len(db) == 1
    assert sum("malformed entry" in str(x.message) for x in w) == 2
    with pytest.raises(ValueError):
        db.record("k", "not-a-plan")


def test_db_concurrent_writers_merge_last_write_wins(tmp_path):
    path = str(tmp_path / "plans.json")
    shared = tune.plan_key("lstsq", 512, 64, "float32", platform="cpu")
    only1 = tune.plan_key("lstsq", 128, 8, "float32", platform="cpu")
    only2 = tune.plan_key("qr", 256, 64, "float32", platform="cpu")
    db1, db2 = tune.PlanDB(path), jtune.PlanDB(path)  # one of each
    db1.record(shared, tune.Plan(block_size=32))
    db1.record(only1, tune.Plan(engine="cholqr2"))
    db1.save()
    db2.record(shared, jtune.Plan(block_size=128))
    db2.record(only2, jtune.Plan(block_size=64))
    db2.save()
    final = tune.PlanDB(path)
    assert final.get(shared) == tune.Plan(block_size=128)
    assert final.get(only1) == tune.Plan(engine="cholqr2")
    assert final.get(only2) == tune.Plan(block_size=64)
    assert db1.forget(only1) and not db1.forget("nope")


def test_shipped_seed_file_has_the_schema_and_no_entries(tmp_path):
    with open(tune.SEED_PATH) as fh:
        raw = json.load(fh)
    assert raw == {"schema": "dhqr-plan-db", "version": 1, "plans": {}}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tune.PlanDB(seed_path=tune.SEED_PATH).keys() == []
    # seeds under a local DB: local entries shadow (JAX seeds as stand-in)
    db = tune.PlanDB(str(tmp_path / "l.json"), seed_path=jtune.SEED_PATH)
    key = "cpu:serve_lstsq:384x128:float32:p1:-"
    assert db.get(key) == tune.Plan(block_size=32)
    db.record(key, tune.Plan(block_size=64))
    assert db.get(key) == tune.Plan(block_size=64)


def test_default_db_reads_the_env(tune_env, monkeypatch):
    db = tune.default_db()
    assert db.path == str(tune_env / "plans.json") and db is tune.default_db()
    monkeypatch.setenv("DHQR_TUNE_DB", str(tune_env / "other.json"))
    assert tune.default_db() is db
    tune.reset_default_db()
    assert tune.default_db().path == str(tune_env / "other.json")


# ----------------------------------------------------------- the grid

GRIDS = [
    ("lstsq", 2048, 64, "float32", 1, None, None),
    ("lstsq", 4096, 64, "float32", 1, None, None),
    ("lstsq", 1024, 64, "float32", 1, None, None),
    ("lstsq", 256, 256, "float32", 1, None, None),
    ("lstsq", 4096, 64, "float32", 1, "fast", None),
    ("lstsq", 512, 128, "complex64", 1, None, None),
    ("lstsq", 65536, 256, "float32", 1, None, 16),
    ("qr", 16384, 16384, "float32", 1, None, 8),
    ("qr", 4096, 64, "float32", 1, None, None),
    ("serve_qr", 4096, 64, "float32", 1, None, None),
    ("serve_lstsq", 384, 128, "float32", 1, None, None),
    ("serve_sketch", 4096, 64, "float32", 1, None, None),
    ("lstsq", 1024, 256, "float32", 8, None, 64),
    ("lstsq", 4400, 4000, "float32", 4, None, 64),
    ("qr", 1024, 256, "float32", 8, None, 64),
]


@pytest.mark.parametrize("platforms", [("torch-cpu", "cpu"),
                                       ("torch-cuda", "tpu")],
                         ids=["cpu", "cuda-tpu"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "-".join(
    str(x) for x in g))
def test_candidate_grids_match_jax(grid, platforms):
    kind, m, n, dtype, nproc, pol, budget = grid
    tp = dt.resolve_policy(pol) if pol else None
    jp = dhqr_tpu.resolve_policy(pol) if pol else None
    ours = tune.candidate_plans(kind, m, n, dtype, nproc=nproc, policy=tp,
                                platform=platforms[0], budget=budget)
    theirs = jtune.candidate_plans(kind, m, n, dtype, nproc=nproc,
                                   policy=jp, platform=platforms[1],
                                   budget=budget)
    assert [p.to_dict() for p in ours] == [p.to_dict() for p in theirs]
    assert ours[0] == tune.DEFAULT_PLAN
    for p in ours:
        assert treg.grid_route_for(kind, p, nproc) == \
            jtune.grid_route_for(kind, jtune.Plan(**p.__dict__), nproc)
        assert treg.grid_route_for(kind, p, nproc) in treg.route_names()


@pytest.mark.parametrize("floor", [None, 0.0, 2e-3])
def test_overlap_rungs_and_pod_rungs_match_jax(floor):
    for topology in (None, (2, 2)):
        ours = tune.candidate_plans("lstsq", 1024, 256, nproc=4,
                                    platform="torch-cpu", budget=64,
                                    topology=topology,
                                    exposed_floor_s=floor)
        theirs = jtune.candidate_plans("lstsq", 1024, 256, nproc=4,
                                       platform="cpu", budget=64,
                                       topology=topology,
                                       exposed_floor_s=floor)
        assert [p.to_dict() for p in ours] == [p.to_dict() for p in theirs]
    depths = sorted({p.overlap_depth for p in ours if p.overlap_depth})
    assert depths == ([] if floor == 0.0 else [2, 4])


def test_grid_refusals_match_jax():
    for args in [("svd", 64, 8), ("lstsq", 8, 64), ("qr", 8, 0)]:
        with pytest.raises(ValueError) as te:
            tune.candidate_plans(*args, platform="torch-cpu")
        with pytest.raises(ValueError) as je:
            jtune.candidate_plans(*args, platform="cpu")
        assert str(te.value) == str(je.value)


def test_registry_routes_and_stages_match_jax():
    from dhqr_tpu.tune import registry as jreg

    assert treg.self_check() == []
    assert treg.route_names() == jreg.route_names()
    ident = ("family", "kind", "schedule", "panel_impl", "comms", "layout",
             "lookahead", "agg_panels", "overlap_depth", "donated",
             "batched", "min_devices", "presets")
    for r in treg.routes():
        j = jreg.route(r.name)
        assert all(getattr(r, f) == getattr(j, f) for f in ident), r.name
        assert treg.reachable(r, 4, "fast") == jreg.reachable(j, 4, "fast")
    assert [(s.config, s.metric, s.route, s.m, s.n, s.kind, s.engine,
             s.layout) for s in treg.bench_stages()] == \
        [(s.config, s.metric, s.route, s.m, s.n, s.kind, s.engine,
          s.layout) for s in jreg.bench_stages()]
    assert (treg.TUNE_KINDS, treg.SERVE_PROGRAM_KINDS) == \
        (jreg.TUNE_KINDS, jreg.SERVE_PROGRAM_KINDS)
    # the analysis hooks (ROADMAP item 18b): the JAX registry's routes
    for mine, theirs in ((treg.jaxpr_routes("fast"),
                          jreg.jaxpr_routes("fast")),
                         (treg.comms_routes(2, True),
                          jreg.comms_routes(2, True)),
                         (treg.serve_routes(), jreg.serve_routes()),
                         (treg.donated_routes(), jreg.donated_routes())):
        assert [r.name for r in mine] == [r.name for r in theirs]
    assert treg.contract_names() == jreg.contract_names()
    hooks = ("jaxpr", "comms_trace", "contract", "serve", "donation")
    assert all(hasattr(treg.Route("x", "householder", "qr", "single"), f)
               for f in hooks)


# ------------------------------------------------------- stubbed searches

def _stub(table, default=1.0):
    def measure(plan, runner, args, repeats):
        return table.get(plan.describe(), default)
    return measure


@pytest.mark.parametrize("table,default", [
    ({"cholqr2": 0.125, "householder": 1.0}, 1.0),   # a clear winner
    ({}, 0.5),                                        # ties: candidate 0
    ({"householder+nb64": 0.25, "tsqr": 0.25}, 1.0),  # tie: grid order
], ids=["winner", "all-tied", "tie-order"])
def test_stub_tune_matches_jax_winner_and_entry(tmp_path, table, default):
    tdb = tune.PlanDB(str(tmp_path / "t.json"))
    jdb = jtune.PlanDB(str(tmp_path / "j.json"))
    tres = tune.tune("lstsq", 4096, 64, db=tdb, measure=_stub(table, default),
                     device="cpu")
    jres = jtune.tune("lstsq", 4096, 64, db=jdb, measure=_stub(table,
                                                               default))
    assert tres.plan.to_dict() == jres.plan.to_dict()
    assert tres.speedup == pytest.approx(jres.speedup)
    assert tres.key == "torch-" + jres.key
    assert tdb.get_entry(tres.key) == jdb.get_entry(jres.key)
    assert tune.PlanDB(str(tmp_path / "t.json")).get(tres.key) == tres.plan


def test_stub_tune_candidate_exception_skipped(tmp_path):
    boom = "tsqr"

    def measure(plan, runner, args, repeats):
        if plan.describe() == boom:
            raise RuntimeError("no device")
        return 1.0 if plan.describe() == "householder" else 2.0

    res = tune.tune("lstsq", 4096, 64, db=tune.PlanDB(), measure=measure,
                    device="cpu")
    jres = jtune.tune("lstsq", 4096, 64, db=jtune.PlanDB(), measure=measure)
    assert res.plan == tune.DEFAULT_PLAN
    assert [(m.plan.describe(), m.seconds, m.reason)
            for m in res.measurements] == \
        [(m.plan.describe(), m.seconds, m.reason)
         for m in jres.measurements]


def test_resolve_plan_hit_miss_and_demotion_match_jax(tmp_path):
    tdb = tune.PlanDB(str(tmp_path / "t.json"))
    jdb = jtune.PlanDB(str(tmp_path / "j.json"))
    kw = dict(on_miss="default")
    assert tune.resolve_plan("lstsq", 333, 11, db=tdb, device="cpu",
                             **kw) is None
    assert jtune.resolve_plan("lstsq", 333, 11, db=jdb, **kw) is None
    assert len(tdb) == len(jdb) == 0
    timer = _stub({"cholqr2": 0.1})
    p = tune.resolve_plan("lstsq", 4096, 64, db=tdb, on_miss="tune",
                          measure=timer, device="cpu")
    pj = jtune.resolve_plan("lstsq", 4096, 64, db=jdb, on_miss="tune",
                            measure=timer)
    assert p.to_dict() == pj.to_dict() == {**tune.DEFAULT_PLAN.to_dict(),
                                           "engine": "cholqr2"}

    def bomb(plan, runner, args, repeats):
        raise AssertionError("re-tuned a DB hit")

    assert tune.resolve_plan("lstsq", 4096, 64, db=tdb, measure=bomb,
                             device="cpu") == p
    # three gate failures demote the key in both packages
    for i in range(tune.PLAN_DEMOTE_AFTER):
        assert tune.note_gate_failure("lstsq", 4096, 64, "float32",
                                      device="cpu") == i + 1
        jtune.note_gate_failure("lstsq", 4096, 64, "float32")
    assert tune.resolve_plan("lstsq", 4096, 64, db=tdb, device="cpu") is None
    assert jtune.resolve_plan("lstsq", 4096, 64, db=jdb) is None
    ts, js = tune.plan_gate_stats(), jtune.plan_gate_stats()
    assert {k.replace("torch-", ""): v for k, v in ts["failures"].items()} \
        == js["failures"]
    assert {k: v for k, v in ts.items() if k != "failures"} == \
        {k: v for k, v in js.items() if k != "failures"}
    # the registry reads the demotion
    snap = dt.obs.registry().snapshot()
    assert snap["tune.plan_gate.failures"] == 3
    assert snap["tune.plan_gate.demoted_keys"] == 1
    assert snap["tune.plan_gate.demoted_lookups"] == 1
    # adopting by MAX, then a reset re-admits the key
    tsearch.adopt_gate_failures({"x": 2, "y": "bad"})
    jsearch.adopt_gate_failures({"x": 2, "y": "bad"})
    assert tune.plan_gate_stats()["failures"]["x"] == \
        jtune.plan_gate_stats()["failures"]["x"] == 2
    tune.reset_gate_failures()
    assert tune.resolve_plan("lstsq", 4096, 64, db=tdb, device="cpu") == p


def test_wire_trips_strip_comms_from_a_stored_plan(tmp_path):
    from dhqr_tpu import armor as jarmor
    from dhqr_tpu_torch import armor

    stored = dict(block_size=128, comms="bf16")
    tdb, jdb = tune.PlanDB(), jtune.PlanDB()
    tdb.record(tune.plan_key("lstsq", 4400, 4000, "float32", nproc=4,
                             device="cpu"), tune.Plan(**stored))
    jdb.record(jtune.plan_key("lstsq", 4400, 4000, "float32", nproc=4),
               jtune.Plan(**stored))
    try:
        for _ in range(tune.PLAN_DEMOTE_AFTER):
            assert tune.resolve_plan("lstsq", 4400, 4000, nproc=4, db=tdb,
                                     device="cpu").comms == "bf16"
            armor.note_wire_trip("lstsq", 4400, 4000, torch.float32, 4)
            jarmor.note_wire_trip("lstsq", 4400, 4000, "float32", 4)
        p = tune.resolve_plan("lstsq", 4400, 4000, nproc=4, db=tdb,
                              device="cpu")
        pj = jtune.resolve_plan("lstsq", 4400, 4000, nproc=4, db=jdb)
        assert p.to_dict() == pj.to_dict() == tune.Plan(
            block_size=128).to_dict()
        assert armor.export_wire_trips() == jarmor.export_wire_trips()
        assert tune.plan_gate_stats()["wire_demoted_lookups"] == 1
    finally:
        jarmor.reset_wire_trips()


# ---------------------------------------- plan= on the entry points

PLANS_FOR_CALLS = [
    dict(block_size=8), dict(block_size=16, panel_impl="recursive"),
    dict(block_size=32, panel_impl="reconstruct"),
    dict(engine="cholqr2"), dict(engine="tsqr"), dict(engine="sketch"),
]


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-4)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kw", PLANS_FOR_CALLS, ids=lambda d: "-".join(
    f"{k}={v}" for k, v in d.items()))
def test_lstsq_and_qr_under_a_plan_match_jax(kw, dtype, tol):
    A, b = random_problem(256, 16, dtype, seed=11)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    x = to_numpy(dt.lstsq(A, b, plan=tune.Plan(**kw), device="cpu"))
    xj = np.asarray(dhqr_tpu.lstsq(Aj, bj, plan=jtune.Plan(**kw)))
    assert _rel(x, xj) <= (tol if kw.get("engine") != "sketch"
                           else max(tol, 1e-6))
    if kw.get("engine", "householder") == "householder":
        fact = dt.qr(A, plan=tune.Plan(**kw), device="cpu")
        factj = dhqr_tpu.qr(Aj, plan=jtune.Plan(**kw))
        assert fact.block_size == factj.block_size
        assert _rel(to_numpy(fact.solve(b)),
                    np.asarray(factj.solve(bj))) <= tol
    else:
        with pytest.raises(ValueError) as te:
            dt.qr(A, plan=tune.Plan(**kw), device="cpu")
        with pytest.raises(ValueError) as je:
            dhqr_tpu.qr(Aj, plan=jtune.Plan(**kw))
        assert str(te.value) == str(je.value)


def test_plan_default_spelling_is_noop():
    A, b = random_problem(64, 16, np.float32, seed=0)
    x0 = to_numpy(dt.lstsq(A, b, device="cpu"))
    x1 = to_numpy(dt.lstsq(A, b, plan="default", device="cpu"))
    np.testing.assert_array_equal(x0, x1)


def test_plan_exclusivity_messages_match_jax():
    A, b = random_problem(64, 16, np.float32, seed=0)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    cases = [dict(plan=tune.Plan(), **kw) for kw in (
        dict(block_size=32), dict(engine="cholqr2"),
        dict(panel_impl="recursive"), dict(lookahead=True),
        dict(agg_panels=2), dict(use_pallas="never"))]
    cases += [dict(plan="fastest"),
              dict(plan=tune.Plan(trailing_precision="high"),
                   policy="fast"),
              dict(plan=tune.Plan(), blocked=False)]
    for kw in cases:
        jkw = {k: (jtune.Plan(**v.__dict__) if isinstance(v, tune.Plan)
                   else v) for k, v in kw.items()}
        with pytest.raises(ValueError) as te:
            dt.lstsq(A, b, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            dhqr_tpu.lstsq(Aj, bj, **jkw)
        assert str(te.value).replace("dhqr_tpu_torch", "dhqr_tpu") == \
            str(je.value), kw


def test_apply_plan_policy_trailing_wins():
    cfg = tconfig.DHQRConfig(trailing_precision="default", comms="int8")
    out = tune.apply_plan_to_config(
        cfg, tune.Plan(block_size=64, trailing_precision="high",
                       comms="bf16"))
    jout = jtune.apply_plan_to_config(
        jconfig.DHQRConfig(trailing_precision="default", comms="int8"),
        jtune.Plan(block_size=64, trailing_precision="high", comms="bf16"))
    assert dataclass_fields(out) == dataclass_fields(jout)


def dataclass_fields(cfg):
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_tune_and_plan_configs_from_env(monkeypatch):
    monkeypatch.setenv("DHQR_TUNE_DB", "~/x.json")
    monkeypatch.setenv("DHQR_TUNE_BUDGET", "9")
    monkeypatch.setenv("DHQR_TUNE_REPEATS", "2")
    monkeypatch.setenv("DHQR_TUNE_ON_MISS", "default")
    monkeypatch.setenv("DHQR_TUNE_SEEDS", "0")
    assert dataclass_fields(tconfig.TuneConfig.from_env()) == \
        dataclass_fields(jconfig.TuneConfig.from_env())
    for bad in (dict(on_miss="maybe"), dict(budget=0), dict(repeats=0)):
        with pytest.raises(ValueError) as te:
            tconfig.TuneConfig(**bad)
        with pytest.raises(ValueError) as je:
            jconfig.TuneConfig(**bad)
        assert str(te.value) == str(je.value)
    for raw in ("auto", "default", ""):
        monkeypatch.setenv("DHQR_TUNE_PLAN", raw)
        assert tconfig.DHQRConfig.from_env().plan == \
            jconfig.DHQRConfig.from_env().plan
    monkeypatch.setenv("DHQR_TUNE_PLAN", "fastest")
    with pytest.raises(ValueError) as te:
        tconfig.DHQRConfig.from_env()
    with pytest.raises(ValueError) as je:
        jconfig.DHQRConfig.from_env()
    assert str(te.value) == str(je.value)


# ---------------------------------------------- real (tiny) searches

def test_verify_gate_rejects_inaccurate_output():
    A, b = random_problem(96, 8, np.float32, seed=7)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    good = torch.from_numpy(np.linalg.lstsq(
        A.astype(np.float64), b.astype(np.float64),
        rcond=None)[0].astype(np.float32))
    ok, ratio = tsearch._verify("lstsq", good, (At, bt), None)
    okj, ratioj = jsearch._verify("lstsq", jnp.asarray(good.numpy()),
                                  (jnp.asarray(A), jnp.asarray(b)), None)
    assert ok and okj and ratio == pytest.approx(ratioj, rel=1e-5)
    for bad in (torch.zeros_like(good), torch.full_like(good, np.nan)):
        assert not tsearch._verify("lstsq", bad, (At, bt), None)[0]
    # the qr gate: the f64 Gram proxy on the device, the JAX package's
    # number on the host
    Aq = torch.from_numpy(random_problem(64, 16, np.float64, seed=1)[0])
    fact = dt.qr(Aq, device="cpu", block_size=8)
    ok, err = tsearch._verify("qr", (fact.H, fact.alpha), (Aq,), None)
    jf = dhqr_tpu.qr(jnp.asarray(Aq.numpy()), block_size=8)
    okj, errj = jsearch._verify("qr", (jf.H, jf.alpha),
                                (jnp.asarray(Aq.numpy()),), None)
    assert ok and okj and err == pytest.approx(errj, rel=1e-3, abs=1e-15)
    broken = fact.H.clone()
    broken[0, 5] += 10.0
    assert not tsearch._verify("qr", (broken, fact.alpha), (Aq,), err)[0]


def test_lstsq_plan_auto_tunes_once_then_hits(tune_env):
    A, b = random_problem(192, 12, np.float32, seed=3)
    x = to_numpy(dt.lstsq(A, b, plan="auto", device="cpu"))
    assert normal_equations_residual(A, x, b) <= \
        TOLERANCE_FACTOR * oracle_residual(A, b)
    stored = tune.resolve_plan("lstsq", 192, 12, "float32", device="cpu",
                               on_miss="default")
    assert stored is not None
    entry = tune.default_db().get_entry(
        tune.plan_key("lstsq", 192, 12, "float32", device="cpu"))
    assert entry["source"] == "measured" and entry["candidates"] == len(
        tune.candidate_plans("lstsq", 192, 12, device="cpu"))
    assert entry["analytic_flops"] > 0 and "gflops" in entry
    x2 = to_numpy(dt.lstsq(A, b, plan="auto", device="cpu"))
    x3 = to_numpy(dt.lstsq(A, b, device="cpu", config=tune.
                           apply_plan_to_config(tconfig.DHQRConfig(),
                                                stored)))
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(x2, x3)
    # the JAX package's DB file reads the port's entry
    with open(tune_env / "plans.json") as fh:
        assert "torch-cpu:lstsq:192x12:float32:p1:-" in json.load(fh)["plans"]


def test_qr_plan_auto_records_and_applies(tune_env):
    A, _ = random_problem(128, 32, np.float32, seed=5)
    fact = dt.qr(A, plan="auto", device="cpu")
    stored = tune.resolve_plan("qr", 128, 32, "float32", device="cpu",
                               on_miss="default")
    assert stored is not None and stored.engine == "householder"
    assert fact.block_size == (stored.block_size or 128)
    QR = to_numpy(fact.q_columns()) @ to_numpy(fact.r_matrix())
    np.testing.assert_allclose(QR, A, atol=1e-3)


def test_tune_measurements_carry_the_residual_gate(tune_env):
    res = tune.tune("lstsq", 128, 8, repeats=1, device="cpu",
                    db=tune.PlanDB(str(tune_env / "gate.json")))
    timed = [m for m in res.measurements if m.seconds is not None]
    assert timed and len(res.measurements) == len(
        tune.candidate_plans("lstsq", 128, 8, device="cpu"))
    assert all(m.residual is not None and m.residual <= TOLERANCE_FACTOR
               for m in timed)
    assert res.key == "torch-cpu:lstsq:128x8:float32:p1:-"


def test_guarded_plan_failures_demote_the_key(tune_env):
    """Three rung-0 gate failures under an active stored plan demote the
    key: resolve_plan returns None and tune.plan_gate.* reads them."""
    A, b = random_problem(96, 12, np.float64, seed=2)
    key = tune.plan_key("lstsq", 96, 12, "float64", device="cpu")
    tune.default_db().record(key, tune.Plan(block_size=8))
    sites = tconfig.FaultConfig(sites=(("numeric.breakdown", 1.0, None,
                                        None),))
    for _ in range(tune.PLAN_DEMOTE_AFTER):
        with dt.faults.injected(tconfig.FaultConfig(
                sites=(("numeric.breakdown", 1.0, 1),))):
            res = dt.guarded_lstsq(A, b, plan="auto", device="cpu")
        assert res.attempts[0].outcome == "breakdown"
    assert sites.enabled
    assert tune.resolve_plan("lstsq", 96, 12, "float64",
                             device="cpu") is None
    snap = dt.obs.registry().snapshot()
    assert snap["tune.plan_gate.failures"] == 3
    assert snap["tune.plan_gate.demoted_keys"] == 1


# --------------------------------------------------------------- serve

def test_serve_prewarm_plan_auto_zero_miss_dispatch(tune_env):
    from dhqr_tpu_torch.serve import batched_lstsq, prewarm
    from dhqr_tpu_torch.serve.cache import ExecutableCache

    cache = ExecutableCache(max_size=16)
    keys = prewarm([(3, 60, 12)], kind="lstsq", plan="auto", cache=cache,
                   device="cpu")
    assert keys
    stored = tune.resolve_plan("serve_lstsq", keys[0].m, keys[0].n,
                               device="cpu", on_miss="default")
    assert stored is not None
    assert keys[0].block_size == min(stored.block_size or 32, keys[0].n)
    rng = np.random.default_rng(0)
    As = [rng.random((60, 12)).astype(np.float32) for _ in range(3)]
    bs = [rng.random(60).astype(np.float32) for _ in As]
    before = cache.stats()["misses"]
    xs = batched_lstsq(As, bs, plan="auto", cache=cache, device="cpu")
    assert cache.stats()["misses"] == before, "tuned dispatch recompiled"
    for A, b, x in zip(As, bs, xs):
        assert normal_equations_residual(A, to_numpy(x), b) <= \
            TOLERANCE_FACTOR * oracle_residual(A, b)


def test_serve_plan_refusals_match_jax(tune_env):
    from dhqr_tpu.serve import batched_lstsq as jbatched
    from dhqr_tpu.serve.engine import bucket_program as jbucket
    from dhqr_tpu_torch.serve import batched_lstsq
    from dhqr_tpu_torch.serve.engine import bucket_program

    A = np.ones((16, 4), np.float32)
    b = np.ones((16,), np.float32)
    for kw in (dict(plan=tune.Plan(), block_size=8),
               dict(plan=tune.Plan(engine="cholqr2"))):
        jkw = {k: (jtune.Plan(**v.__dict__) if isinstance(v, tune.Plan)
                   else v) for k, v in kw.items()}
        with pytest.raises(ValueError) as te:
            batched_lstsq([A], [b], device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            jbatched([jnp.asarray(A)], [jnp.asarray(b)], **jkw)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        bucket_program("lstsq", plan="auto")
    with pytest.raises(ValueError) as je:
        jbucket("lstsq", plan="auto")
    assert str(te.value) == str(je.value)


def test_serve_tune_times_the_bucket_program(tune_env):
    """A serve tune compiles each candidate's bucket program once (on the
    CPU the eager program) and times its calls; the winner's entry is the
    serve kind's, under the torch-cpu platform."""
    res = tune.tune("serve_qr", 64, 16, budget=3, repeats=1, device="cpu",
                    db=tune.PlanDB())
    assert [m.plan.describe() for m in res.measurements] == \
        ["householder", "householder+nb8", "householder+nb16"]
    assert all(m.seconds is not None for m in res.measurements)
    res = tune.tune("serve_lstsq", 64, 16, budget=2, repeats=1,
                    device="cpu", db=tune.PlanDB())
    assert all(m.residual <= TOLERANCE_FACTOR for m in res.measurements)


def test_every_jax_name_has_a_twin():
    """Every name of ``dhqr_tpu.__all__`` (64) is in the port's, and the
    tuner's and the armor seam's export lists are the JAX package's."""
    from dhqr_tpu import armor as jarmor
    from dhqr_tpu_torch import armor

    missing = sorted(set(dhqr_tpu.__all__) - set(dt.__all__))
    assert missing == [] and len(dhqr_tpu.__all__) == 64
    for name in dt.__all__:
        assert hasattr(dt, name), name
    assert set(tune.__all__) == set(jtune.__all__)
    assert set(armor.__all__) == set(jarmor.__all__)
    for name in ("TuneConfig", "ArmorConfig", "Plan", "PlanDB",
                 "resolve_plan"):
        assert getattr(dt, name) is not None, name


def test_mesh_tune_records_one_winner_on_every_rank(tune_env):
    """On a mesh every rank times the grid; rank 0's clock decides (one
    broadcast), so every rank records and dispatches the same plan, and
    the key counts the mesh's ranks."""
    from dhqr_tpu_torch.parallel._ranks import COLS, run_calls, run_ranks

    A, b = random_problem(64, 32, np.float32, seed=9)
    case = [("tune.tune", ("lstsq", 64, 32, "float32"),
             dict(mesh=COLS, budget=4, repeats=1, save=False)),
            ]
    per_rank = run_ranks(run_calls, 2, device="cpu", timeout_s=240,
                         cases=[case, [("lstsq", (A, b), dict(
                             mesh=COLS, plan="auto"))]])
    results = [r[0] for r in per_rank]
    assert all(r[0] == "ok" for r in results), results
    plans = {r[1].plan for r in results}
    assert len(plans) == 1 and results[0][1].key == \
        "torch-cpu:lstsq:64x32:float32:p2:-"
    assert [m.seconds for m in results[0][1].measurements] == \
        [m.seconds for m in results[1][1].measurements]
    xs = [r[1] for r in per_rank]
    assert all(x[0] == "ok" for x in xs), xs
    np.testing.assert_array_equal(xs[0][1], xs[1][1])
    assert normal_equations_residual(A, xs[0][1], b) <= \
        TOLERANCE_FACTOR * oracle_residual(A, b)
