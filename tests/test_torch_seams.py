"""PyTorch port: the shared seams — ``faults`` (the injection harness and
its schedules), ``obs`` (trace recorder, flight recorder), ``armor.errors``,
``utils.lockwitness``, ``FaultConfig`` / ``ObsConfig`` and
``tune.db.policy_tag`` — against their twins in the JAX package.

Everything here is exact: a schedule string parses to the same config in
both packages, a seeded schedule fires on the same visits, the same span
sequence dumps to the same records, and the same nestings witness the same
lock-order edges. Threaded cases join with a time limit.
"""

import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

from dhqr_tpu import faults as jfaults  # noqa: E402
from dhqr_tpu.armor import errors as jarmor  # noqa: E402
from dhqr_tpu.obs import recorder as jrecorder  # noqa: E402
from dhqr_tpu.obs import trace as jtrace  # noqa: E402
from dhqr_tpu.precision import PrecisionPolicy as JPolicy  # noqa: E402
from dhqr_tpu.tune.db import policy_tag as jpolicy_tag  # noqa: E402
from dhqr_tpu.utils import config as jconfig  # noqa: E402
from dhqr_tpu.utils import lockwitness as jlw  # noqa: E402

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch import faults  # noqa: E402
from dhqr_tpu_torch import obs  # noqa: E402
from dhqr_tpu_torch.armor import errors as tarmor  # noqa: E402
from dhqr_tpu_torch.obs import recorder as trecorder  # noqa: E402
from dhqr_tpu_torch.obs import trace as ttrace  # noqa: E402
from dhqr_tpu_torch.precision import PrecisionPolicy  # noqa: E402
from dhqr_tpu_torch.tune.db import policy_tag  # noqa: E402
from dhqr_tpu_torch.utils import config as tconfig  # noqa: E402
from dhqr_tpu_torch.utils import lockwitness as tlw  # noqa: E402

JOIN_S = 10.0  # every thread of a threaded case must end within this


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


def _message(fn):
    try:
        fn()
    except Exception as exc:  # the refusal, compared across packages
        return type(exc).__name__, str(exc)
    return None


# ------------------------------------------------------------ the harness


def test_site_table_and_exports_match_jax():
    assert faults.SITES == jfaults.SITES
    assert faults.__all__ == jfaults.__all__


def test_disarmed_harness_is_a_noop():
    faults.uninstall()
    faults.fire("numeric.breakdown")    # no harness: must not raise
    faults.fire("serve.dispatch")
    faults.latency()
    assert faults.active() is None and not faults.wire_sites_armed()
    outer = tconfig.FaultConfig(sites=(("numeric.nan", 1.0, 1),))
    inner = tconfig.FaultConfig(sites=(("numeric.breakdown", 1.0, 1),))
    e0 = faults.epoch()
    with faults.injected(outer) as h_outer:
        assert faults.active() is h_outer
        with faults.injected(inner):
            with pytest.raises(faults.FaultInjected,
                               match="numeric.breakdown"):
                faults.fire("numeric.breakdown")
        assert faults.active() is h_outer
    assert faults.active() is None
    assert faults.epoch() == e0 + 4  # two arms, two restores
    # an empty config arms nothing
    assert faults.install(tconfig.FaultConfig()).stats() == {}
    assert faults.active() is None
    h = faults.FaultHarness(tconfig.FaultConfig(
        sites=(("serve.latency", 1.0, 1),)))
    with pytest.raises(ValueError, match="raise-kind"):
        h.fire("serve.latency")
    with pytest.raises(ValueError, match="sleep-kind"):
        h.latency("numeric.nan")


SCHEDULES = [
    "numeric.breakdown:1.0:1",
    "numeric.breakdown:1.0:2, numeric.nan:0.5",
    "serve.compile:0.5, serve.dispatch:0.25:3",
    "parallel.collective.corrupt:1.0:1:3, serve.dispatch:0.25:3",
    "numeric.breakdown:0.3:5:2",
    " , numeric.nan:1.0 ,",
]


@pytest.mark.parametrize("raw", SCHEDULES)
def test_schedule_strings_parse_the_same(monkeypatch, raw):
    monkeypatch.setenv("DHQR_FAULTS", raw)
    monkeypatch.setenv("DHQR_FAULTS_SEED", "7")
    monkeypatch.setenv("DHQR_FAULTS_LATENCY_MS", "2.5")
    mine, theirs = tconfig.FaultConfig.from_env(), \
        jconfig.FaultConfig.from_env()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.enabled == theirs.enabled


@pytest.mark.parametrize("bad", [
    lambda c: c._parse_fault_sites("serve.compile"),
    lambda c: c._parse_fault_sites("numeric.nan:1.0:1:3:9"),
    lambda c: c._parse_fault_sites(":1.0"),
    lambda c: c.FaultConfig(sites=(("numeric.nan", 1.5, None),)),
    lambda c: c.FaultConfig(sites=(("numeric.nan", 1.0, 0),)),
    lambda c: c.FaultConfig(sites=(("numeric.nan", 1.0, 1, 0),)),
    lambda c: c.FaultConfig(sites=(("numeric.nan", 1.0),)),
    lambda c: c.FaultConfig(latency_ms=-1.0),
], ids=["no-prob", "five-fields", "no-site", "prob", "count", "from-visit",
        "two-tuple", "latency"])
def test_config_refusals_match_jax(bad):
    got = _message(lambda: bad(tconfig))
    assert got is not None and got == _message(lambda: bad(jconfig))


def test_dict_sites_normalize_the_same():
    sites = {"numeric.nan": 0.5, "numeric.breakdown": (1.0, 2, 3)}
    assert tconfig.FaultConfig(sites=sites).sites == \
        jconfig.FaultConfig(sites=sites).sites


@pytest.mark.parametrize("sites,seed", [
    ((("numeric.breakdown", 0.4, None), ("numeric.nan", 1.0, 2)), 42),
    ((("numeric.breakdown", 0.1, 7, 5),), 3),
    ((("serve.dispatch", 0.7, None, 2), ("numeric.nan", 0.25, 4)), 0),
])
def test_seeded_schedules_fire_on_the_same_visits(sites, seed):
    cfg = dict(sites=sites, seed=seed)
    mine = faults.FaultHarness(tconfig.FaultConfig(**cfg))
    theirs = jfaults.FaultHarness(jconfig.FaultConfig(**cfg))
    names = [s[0] for s in sites]
    seq_t = [[mine.should_fire(n) for n in names] for _ in range(200)]
    seq_j = [[theirs.should_fire(n) for n in names] for _ in range(200)]
    assert seq_t == seq_j and any(map(any, seq_t))
    assert mine.stats() == theirs.stats()


def test_kth_visit_segment():
    h = faults.FaultHarness(tconfig.FaultConfig(
        sites=(("numeric.breakdown", 1.0, 1, 4),)))
    fires = [h.should_fire("numeric.breakdown") for _ in range(6)]
    assert fires == [False, False, False, True, False, False]
    assert h.stats()["numeric.breakdown"] == {"visits": 6, "fired": 1}
    h2 = faults.FaultHarness(tconfig.FaultConfig(
        sites=(("numeric.breakdown", 1.0, None, 3),)))
    assert [h2.should_fire("numeric.breakdown") for _ in range(5)] \
        == [False, False, True, True, True]
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultHarness(tconfig.FaultConfig(sites=(("nope", 1.0, 1),)))


def test_suspended_is_thread_local():
    with faults.injected(tconfig.FaultConfig(
            sites=(("numeric.breakdown", 1.0, None),))) as h:
        with faults.suspended():
            faults.fire("numeric.breakdown")   # inert: no raise, no visit
            seen = []
            t = threading.Thread(target=lambda: seen.append(faults.active()))
            t.start()
            _join([t])
            assert seen == [h]
        with pytest.raises(faults.FaultInjected):
            faults.fire("numeric.breakdown")
    assert h.stats()["numeric.breakdown"] == {"visits": 1, "fired": 1}


def test_latency_site_uses_injected_sleeper():
    slept = []
    cfg = tconfig.FaultConfig(sites=(("serve.latency", 1.0, 2),),
                              latency_ms=50.0)
    h = faults.FaultHarness(cfg, sleeper=slept.append)
    for _ in range(4):
        h.latency("serve.latency")
    assert slept == [0.05, 0.05]


def test_concurrent_visits_count_exactly():
    """prob 1 with a count is interleaving-independent: 8 threads x 50
    visits fire exactly the count, and every visit is accounted."""
    h = faults.FaultHarness(tconfig.FaultConfig(
        sites=(("numeric.breakdown", 1.0, 37),)))
    fired = []

    def visit():
        fired.append(sum(h.should_fire("numeric.breakdown")
                         for _ in range(50)))

    threads = [threading.Thread(target=visit) for _ in range(8)]
    for t in threads:
        t.start()
    _join(threads)
    assert sum(fired) == 37
    assert h.stats()["numeric.breakdown"] == {"visits": 400, "fired": 37}


# ------------------------------------------------------------ obs


def test_disarmed_obs_mints_nothing():
    obs.disarm()
    assert obs.active() is None and obs.mint() is None
    obs.event(None, "submit")
    obs.event(3, "submit")                 # disarmed: a no-op
    assert obs.flight_dump(3) == {"trace_id": 3, "spans": []}
    assert obs.flight_dump_error(RuntimeError("x")) == []
    assert obs.arm() is None and obs.active() is None  # nothing configured
    assert jtrace.mint() is None


@pytest.mark.parametrize("env", [
    {"DHQR_OBS": "1", "DHQR_OBS_BUFFER": "64", "DHQR_OBS_DUMP": "stderr"},
    {"DHQR_OBS": "off", "DHQR_OBS_DUMP": "  ", "DHQR_OBS_PROFILE": ""},
    {"DHQR_OBS_XRAY": "yes", "DHQR_OBS_XRAY_REPORTS": "7",
     "DHQR_OBS_PULSE": "0", "DHQR_OBS_PULSE_REPORTS": "9"},
])
def test_obs_config_from_env_matches_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(tconfig.ObsConfig.from_env()) == \
        dataclasses.asdict(jconfig.ObsConfig.from_env())
    for bad in ({"buffer_spans": 8}, {"xray_reports": 0},
                {"pulse_reports": 0}):
        assert _message(lambda: tconfig.ObsConfig(**bad)) == \
            _message(lambda: jconfig.ObsConfig(**bad))


@pytest.mark.parametrize("field", ["xray", "pulse"])
def test_xray_and_pulse_refuse_when_armed_not_built(field):
    cfg = tconfig.ObsConfig(enabled=True, **{field: True})  # constructs
    with pytest.raises(dt.NotPortedError, match="item 16"):
        obs.arm(cfg)
    assert obs.active() is None  # nothing was armed


def _drive(recorder_cls, obs_config_cls):
    """The same span sequence through one recorder; returns what reads it."""
    clock = iter(range(1000)).__next__
    rec = recorder_cls(obs_config_cls(enabled=True, buffer_spans=16),
                       clock=lambda: float(clock()))
    ids = [rec.mint() for _ in range(3)]
    for i in range(10):
        rec.event(ids[i % 3], "rung", engine="cholqr2", step=i)
    rec.event(ids[0], "resolve", outcome="ok")
    rec.event(None, "ignored")
    for i in range(8):                      # overflow the 16-span ring
        rec.event(ids[2], "rung", step=100 + i)
    err = RuntimeError("boom")
    rec.on_error(err, ids[1])
    rec.on_error(err, ids[2])
    return ([rec.dump(t) for t in ids], rec.stats(), rec.trace_ids(),
            err.trace_id, err.trace_ids)


def test_recorder_ring_and_dumps_match_jax():
    mine = _drive(ttrace.TraceRecorder, tconfig.ObsConfig)
    theirs = _drive(jtrace.TraceRecorder, jconfig.ObsConfig)
    assert mine == theirs
    assert mine[1]["dropped"] == 3 and mine[1]["spans"] == 16


def test_observed_scopes_nest_and_floor_ids():
    obs.disarm()
    with obs.observed() as outer:
        a = obs.mint()
        with obs.observed() as inner:
            b = obs.mint()
            assert obs.active() is inner and b > a
        assert obs.active() is outer
        obs.event(a, "submit", kind="x")
        assert [s.name for s in outer.spans_for(a)] == ["submit"]
    assert obs.active() is None


def test_flight_recorder_writes_and_reads_like_jax(tmp_path, capsys):
    err = ValueError("bad input")
    for mod_trace, mod_rec, cfg_cls, sub in (
            (ttrace, trecorder, tconfig.ObsConfig, "torch"),
            (jtrace, jrecorder, jconfig.ObsConfig, "jax")):
        rec = mod_trace.TraceRecorder(
            cfg_cls(enabled=True, auto_dump=str(tmp_path / sub)),
            clock=lambda: 1.5)
        tid = rec.mint()
        rec.event(tid, "submit", kind="guarded_lstsq", m=4, n=2)
        rec.event(tid, "resolve", outcome="ValueError", error=str(err))
        rec.on_error(err, tid)
        assert rec.stats()["error_dumps"] == 1
    paths = [next((tmp_path / sub).glob("flight_*.jsonl"))
             for sub in ("torch", "jax")]
    mine, theirs = trecorder.read_dump_file(paths[0]), \
        jrecorder.read_dump_file(paths[1])
    assert mine == theirs and mine[0]["error"] == "ValueError"
    assert trecorder.format_dump(mine[0]) == jrecorder.format_dump(mine[0])
    with open(paths[0], "a") as fh:
        fh.write("{not json\n")
    assert trecorder.read_dump_file(paths[0])[-1]["error"] == "DumpTruncated"


# ------------------------------------------------------------ armor errors


@pytest.mark.parametrize("name", ["ArmorError", "CorruptionDetected",
                                  "ShardFailure"])
def test_armor_errors_match_jax(name):
    tcls, jcls = getattr(tarmor, name), getattr(jarmor, name)
    assert [c.__name__ for c in tcls.__mro__] == \
        [c.__name__ for c in jcls.__mro__]
    kw = dict(engine="householder", label="blocked_qr[P=2]",
              shard_index=1.0, trace_id=4, recovery=["redispatch"])
    t, j = tcls("lost", **kw), jcls("lost", **kw)
    assert isinstance(t, dt.NumericalError) and str(t) == str(j)
    assert vars(t) == vars(j)
    assert t.shard_index == 1 and t.recovery == ("redispatch",)
    assert getattr(dt, name, tcls) is tcls


# ------------------------------------------------------------ lockwitness


def _nest(lw):
    a, b = lw.make_lock("A._lock"), lw.make_rlock("B._lock")
    c1, c2 = lw.make_lock("C._lock"), lw.make_lock("C._lock")
    with lw.witnessing() as w:
        with a:
            with b:
                with b:               # reentrant: no edge, no violation
                    pass
        with c1:
            with c2:                  # two instances of one name
                pass
        with lw.witness_region("flock"):
            with a:
                pass
        cond = threading.Condition(lw.make_lock("Cond._lock"))
        done = []

        def waiter():
            with cond:
                cond.wait_for(lambda: done, timeout=JOIN_S)

        t = threading.Thread(target=waiter)
        t.start()
        with cond:
            done.append(1)
            cond.notify_all()
        _join([t])
        with pytest.raises(RuntimeError, match="self-deadlock"):
            with a:
                a.acquire()   # refused before it blocks; the with releases
        assert not a.locked()
    return w.edges(), w.violations(), w.stats()


def test_lockwitness_matches_jax():
    mine, theirs = _nest(tlw), _nest(jlw)
    assert mine == theirs
    edges = mine[0]
    assert ("A._lock", "B._lock") in edges and ("C._lock", "C._lock") in edges
    assert ("flock", "A._lock") in edges
    assert tlw.active() is None


def test_lockwitness_disarmed_and_threads():
    tlw.disarm()
    lock = tlw.make_lock("X._lock")
    counter = []

    def bump():
        for _ in range(200):
            with lock:
                counter.append(1)

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    _join(threads)
    assert len(counter) == 800 and not lock.locked()
    with tlw.witnessing() as w:
        threads = [threading.Thread(target=bump) for _ in range(4)]
        for t in threads:
            t.start()
        _join(threads)
    assert w.stats() == {"acquires": 800, "edges": 0, "violations": 0}


def test_seams_use_witnessed_locks():
    """The harness and the recorder take their locks through the witness:
    arming a schedule under a witness records the install edge set the
    JAX package records."""
    def run(lw, flt, cfg_cls):
        with lw.witnessing() as w:
            with flt.injected(cfg_cls(sites=(("numeric.nan", 1.0, 1),))) \
                    as h:
                h.should_fire("numeric.nan")
        return w.edges(), w.stats()["violations"]

    assert run(tlw, faults, tconfig.FaultConfig) == \
        run(jlw, jfaults, jconfig.FaultConfig)


# ------------------------------------------------------------ policy_tag


@pytest.mark.parametrize("kw", [
    {}, {"panel": "high", "trailing": "default", "refine": 2},
    {"apply": "high"}, {"trailing": "high", "comms": "bf16"},
])
def test_policy_tag_matches_jax(kw):
    assert policy_tag(PrecisionPolicy(**kw)) == jpolicy_tag(JPolicy(**kw))
    assert policy_tag(None) == jpolicy_tag(None) == "-"
