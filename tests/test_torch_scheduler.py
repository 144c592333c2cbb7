"""PyTorch port: the async scheduler (``dhqr_tpu_torch.serve.scheduler``)
against ``dhqr_tpu.serve.scheduler``, on the CPU.

* **Parity.** The JAX scheduler and the port's run in manual mode
  (``start=False`` + ``poll()``) on ONE shared fake clock with the same
  seeded submissions (numpy): they must flush for the same reasons, take
  the same request sequence numbers in each flush, mint the same
  ``CacheKey``\\ s, and answer within 1e-4 relative (float32, 2-norm);
  ``SchedulerConfig.from_env`` reads the same environment the same way;
  the ``"update"`` kind answers within 1e-10 (float64) of the JAX session
  driven through the JAX scheduler on the same ops; traced, both record the
  same span names along submit -> flush -> dispatch -> retry -> resolve.
* **Twins** of every test of ``tests/test_scheduler.py``, on a stubbed
  ``engine._dispatch_groups`` (flush decisions) or the real engine (the
  key-parity pin), plus the fault paths: a transient ``serve.dispatch``
  retried, a NaN request under ``guards=`` isolated by bisection, a
  crashed worker respawned, a failed capture typed ``CompileFailed``
  through the future, a malformed ``plan=`` refused.
* **The device lanes** (the concurrent-replay fix of ``serve/cache.py``):
  programs are pinned round-robin to a device's lanes, and replays of two
  programs of one lane from two threads never overlap (a stand-in graph:
  the CPU has no CUDA graph).

No test can hang: every ``Future.result`` takes a timeout, and no wall
sleep is longer than 0.5 s.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu import obs as jobs  # noqa: E402
from dhqr_tpu.serve.cache import ExecutableCache as JCache  # noqa: E402
from dhqr_tpu.serve.scheduler import AsyncScheduler as JScheduler  # noqa: E402
from dhqr_tpu.solvers.update import UpdatableQR as JUpdatableQR  # noqa: E402
from dhqr_tpu.utils import config as jconfig  # noqa: E402
from dhqr_tpu.utils.testing import oracle_residual  # noqa: E402

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch import faults, obs  # noqa: E402
from dhqr_tpu_torch.serve import AsyncScheduler, BackpressureError  # noqa: E402
from dhqr_tpu_torch.serve import cache as tcache  # noqa: E402
from dhqr_tpu_torch.serve import engine as tengine  # noqa: E402
from dhqr_tpu_torch.serve import scheduler as tsched  # noqa: E402
from dhqr_tpu_torch.serve.cache import ExecutableCache  # noqa: E402
from dhqr_tpu_torch.utils import config as tconfig  # noqa: E402
from dhqr_tpu_torch.utils.config import (  # noqa: E402
    FaultConfig,
    SchedulerConfig,
    ServeConfig,
)
from dhqr_tpu_torch.utils.testing import normal_equations_residual  # noqa: E402

SCFG = ServeConfig(min_dim=16, ratio=1.5, max_batch=4, cache_size=8)
JSCFG = jconfig.ServeConfig(min_dim=16, ratio=1.5, max_batch=4, cache_size=8)
TOL_F32 = 1e-4     # ||x_port - x_jax|| / ||x_jax||, float32
TOL_F64 = 1e-10    # the same, float64 (the update kind)
RESULT_S = 10.0    # every Future.result's timeout


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt_s):
        self.now += dt_s


@pytest.fixture()
def stub(monkeypatch):
    """The engine dispatch replaced by an instant fake that records each
    flush's matrices."""
    calls = []

    def fake_dispatch(kind, As, bs, cfg, scfg, cache, consume, device,
                      trace_id=None, pol=None):
        calls.append(list(As))
        maxn = max(A.shape[1] for A in As)
        consume(list(range(len(As))), ("stub", len(As)),
                torch.zeros((len(As), maxn)))

    monkeypatch.setattr(tengine, "_dispatch_groups", fake_dispatch)
    return calls


def _sched(clock, **kw):
    kw.setdefault("serve_config", SCFG)
    kw.setdefault("device", "cpu")
    return AsyncScheduler(clock=clock, start=False, block_size=8, **kw)


def _req(rng, m=24, n=10):
    return (rng.random((m, n)).astype(np.float32),
            rng.random(m).astype(np.float32))


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------------ parity

def _flush_log(sched, log):
    """Record each flush's (reason, request sequence numbers) on
    ``sched`` before it runs."""
    inner = sched._flush

    def spy(group, taken, reason):
        log.append((reason, [p.seq for p in taken]))
        return inner(group, taken, reason)

    sched._flush = spy


def test_manual_mode_parity_flushes_keys_and_answers():
    """The same seeded stream on one fake clock: the same flush reasons,
    the same requests in each flush, the same cache keys, x within
    1e-4."""
    clock = FakeClock()
    kcfg = dict(slo_ms=1e4, flush_interval_ms=50.0,
                tenant_weights={"a": 3.0, "b": 1.0})
    js = JScheduler(clock=clock, start=False, serve_config=JSCFG,
                    sched_config=jconfig.SchedulerConfig(**kcfg),
                    cache=JCache(max_size=8, store=None), block_size=8)
    ts = _sched(clock, sched_config=SchedulerConfig(**kcfg),
                cache=ExecutableCache(max_size=8))
    jlog, tlog = [], []
    _flush_log(js, jlog)
    _flush_log(ts, tlog)
    rng = np.random.default_rng(21)
    shapes = [(24, 10), (19, 19)]
    jfuts, tfuts, problems = [], [], []
    for step in range(20):
        m, n = shapes[int(rng.integers(2))]
        A, b = _req(rng, m, n)
        deadline = float(rng.choice([0.03, 0.2, 5.0]))
        tenant = "ab"[int(rng.integers(2))]
        problems.append((A, b))
        jfuts.append(js.submit("lstsq", jnp.asarray(A), jnp.asarray(b),
                               deadline=deadline, tenant=tenant))
        tfuts.append(ts.submit("lstsq", A, b, deadline=deadline,
                               tenant=tenant))
        clock.advance(float(rng.choice([0.0, 0.0, 0.0, 0.01, 0.03])))
        assert js.poll() == ts.poll()
    clock.advance(0.1)
    assert js.poll() == ts.poll()
    js.drain()
    ts.drain()
    assert tlog == jlog and len(tlog) >= 4
    assert {r for r, _ in tlog} >= {"full", "deadline", "interval"}
    assert ts.keys_seen == js.keys_seen
    for (A, b), jf, tf in zip(problems, jfuts, tfuts):
        x = tf.result(timeout=RESULT_S)
        assert _rel(x.numpy(), jf.result(timeout=RESULT_S)) < TOL_F32
        assert normal_equations_residual(A, x.numpy(), b) <= \
            8.0 * oracle_residual(A, b)
    assert ts.stats()["flushes"] == js.stats()["flushes"]


_ENV = {"DHQR_SERVE_SLO_MS": "250", "DHQR_SERVE_QUEUE_DEPTH": "32",
        "DHQR_SERVE_FLUSH_INTERVAL_MS": "5",
        "DHQR_SERVE_TENANT_WEIGHTS": "acme:3, free-tier:0.5",
        "DHQR_SERVE_MAX_RETRIES": "4", "DHQR_SERVE_RETRY_BASE_MS": "2.5"}


@pytest.mark.parametrize("env", [{}, _ENV, {"DHQR_SERVE_SLO_MS": "1e3"}])
def test_scheduler_config_from_env_matches_jax(monkeypatch, env):
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    assert tconfig.SchedulerConfig.from_env() == \
        tconfig.SchedulerConfig(**jconfig.SchedulerConfig.from_env().__dict__)
    assert dataclass_fields(tconfig.SchedulerConfig) == \
        dataclass_fields(jconfig.SchedulerConfig)
    for bad in ({"queue_depth": 0}, {"slo_ms": 0.0},
                {"tenant_weights": {"a": 0.0}}, {"max_retries": -1}):
        with pytest.raises(ValueError):
            jconfig.SchedulerConfig(**bad)
        with pytest.raises(ValueError):
            tconfig.SchedulerConfig(**bad)
    assert tconfig._parse_tenant_weights("x:1,y:2.5") == \
        jconfig._parse_tenant_weights("x:1,y:2.5")


def dataclass_fields(cls):
    import dataclasses

    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_update_kind_matches_jax_session():
    """Six ops through each package's scheduler against each package's
    session, in submission order: the same refactor provenance, R and the
    solves within 1e-10 (float64)."""
    rng = np.random.default_rng(22)
    A = rng.standard_normal((40, 6))
    ops = []
    for k in range(6):
        if k in (2, 5):
            ops.append(("solve", rng.standard_normal(40)))
        else:
            u, v = 0.1 * rng.standard_normal(40), rng.standard_normal(6)
            ops.append(("update" if k % 2 == 0 else "downdate", u, v))
    jsess = JUpdatableQR(jnp.asarray(A), refactor_after=3)
    tsess = dt.UpdatableQR(A, refactor_after=3, device="cpu")
    js = JScheduler(start=False, cache=JCache(store=None))
    ts = AsyncScheduler(start=False, device="cpu",
                        cache=ExecutableCache())
    jf = [js.submit("update", jsess, tuple(
        jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in op))
        for op in ops]
    tf = [ts.submit("update", tsess, op) for op in ops]
    js.drain()
    ts.drain()
    for op, j, t in zip(ops, jf, tf):
        jv, tv = j.result(timeout=RESULT_S), t.result(timeout=RESULT_S)
        if op[0] == "solve":
            assert _rel(tv.numpy(), jv) < TOL_F64
        else:
            assert (tv["refactored"], tv["reason"],
                    tv["updates_since_refactor"]) == \
                (jv["refactored"], jv["reason"], jv["updates_since_refactor"])
    assert _rel(np.abs(tsess.r_matrix().numpy()),
                np.abs(np.asarray(jsess.r_matrix()))) < TOL_F64
    assert ts.stats()["dispatches"] == js.stats()["dispatches"] == 1


def _span_names(rec, tid):
    return [s.name for s in rec.spans_for(tid)]


def test_traced_fault_path_matches_jax():
    """A transient ``serve.dispatch`` fault, traced in both packages: the
    same span path submit -> flush -> dispatch -> retry -> flush ->
    dispatch -> dispatch_ok -> resolve, and the same answer."""
    clock = FakeClock()
    rng = np.random.default_rng(23)
    A, b = _req(rng)
    site = (("serve.dispatch", 1.0, 1),)
    with jobs.observed() as jrec, \
            jfaults_injected(jconfig.FaultConfig(sites=site)):
        js = JScheduler(clock=clock, start=False, serve_config=JSCFG,
                        cache=JCache(store=None), block_size=8)
        jfut = js.submit("lstsq", jnp.asarray(A), jnp.asarray(b),
                         deadline=5.0)
        js.drain()
        clock.advance(1.0)
        js.drain()
        jpath = _span_names(jrec, jfut.trace_id)
    with obs.observed() as trec, \
            faults.injected(FaultConfig(sites=site)):
        ts = _sched(clock, cache=ExecutableCache())
        tfut = ts.submit("lstsq", A, b, deadline=5.0)
        ts.drain()
        clock.advance(1.0)
        ts.drain()
        tpath = _span_names(trec, tfut.trace_id)
    assert tpath == jpath
    assert tpath[0] == "submit" and tpath[-1] == "resolve" and \
        "retry" in tpath
    assert _rel(tfut.result(timeout=RESULT_S).numpy(),
                jfut.result(timeout=RESULT_S)) < TOL_F32
    assert ts.stats()["retries"] == js.stats()["retries"] == 1


def test_typed_error_flight_dump_reads_the_whole_path():
    """A request whose dispatch keeps failing resolves typed, and
    ``obs.flight_dump_error`` reads its path from submit through the
    retry and the isolation to the resolve, as the JAX package's does."""
    clock = FakeClock()
    rng = np.random.default_rng(28)
    A, b = _req(rng)
    paths = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            armed, inject = jobs.observed(), jfaults_injected(
                jconfig.FaultConfig(sites=(("serve.dispatch", 1.0, None),)))
            s = JScheduler(clock=clock, start=False, serve_config=JSCFG,
                           cache=JCache(store=None), block_size=8)
            args = (jnp.asarray(A), jnp.asarray(b))
            dump = jobs.flight_dump_error
        else:
            armed, inject = obs.observed(), faults.injected(FaultConfig(
                sites=(("serve.dispatch", 1.0, None),)))
            s = _sched(clock, cache=ExecutableCache())
            args = (A, b)
            dump = obs.flight_dump_error
        with armed, inject:
            fut = s.submit("lstsq", *args, deadline=5.0)
            s.drain()
            err = fut.exception(timeout=1)
            dumps = dump(err)
        assert len(dumps) == 1
        paths.append([sp["name"] for sp in dumps[0]["spans"]])
        assert type(err).__name__ == "DispatchFailed"
    assert paths[1] == paths[0]
    assert paths[1][0] == "submit" and paths[1][-1] == "resolve"
    assert {"retry", "isolate"} <= set(paths[1])


def jfaults_injected(config):
    from dhqr_tpu import faults as jfaults

    return jfaults.injected(config)


# ------------------------------------------------------------------- twins

def test_deadline_flush_fires_at_budget_minus_ewma(stub):
    clock = FakeClock()
    s = _sched(clock, sched_config=SchedulerConfig(slo_ms=1e4,
                                                   flush_interval_ms=1e4))
    rng = np.random.default_rng(0)
    A, b = _req(rng)
    fut = s.submit("lstsq", A, b, deadline=0.5)
    assert s.poll() == 0 and not fut.done()
    clock.advance(0.4)
    assert s.poll() == 0 and not fut.done()
    clock.advance(0.11)
    assert s.poll() == 1 and fut.done()
    st = s.stats()
    assert st["flushes"]["deadline"] == 1 and st["completed"] == 1
    ewma = s._ewma[next(iter(s._ewma))]
    ewma.update(0.2)
    lead = 1.25 * ewma.value + 1e-3
    assert lead > 0.05
    submit_at = clock.now
    fut2 = s.submit("lstsq", A, b, deadline=0.5)
    clock.now = submit_at + 0.5 - lead - 0.01
    assert s.poll() == 0 and not fut2.done()
    clock.now = submit_at + 0.5 - lead + 0.01
    assert s.poll() == 1 and fut2.done()


def test_full_flush_at_max_batch_and_chunk_isolation(stub):
    clock = FakeClock()
    s = _sched(clock)
    rng = np.random.default_rng(1)
    futs = [s.submit("lstsq", *_req(rng), deadline=1e3) for _ in range(5)]
    assert s.poll() == 1
    assert [f.done() for f in futs] == [True] * 4 + [False]
    assert s.stats()["flushes"]["full"] == 1
    assert len(stub[0]) == 4 and s.queue_depth() == 1


def test_interval_flush_bounds_coalescing_wait(stub):
    clock = FakeClock()
    s = _sched(clock, sched_config=SchedulerConfig(
        slo_ms=1e6, flush_interval_ms=100.0))
    rng = np.random.default_rng(2)
    fut = s.submit("lstsq", *_req(rng))
    clock.advance(0.09)
    assert s.poll() == 0
    clock.advance(0.02)
    assert s.poll() == 1 and fut.done()
    assert s.stats()["flushes"]["interval"] == 1


def test_weighted_round_robin_fairness(stub):
    clock = FakeClock()
    s = _sched(clock, sched_config=SchedulerConfig(
        slo_ms=1e6, flush_interval_ms=1e6,
        tenant_weights={"a": 3.0, "b": 1.0}))
    rng = np.random.default_rng(3)
    a_mats, b_mats = [], []
    for _ in range(6):
        A, b = _req(rng)
        a_mats.append(A)
        s.submit("lstsq", A, b, tenant="a", deadline=1e3)
    for _ in range(2):
        A, b = _req(rng)
        b_mats.append(A)
        s.submit("lstsq", A, b, tenant="b", deadline=1e3)
    assert s.poll() == 2
    first = stub[0]
    n_b = sum(1 for A in first if any(A is Bm for Bm in b_mats))
    assert len(first) == 4 and n_b == 1
    a_order = [A for A in first if any(A is Am for Am in a_mats)]
    assert [id(x) for x in a_order] == [id(x) for x in a_mats[:3]]


def test_oldest_request_always_in_partial_flush(stub):
    clock = FakeClock()
    s = _sched(clock, sched_config=SchedulerConfig(
        slo_ms=1e6, flush_interval_ms=100.0,
        tenant_weights={"a": 5.0, "b": 1.0}))
    rng = np.random.default_rng(11)
    Ab, bb = _req(rng)
    s.submit("lstsq", Ab, bb, tenant="b", deadline=1e3)
    for _ in range(2):
        s.submit("lstsq", *_req(rng), tenant="a", deadline=1e3)
    clock.advance(0.11)
    assert s.poll() >= 1
    assert any(A is Ab for A in stub[0])


def test_wrr_credit_persists_across_partial_flushes(stub):
    clock = FakeClock()
    s = _sched(clock, sched_config=SchedulerConfig(
        slo_ms=1e6, flush_interval_ms=1e6,
        tenant_weights={"a": 5.0, "b": 1.0}))
    rng = np.random.default_rng(12)
    for tenant in ("a", "a", "b"):
        s.submit("lstsq", *_req(rng), tenant=tenant, deadline=1e3)
    (group,) = s._groups.values()
    with s._lock:
        taken = s._take_locked(group, 2)
    assert [p.tenant for p in taken] == ["a", "a"]
    assert group.credits == {"b": pytest.approx(2.0)}
    with s._lock:
        taken2 = s._take_locked(group, 1)
    assert [p.tenant for p in taken2] == ["b"]


def test_cancelled_future_is_skipped_not_fatal(stub):
    clock = FakeClock()
    s = _sched(clock, sched_config=SchedulerConfig(slo_ms=1e6,
                                                   flush_interval_ms=1e6))
    rng = np.random.default_rng(13)
    A1, b1 = _req(rng)
    A2, b2 = _req(rng)
    f1 = s.submit("lstsq", A1, b1, deadline=1e3)
    f2 = s.submit("lstsq", A2, b2, deadline=1e3)
    assert f1.cancel()
    s.drain()
    assert f1.cancelled() and f2.done() and not f2.cancelled()
    assert len(stub) == 1 and len(stub[0]) == 1 and stub[0][0] is A2
    st = s.stats()
    assert st["cancelled"] == 1 and st["completed"] == 1
    f3 = s.submit("lstsq", A1, b1, deadline=1e3)
    s.drain()
    assert f3.done() and not f3.cancelled()
    f4 = s.submit("lstsq", A1, b1, deadline=1e3)
    f4.cancel()
    s.drain()
    assert f4.cancelled() and s.stats()["cancelled"] == 2
    assert len(stub) == 2


def test_backpressure_rejects_with_retry_after(stub):
    clock = FakeClock()
    s = _sched(clock, sched_config=SchedulerConfig(
        slo_ms=1e6, flush_interval_ms=50.0, queue_depth=4))
    rng = np.random.default_rng(4)
    reqs = [_req(rng) for _ in range(5)]
    for A, b in reqs[:4]:
        s.submit("lstsq", A, b, deadline=1e3)
    with pytest.raises(BackpressureError) as exc:
        s.submit("lstsq", *reqs[4], deadline=1e3)
    assert exc.value.retry_after >= 0.05
    assert s.stats()["rejected"] == 1
    s.drain()
    fut = s.submit("lstsq", *reqs[4], deadline=1e3)
    s.drain()
    assert fut.done()


def test_policy_groups_do_not_cross_batch(stub):
    clock = FakeClock()
    s = _sched(clock)
    rng = np.random.default_rng(5)
    A, b = _req(rng)
    f1 = s.submit("lstsq", A, b, deadline=1e3)
    f2 = s.submit("lstsq", A, b, deadline=1e3, policy="fast")
    s.drain()
    assert f1.done() and f2.done()
    assert len(stub) == 2 and all(len(c) == 1 for c in stub)


def test_submit_rejections(stub):
    clock = FakeClock()
    s = _sched(clock)
    rng = np.random.default_rng(6)
    A, b = _req(rng)
    with pytest.raises(ValueError, match="right-hand side"):
        s.submit("lstsq", A)
    with pytest.raises(ValueError, match="no right-hand side"):
        s.submit("qr", A, b)
    with pytest.raises(ValueError, match="deadline"):
        s.submit("lstsq", A, b, deadline=0.0)
    with pytest.raises(ValueError, match="kind"):
        s.submit("svd", A, b)
    with pytest.raises(ValueError, match="tall"):
        s.submit("lstsq", A.T, np.zeros((10,), np.float32))
    s_refine = _sched(clock, refine=1)
    with pytest.raises(ValueError, match="batched_lstsq only"):
        s_refine.submit("qr", A)
    # plan= takes "auto", "default", None or a Plan, as on the sync tier
    with pytest.raises(ValueError, match="plan must be"):
        s.submit("lstsq", A, b, plan="fast-plan")
    # the card is the default device, and refused without one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AsyncScheduler(start=False)


def test_drain_shutdown_and_thread_lifecycle(stub):
    rng = np.random.default_rng(7)
    s = AsyncScheduler(serve_config=SCFG, block_size=8, device="cpu",
                       sched_config=SchedulerConfig(slo_ms=1e6,
                                                    flush_interval_ms=1e6))
    futs = [s.submit("lstsq", *_req(rng), deadline=1e3) for _ in range(3)]
    s.drain(timeout=10.0)
    assert all(f.done() for f in futs)
    assert s.stats()["flushes"]["drain"] >= 1
    s.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        s.submit("lstsq", *_req(rng))
    s.shutdown()
    s2 = AsyncScheduler(serve_config=SCFG, block_size=8, start=False,
                        device="cpu",
                        sched_config=SchedulerConfig(slo_ms=1e6,
                                                     flush_interval_ms=1e6))
    fut = s2.submit("lstsq", *_req(rng), deadline=1e3)
    s2.shutdown(drain=False)
    assert fut.cancelled()


def test_dispatch_failure_fails_futures(monkeypatch):
    def boom(kind, As, bs, cfg, scfg, cache, consume, device,
             trace_id=None, pol=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(tengine, "_dispatch_groups", boom)
    clock = FakeClock()
    s = _sched(clock)
    rng = np.random.default_rng(8)
    fut = s.submit("lstsq", *_req(rng), deadline=1e3)
    s.drain()
    with pytest.raises(RuntimeError, match="boom"):
        fut.result(timeout=1)
    assert isinstance(fut.exception(timeout=1), dt.DispatchFailed)
    assert s.stats()["failed"] == 1


def test_scheduler_config_from_env(monkeypatch):
    monkeypatch.setenv("DHQR_SERVE_SLO_MS", "250")
    monkeypatch.setenv("DHQR_SERVE_QUEUE_DEPTH", "32")
    monkeypatch.setenv("DHQR_SERVE_FLUSH_INTERVAL_MS", "5")
    monkeypatch.setenv("DHQR_SERVE_TENANT_WEIGHTS", "acme:3, free-tier:0.5")
    cfg = SchedulerConfig.from_env(queue_depth=16)
    assert (cfg.slo_ms, cfg.queue_depth, cfg.flush_interval_ms) == \
        (250.0, 16, 5.0)
    assert cfg.weight_for("acme") == 3.0
    assert cfg.weight_for("free-tier") == 0.5
    assert cfg.weight_for("unnamed") == 1.0
    with pytest.raises(ValueError, match="weight"):
        SchedulerConfig(tenant_weights={"a": 0.0})
    with pytest.raises(ValueError, match="name:weight"):
        SchedulerConfig.from_env(
            tenant_weights=tconfig._parse_tenant_weights("acme=3"))
    with pytest.raises(ValueError, match="queue_depth"):
        SchedulerConfig(queue_depth=0)


def test_async_shares_sync_dispatch_path_key_parity():
    """A stream dispatched by the scheduler mints exactly the keys
    ``batched_lstsq`` mints for the same requests: a cache prewarmed
    through the sync tier serves the queue with no miss, and the answers
    equal the sync tier's bit for bit."""
    rng = np.random.default_rng(9)
    shapes = [(24, 10), (24, 10), (19, 19), (24, 10)]
    As = [rng.random(s).astype(np.float32) for s in shapes]
    bs = [rng.random(s[0]).astype(np.float32) for s in shapes]
    sync_cache = ExecutableCache(max_size=8)
    xs_sync = dt.batched_lstsq(As, bs, block_size=8, serve_config=SCFG,
                               cache=sync_cache, device="cpu")
    acache = ExecutableCache(max_size=8)
    tengine.prewarm([(3, 24, 10), (1, 19, 19)], block_size=8,
                    serve_config=SCFG, cache=acache, device="cpu")
    warm = acache.stats()["misses"]
    s = AsyncScheduler(serve_config=SCFG, cache=acache, block_size=8,
                       start=False, device="cpu",
                       sched_config=SchedulerConfig(slo_ms=1e6,
                                                    flush_interval_ms=1e6))
    futs = [s.submit("lstsq", A, b, deadline=1e3, tenant=f"t{i % 2}")
            for i, (A, b) in enumerate(zip(As, bs))]
    s.drain()
    assert acache.stats()["misses"] == warm
    for key in s.keys_seen:
        assert key in sync_cache, key
    for f, x_sync in zip(futs, xs_sync):
        assert torch.equal(f.result(timeout=1), x_sync)
    fact_sync = dt.batched_qr(As[:1], block_size=8, serve_config=SCFG,
                              cache=sync_cache, device="cpu")[0]
    fq = s.submit("qr", As[0], deadline=1e3)
    s.drain()
    fact = fq.result(timeout=1)
    assert torch.equal(fact.H, fact_sync.H)
    assert torch.equal(fact.alpha, fact_sync.alpha)
    assert s.latency.count == len(As) + 1
    assert s.stats()["latency"]["p99_ms"] > 0


def test_submit_threads_race_single_dispatcher(stub):
    clock = FakeClock()
    s = _sched(clock, sched_config=SchedulerConfig(
        slo_ms=1e6, flush_interval_ms=1e6, queue_depth=4096))
    rng = np.random.default_rng(10)
    A, b = _req(rng)
    futs, errs = [], []
    lock = threading.Lock()

    def submitter():
        try:
            mine = [s.submit("lstsq", A, b, deadline=1e3)
                    for _ in range(25)]
            with lock:
                futs.extend(mine)
        except Exception as e:  # pragma: no cover - the failure under test
            errs.append(e)

    threads = [threading.Thread(target=submitter) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=RESULT_S)
    assert not errs, errs
    s.drain()
    assert len(futs) == 100 and all(f.done() for f in futs)
    st = s.stats()
    assert st["submitted"] == 100 and st["completed"] == 100
    assert st["queue_depth"] == 0


# ------------------------------------------------------------- fault paths

def test_nan_request_is_isolated_by_bisection():
    """Under ``guards=``, a NaN request fails alone (typed Breakdown) by
    bisection while its seven batch neighbours succeed."""
    rng = np.random.default_rng(24)
    reqs = [_req(rng) for _ in range(8)]
    reqs[5][0][2, 3] = np.nan
    s = AsyncScheduler(serve_config=ServeConfig(min_dim=16, ratio=1.5,
                                                max_batch=8),
                       block_size=8, start=False, guards="fallback",
                       device="cpu", cache=ExecutableCache())
    futs = [s.submit("lstsq", A, b, deadline=1e3) for A, b in reqs]
    s.drain()
    for i, f in enumerate(futs):
        if i == 5:
            assert isinstance(f.exception(timeout=1), dt.Breakdown)
        else:
            assert bool(torch.isfinite(f.result(timeout=1)).all())
    st = s.stats()
    assert st["bisections"] >= 1 and st["poisoned"] == 1
    assert st["completed"] == 7 and st["failed"] == 1


def test_worker_crash_respawns_and_resolves_everything():
    """The ``serve.worker`` site kills the first two worker loops: both
    are replaced and every future resolves."""
    rng = np.random.default_rng(25)
    with faults.injected(FaultConfig(sites=(("serve.worker", 1.0, 2),))):
        s = AsyncScheduler(serve_config=SCFG, block_size=8, workers=1,
                           device="cpu", cache=ExecutableCache(),
                           sched_config=SchedulerConfig(
                               slo_ms=1e4, flush_interval_ms=5.0))
        futs = [s.submit("lstsq", *_req(rng), deadline=10.0)
                for _ in range(6)]
        xs = [f.result(timeout=RESULT_S) for f in futs]
    assert all(x.shape == (10,) for x in xs)
    st = s.stats()
    assert st["worker_crashes"] == 2 and "FaultInjected" in \
        st["last_worker_crash"]
    assert st["completed"] == 6
    s.shutdown(timeout=RESULT_S)


def test_failed_capture_is_compile_failed_through_the_future():
    """A compile that raises reaches the futures typed: the lone
    request's immediate re-dispatch meets the quarantine, the next
    request inside the cooldown is Quarantined, and nothing entered the
    cache (no eager run in its place), as in the JAX package."""
    outcomes = []
    for pkg in ("jax", "torch"):
        clock = FakeClock()
        rng = np.random.default_rng(26)
        if pkg == "jax":
            cache = JCache(quarantine_s=60.0, clock=clock, store=None)
            s = JScheduler(clock=clock, start=False, serve_config=JSCFG,
                           cache=cache, block_size=8,
                           sched_config=jconfig.SchedulerConfig(
                               max_retries=0))
            inject = jfaults_injected(jconfig.FaultConfig(
                sites=(("serve.compile", 1.0, 1),)))
            conv = jnp.asarray
        else:
            cache = ExecutableCache(quarantine_s=60.0, clock=clock)
            s = _sched(clock, cache=cache,
                       sched_config=SchedulerConfig(max_retries=0))
            inject = faults.injected(FaultConfig(
                sites=(("serve.compile", 1.0, 1),)))
            conv = np.asarray
        with inject:
            futs = []
            for _ in range(2):
                A, b = _req(rng)
                futs.append(s.submit("lstsq", conv(A), conv(b),
                                     deadline=1.0))
                s.drain()
        errs = [f.exception(timeout=1) for f in futs]
        outcomes.append([type(e).__name__ for e in errs])
        assert len(cache) == 0 and cache.stats()["compile_failures"] == 1
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][1] == "Quarantined"
    assert outcomes[1][0] in ("CompileFailed", "Quarantined")


def test_dispatch_program_is_the_engines():
    prog = tsched.dispatch_program("lstsq", block_size=8)
    A = torch.eye(24, 10).expand(2, 24, 10).clone()
    assert torch.equal(prog(A, torch.ones(2, 24)),
                       tengine.bucket_program("lstsq", block_size=8)(
                           A, torch.ones(2, 24)))


# -------------------------------------------------- the device lane (step 0)

def test_keys_pinned_round_robin_to_the_device_lanes():
    lanes = tcache.device_lanes("cpu")
    assert lanes is tcache.device_lanes(torch.device("cpu"))
    assert len(lanes) == tcache.LANES_PER_DEVICE
    assert len({id(lane) for lane in lanes}) == len(lanes)
    assert all(lane.stream is None for lane in lanes)   # the CPU: locks
    progs = [tcache.BucketProgram(lambda A: A, "cpu", "eager")
             for _ in range(2 * len(lanes))]
    first = lanes.index(progs[0].lane)
    assert [lanes.index(p.lane) for p in progs] == \
        [(first + i) % len(lanes) for i in range(len(progs))]


class _OverlapGraph:
    """A stand-in graph whose replay takes a while and records whether
    another replay of ANY program ran at the same time."""

    active = 0
    overlaps = 0
    guard = threading.Lock()

    def __init__(self, fn, static_in, static_out):
        self.fn, self.static_in, self.static_out = fn, static_in, static_out

    def replay(self):
        with _OverlapGraph.guard:
            _OverlapGraph.active += 1
            if _OverlapGraph.active > 1:
                _OverlapGraph.overlaps += 1
        time.sleep(0.001)
        for o, r in zip(self.static_out, (self.fn(*self.static_in),)):
            o.copy_(r)
        with _OverlapGraph.guard:
            _OverlapGraph.active -= 1


def _standin(scale, lane):
    fn = lambda A: A * scale  # noqa: E731
    static = (torch.zeros(4, 4),)
    prog = tcache.BucketProgram(fn, "cpu", "cuda_graph")
    prog.lane = lane
    prog.static_inputs, prog.static_outputs = static, (torch.zeros(4, 4),)
    prog.single_output = True
    prog.graph = _OverlapGraph(fn, static, prog.static_outputs)
    return prog


def test_replays_of_two_programs_of_one_lane_never_overlap():
    """Two programs pinned to one lane, each replayed 50 times from its
    own thread: no two replays overlap, and every output equals the
    serial replay's."""
    lane = tcache.device_lanes("cpu")[0]
    progs = [_standin(2.0, lane), _standin(3.0, lane)]
    inputs = [torch.full((4, 4), float(i)) for i in range(50)]
    serial = [[p(x).clone() for x in inputs] for p in progs]
    _OverlapGraph.overlaps = 0
    got = [[None] * len(inputs) for _ in progs]

    def worker(k):
        for i, x in enumerate(inputs):
            got[k][i] = progs[k](x)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=RESULT_S)
    assert _OverlapGraph.overlaps == 0
    for k in (0, 1):
        assert all(torch.equal(g, s) for g, s in zip(got[k], serial[k]))
