"""PyTorch port: the batched serving tier (``dhqr_tpu_torch.serve``) against
the JAX package's ``dhqr_tpu.serve``, on the CPU.

* the bucket lattice, the padding and the cache keys are held EXACTLY to
  the JAX package's (the same request list and config mint the same key
  tuples and the same cross-process spelling);
* the batched solutions and factorizations are held to JAX's on the same
  numpy inputs: x within 1e-10 (float64) / 1e-4 (float32) relative in
  the 2-norm, H and alpha truncated to each request's shape within
  1e-10 / 1e-4 relative to their largest entry, and every x within the
  reference's 8x normal-equations criterion;
* row i of the stacked engine agrees with the port's own 2-D engine on
  the same padded matrix within 1e-12 (float64), its column norms bit
  for bit;
* the behaviour checks: prewarm then zero misses, the ``serve.dispatch``
  / ``serve.compile`` fault sites and the quarantine, the ``guards=``
  breakdown on a NaN request, the in-place factor stack, and the copy-out
  of a replayed program (on a stand-in graph: the CPU has no CUDA graph).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dhqr_tpu import faults as jfaults  # noqa: E402
from dhqr_tpu.numeric.errors import Breakdown as JBreakdown  # noqa: E402
from dhqr_tpu.serve import buckets as jbuckets  # noqa: E402
from dhqr_tpu.serve import engine as jengine  # noqa: E402
from dhqr_tpu.serve import errors as jerrors  # noqa: E402
from dhqr_tpu.serve.cache import CacheKey as JKey  # noqa: E402
from dhqr_tpu.serve.cache import ExecutableCache as JCache  # noqa: E402
from dhqr_tpu.serve.store import canonical_key as jcanonical  # noqa: E402
from dhqr_tpu.utils import config as jconfig  # noqa: E402
from dhqr_tpu.utils.testing import oracle_residual  # noqa: E402

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch import faults  # noqa: E402
from dhqr_tpu_torch.ops import blocked as tblocked  # noqa: E402
from dhqr_tpu_torch.ops.summation import tree_sum  # noqa: E402
from dhqr_tpu_torch.serve import buckets as tbuckets  # noqa: E402
from dhqr_tpu_torch.serve import cache as tcache  # noqa: E402
from dhqr_tpu_torch.serve import engine as tengine  # noqa: E402
from dhqr_tpu_torch.serve import errors as terrors  # noqa: E402
from dhqr_tpu_torch.utils import config as tconfig  # noqa: E402
from dhqr_tpu_torch.utils.testing import normal_equations_residual  # noqa: E402

TOL = {np.float64: 1e-10, np.float32: 1e-4}
TOL_ROW_F64 = 1e-12
CRITERION = 8.0
# the serving benchmark's small shapes (benchmarks/serving_throughput.py)
LADDER = [(64, 16), (100, 36), (128, 48), (192, 64)]


def _requests(n, dtype, seed, shapes=LADDER):
    rng = np.random.default_rng(seed)
    As = [rng.random(shapes[i % len(shapes)]).astype(dtype)
          for i in range(n)]
    bs = [rng.random(A.shape[0]).astype(dtype) for A in As]
    return As, bs


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _jcache():
    return JCache(store=None)


# ---------------------------------------------------------------- lattice

@pytest.mark.parametrize("kw", [{}, {"ratio": 1.5, "min_dim": 8},
                                {"ratio": 2.0, "min_dim": 32,
                                 "max_batch": 48}])
def test_lattice_matches_jax(kw):
    tcfg, jcfg = tconfig.ServeConfig(**kw), jconfig.ServeConfig(**kw)
    for x in range(1, 2100, 7):
        assert tbuckets.bucket_dim(x, tcfg) == jbuckets.bucket_dim(x, jcfg)
    for c in range(1, 300, 3):
        assert tbuckets.bucket_batch(c, tcfg) == \
            jbuckets.bucket_batch(c, jcfg)
    for m, n in [(64, 16), (100, 36), (640, 256), (17, 17), (5000, 3),
                 (16500, 64), (129, 128), (1, 1)]:
        for dtype in ("float32", "float64", "complex64"):
            got = tbuckets.plan_bucket(m, n, dtype, tcfg)
            want = jbuckets.plan_bucket(m, n, dtype, jcfg)
            assert (got.m, got.n, got.dtype, got.label) == \
                (want.m, want.n, want.dtype, want.label)
    assert tbuckets.plan_bucket(100, 36, torch.float32, tcfg) == \
        tbuckets.plan_bucket(100, 36, "float32", tcfg)


def test_padding_matches_jax():
    As, bs = _requests(3, np.float64, 1)
    bucket = tbuckets.plan_bucket(128, 48, "float64")
    jb = jbuckets.plan_bucket(128, 48, "float64")
    reqs = list(zip(As[1:3], bs[1:3]))
    A_t, b_t = tbuckets.pad_group(reqs, bucket, 4, "cpu")
    A_j, b_j = jbuckets.pad_group(reqs, jb, 4)
    np.testing.assert_array_equal(A_t.numpy(), A_j)
    np.testing.assert_array_equal(b_t.numpy(), b_j)
    # a group of tensors is stacked on the device: the same buffers
    A_d, b_d = tbuckets.pad_group(
        [(torch.from_numpy(A), torch.from_numpy(b)) for A, b in reqs],
        bucket, 4, "cpu")
    np.testing.assert_array_equal(A_d.numpy(), A_j)
    np.testing.assert_array_equal(b_d.numpy(), b_j)
    A_q, b_q = tbuckets.pad_group([(torch.from_numpy(A), None)
                                   for A, _ in reqs], bucket, 4, "cpu")
    np.testing.assert_array_equal(A_q.numpy(), A_j)
    assert b_q is None


def test_serve_config_matches_jax(monkeypatch):
    for k, v in {"DHQR_SERVE_RATIO": "1.5", "DHQR_SERVE_MIN_DIM": "24",
                 "DHQR_SERVE_MAX_BATCH": "48", "DHQR_SERVE_CACHE_SIZE": "9",
                 "DHQR_SERVE_QUARANTINE_S": "2.5"}.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(tconfig.ServeConfig.from_env()) == \
        dataclasses.asdict(jconfig.ServeConfig.from_env())
    for bad in ({"ratio": 1.0}, {"min_dim": 4}, {"max_batch": 0},
                {"cache_size": 0}, {"quarantine_s": 0}):
        with pytest.raises(ValueError) as te:
            tconfig.ServeConfig(**bad)
        with pytest.raises(ValueError) as je:
            jconfig.ServeConfig(**bad)
        assert str(te.value) == str(je.value)


def test_serve_errors_match_jax():
    key = ("k", 1)
    cause = RuntimeError("boom")
    for name in ("CompileFailed", "DispatchFailed"):
        t, j = getattr(terrors, name)(key, cause), \
            getattr(jerrors, name)(key, cause)
        assert str(t) == str(j) and t.key == key
    for ra in (5.0, 0.0, -3.0):
        t, j = terrors.Quarantined(key, ra), jerrors.Quarantined(key, ra)
        assert (str(t), t.retry_after) == (str(j), j.retry_after)
        assert t.retry_after > 0
        t = terrors.BackpressureError("full", ra)
        assert t.retry_after == jerrors.BackpressureError("full",
                                                          ra).retry_after
    assert terrors.ReplicaLost("gone", 2).attempts == 2
    for name in ("CompileFailed", "DispatchFailed", "DeadlineExceeded",
                 "Quarantined", "BackpressureError", "ReplicaLost"):
        assert issubclass(getattr(terrors, name), terrors.ServeError)
        assert getattr(dt, name) is getattr(terrors, name)
    assert issubclass(terrors.ServeError, RuntimeError)


# ------------------------------------------------------------------- keys

def _keys(pkg_engine, kind, As, scfg, **overrides):
    cfg, _pol, _ = pkg_engine._resolve_dispatch_cfg(kind, None, overrides)
    keys = []
    for bucket, idxs in pkg_engine._group_by_bucket(As, scfg).items():
        for lo in range(0, len(idxs), scfg.max_batch):
            chunk = idxs[lo:lo + scfg.max_batch]
            key, _ = pkg_engine._plan_key(kind, len(chunk), bucket.m,
                                          bucket.n, bucket.dtype, cfg, scfg)
            keys.append(key)
    return keys


@pytest.mark.parametrize("kind,overrides", [
    ("lstsq", {}), ("lstsq", {"policy": "accurate"}),
    ("lstsq", {"policy": "balanced"}), ("lstsq", {"policy": "fast"}),
    ("lstsq", {"refine": 2, "block_size": 16}),
    ("lstsq", {"trailing_precision": "high", "norm": "fast"}),
    ("qr", {}), ("qr", {"policy": "fast"}),
    ("qr", {"panel_impl": "recursive"}),
    ("sketch", {}), ("sketch", {"policy": "balanced"}),
    ("sketch", {"refine": 3})])
def test_cache_keys_match_jax(kind, overrides):
    As, _ = _requests(40, np.float32, 2,
                      LADDER + [(384, 128), (500, 180), (640, 256)])
    kw = {"max_batch": 8}
    got = _keys(tengine, kind, As, tconfig.ServeConfig(**kw), **overrides)
    want = _keys(jengine, kind, As, jconfig.ServeConfig(**kw), **overrides)
    assert [tuple(k) for k in got] == [tuple(k) for k in want]
    assert [tcache.canonical_key(k) for k in got] == \
        [jcanonical(k) for k in want]


def test_config_refusals_match_jax():
    for kind, over in [("lstsq", {"engine": "tsqr"}),
                       ("lstsq", {"blocked": False}),
                       ("lstsq", {"use_pallas": "always"}),
                       ("lstsq", {"lookahead": True}),
                       ("lstsq", {"norm": "exact"}),
                       ("qr", {"refine": 1}),
                       ("sketch", {"panel_impl": "recursive"}),
                       ("bogus", {})]:
        with pytest.raises(ValueError) as te:
            tengine._resolve_dispatch_cfg(kind, None, over)
        with pytest.raises(ValueError) as je:
            jengine._resolve_dispatch_cfg(kind, None, over)
        assert str(te.value) == str(je.value), (kind, over)
    # plan= passes resolution untouched: it resolves per bucket
    tcfg = tengine._resolve_dispatch_cfg("lstsq", None, {"plan": "auto"})[0]
    jcfg = jengine._resolve_dispatch_cfg("lstsq", None, {"plan": "auto"})[0]
    assert tcfg.plan == jcfg.plan == "auto"


# ------------------------------------------------------- against the JAX

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batched_lstsq_matches_jax(dtype):
    As, bs = _requests(12, dtype, 3)
    got = dt.batched_lstsq(As, bs, device="cpu",
                           cache=tcache.ExecutableCache())
    want = jengine.batched_lstsq(As, bs, cache=_jcache())
    for A, b, x, xj in zip(As, bs, got, want):
        assert x.shape == (A.shape[1],) and x.dtype == torch.from_numpy(
            A).dtype
        assert _rel(x.numpy(), xj) < TOL[dtype]
        assert normal_equations_residual(A, x.numpy(), b) <= \
            CRITERION * oracle_residual(A, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batched_qr_matches_jax(dtype):
    As, bs = _requests(12, dtype, 4)
    got = dt.batched_qr(As, device="cpu", cache=tcache.ExecutableCache())
    want = jengine.batched_qr(As, cache=_jcache())
    for A, b, f, fj in zip(As, bs, got, want):
        m, n = A.shape
        H, Hj = f.H.numpy(), np.asarray(fj.H)
        assert H.shape == (m, n) and f.alpha.shape == (n,)
        assert np.abs(H - Hj).max() / np.abs(Hj).max() < TOL[dtype]
        aj = np.asarray(fj.alpha)
        assert np.abs(f.alpha.numpy() - aj).max() / np.abs(aj).max() \
            < TOL[dtype]
        assert f.block_size == fj.block_size
        assert _rel(f.solve(b).numpy(), np.asarray(fj.solve(b))) < TOL[dtype]


def test_batched_qr_policy_refine_arms_solves_like_jax():
    As, bs = _requests(4, np.float64, 5)
    got = dt.batched_qr(As, device="cpu", policy="balanced",
                        cache=tcache.ExecutableCache())
    want = jengine.batched_qr(As, policy="balanced", cache=_jcache())
    for f, fj, b in zip(got, want, bs):
        assert (f.refine, f.precision) == (fj.refine, fj.precision)
        assert (f.matrix is None) == (fj.matrix is None)
        assert _rel(f.solve(b).numpy(), np.asarray(fj.solve(b))) < 1e-10


def test_batched_sketched_lstsq_matches_jax():
    rng = np.random.default_rng(6)
    As = [rng.random((2000, 16)).astype(np.float32) for _ in range(3)]
    bs = [rng.random(2000).astype(np.float32) for _ in range(3)]
    got = dt.batched_sketched_lstsq(As, bs, device="cpu",
                                    cache=tcache.ExecutableCache())
    want = jengine.batched_sketched_lstsq(As, bs, cache=_jcache())
    for A, b, x, xj in zip(As, bs, got, want):
        assert _rel(x.numpy(), xj) < 1e-4
        assert normal_equations_residual(A, x.numpy(), b) <= \
            CRITERION * oracle_residual(A, b)


def test_batched_rows_match_the_2d_engine():
    As, _ = _requests(5, np.float64, 7, [(100, 36)])
    bucket = tbuckets.plan_bucket(100, 36, "float64")
    A_buf, _ = tbuckets.pad_group([(A, None) for A in As], bucket, 8, "cpu")
    H, alpha = tblocked._batched_qr_impl(A_buf.clone(), 32)
    for i in range(8):
        Hi, ai = tblocked._blocked_qr_impl(A_buf[i].clone(), 32)
        assert (H[i] - Hi).abs().max() <= TOL_ROW_F64 * Hi.abs().max()
        assert (alpha[i] - ai).abs().max() <= TOL_ROW_F64 * ai.abs().max()
    # the column norms: the same pairwise tree, row by row, bit for bit
    x = torch.from_numpy(np.random.default_rng(8).random((5, 37)))
    got = tree_sum(x)
    for i in range(5):
        assert torch.equal(got[i], tree_sum(x[i]))


def test_batched_qr_factors_the_stack_in_place():
    As, _ = _requests(3, np.float32, 9, [(64, 16)])
    bucket = tbuckets.plan_bucket(64, 16, "float32")
    A_buf, _ = tbuckets.pad_group([(A, None) for A in As], bucket, 4, "cpu")
    prog = tengine.bucket_program("qr")
    H, alpha = prog(A_buf)
    assert H.data_ptr() == A_buf.data_ptr()   # the stacked H is the stack
    assert alpha.shape == (4, 16)


# ------------------------------------------------------------- behaviour

def test_prewarm_then_a_served_stream_has_zero_misses():
    As, bs = _requests(10, np.float32, 10)
    specs = [(len([A for A in As if A.shape == s]),) + s for s in LADDER]
    cache = tcache.ExecutableCache()
    keys = tengine.prewarm(specs, cache=cache, device="cpu")
    jkeys = jengine.prewarm(specs, cache=_jcache())
    assert [tuple(k) for k in keys] == [tuple(k) for k in jkeys]
    misses = cache.stats()["misses"]
    dt.batched_lstsq(As, bs, cache=cache, device="cpu")
    dt.batched_lstsq(As, bs, cache=cache, device="cpu")
    st = cache.stats()
    assert st["misses"] == misses and st["hits"] > 0
    assert all(v["program"] == "eager" for v in
               cache.program_stats().values())


def test_dispatch_fault_raises_dispatch_failed_like_jax():
    As, bs = _requests(2, np.float32, 11)
    site = (("serve.dispatch", 1.0, 1),)
    with faults.injected(tconfig.FaultConfig(sites=site)):
        with pytest.raises(terrors.DispatchFailed) as te:
            dt.batched_lstsq(As, bs, cache=tcache.ExecutableCache(),
                             device="cpu")
    with jfaults.injected(jconfig.FaultConfig(sites=site)):
        with pytest.raises(jerrors.DispatchFailed) as je:
            jengine.batched_lstsq(As, bs, cache=_jcache())
    assert tuple(te.value.key) == tuple(je.value.key)


def test_compile_fault_then_quarantine_like_jax():
    As, bs = _requests(1, np.float32, 12)
    site = (("serve.compile", 1.0, 1),)
    for inj, cfg_mod, eng, err, cache in [
            (faults.injected, tconfig, tengine, terrors,
             tcache.ExecutableCache(quarantine_s=60)),
            (jfaults.injected, jconfig, jengine, jerrors,
             JCache(quarantine_s=60, store=None))]:
        kw = {"device": "cpu"} if eng is tengine else {}
        with inj(cfg_mod.FaultConfig(sites=site)):
            with pytest.raises(err.CompileFailed):
                eng.batched_lstsq(As, bs, cache=cache, **kw)
            with pytest.raises(err.Quarantined) as q:
                eng.batched_lstsq(As, bs, cache=cache, **kw)
        assert q.value.retry_after > 0
        st = cache.stats()
        assert (st["compile_failures"], st["quarantined"],
                st["quarantine_hits"]) == (1, 1, 1)


def test_guards_nan_request_raises_breakdown_like_jax():
    As, bs = _requests(8, np.float32, 13, [(64, 16)])
    As[5] = As[5].copy()
    As[5][3, 2] = np.nan
    with pytest.raises(dt.Breakdown):
        dt.batched_lstsq(As, bs, guards="fallback", device="cpu",
                         cache=tcache.ExecutableCache())
    with pytest.raises(JBreakdown):
        jengine.batched_lstsq(As, bs, guards="fallback", cache=_jcache())
    xs = dt.batched_lstsq(As[:5], bs[:5], guards="fallback", device="cpu",
                          cache=tcache.ExecutableCache())
    assert all(bool(torch.isfinite(x).all()) for x in xs)


class _StandInGraph:
    """A CUDA graph's contract on the CPU: replay reruns the recorded
    program on the static buffers, writing the static outputs."""

    def __init__(self, fn, static_in, static_out):
        self.fn, self.static_in, self.static_out = fn, static_in, static_out

    def replay(self):
        for o, r in zip(self.static_out, self.fn(*self.static_in)):
            o.copy_(r)


def test_replayed_results_are_copies_a_later_replay_cannot_change():
    key = tcache.CacheKey("qr", 2, 64, 16, "float64", 16, "highest", None,
                          None, 0, "accurate", "loop")
    lowered = tengine._lower_for_key(key, torch.device("cpu"))
    static = tuple(lowered.make_inputs())
    fn = lowered.fn
    outs = tuple(o.clone() for o in fn(*(s.clone() for s in static)))
    prog = tcache.BucketProgram(fn, "cpu", "cuda_graph")
    prog.static_inputs, prog.static_outputs = static, outs
    prog.graph = _StandInGraph(lambda A: fn(A.clone()), static, outs)
    As, _ = _requests(4, np.float64, 14, [(64, 16)])
    bucket = tbuckets.plan_bucket(64, 16, "float64")
    A1, _ = tbuckets.pad_group([(A, None) for A in As[:2]], bucket, 2, "cpu")
    A2, _ = tbuckets.pad_group([(A, None) for A in As[2:]], bucket, 2, "cpu")
    H1, a1 = prog(A1)
    keep = H1.clone(), a1.clone()
    H2, a2 = prog(A2)
    assert torch.equal(H1, keep[0]) and torch.equal(a1, keep[1])
    assert not torch.equal(H1, H2)
    assert H1.data_ptr() != prog.static_outputs[0].data_ptr()
    want = fn(A1.clone())
    assert torch.equal(H1, want[0]) and torch.equal(a1, want[1])


def test_capture_rule_is_fixed_on_the_key():
    base = dict(kind="lstsq", batch=2, m=64, n=16, dtype="float64",
                block_size=16, precision="highest", trailing_precision=None,
                apply_precision=None, refine=0, norm="accurate")
    for impl, eager in [("loop", False), ("recursive", False),
                        ("reconstruct", True), ("reconstruct:32", True)]:
        key = tcache.CacheKey(panel_impl=impl, **base)
        low = tengine._lower_for_key(key, torch.device("cpu"))
        assert (low.eager_reason is not None) == eager, impl
        prog = low.compile()
        assert prog.mode == "eager" and prog.graph is None  # the CPU
    As, bs = _requests(3, np.float64, 15)
    cache = tcache.ExecutableCache()
    xs = dt.batched_lstsq(As, bs, panel_impl="reconstruct", device="cpu",
                          cache=cache)
    want = jengine.batched_lstsq(As, bs, panel_impl="reconstruct",
                                 cache=_jcache())
    for x, xj in zip(xs, want):
        assert _rel(x.numpy(), xj) < TOL[np.float64]
    assert all(v["reason"] == "the caller asked for the CPU"
               for v in cache.program_stats().values())


def test_quarantine_export_adopt_in_jax_spelling():
    clock = [100.0]
    cache = tcache.ExecutableCache(quarantine_s=30, clock=lambda: clock[0])
    key = tcache.CacheKey("lstsq", 4, 64, 16, "float32", 16, "highest",
                          None, None, 0, "accurate", "loop")

    class Boom:
        def compile(self, profile=False):
            raise RuntimeError("capture refused")

    with pytest.raises(terrors.CompileFailed):
        cache.get_or_compile(key, Boom)
    exported = cache.export_quarantines(wall=lambda: 1000.0)
    spelling = jcanonical(JKey(*key))
    assert list(exported) == [spelling]
    assert exported[spelling] == pytest.approx(1030.0)
    other = tcache.ExecutableCache(clock=lambda: 5.0)
    assert other.adopt_quarantines(exported, wall=lambda: 1000.0) == 1
    with pytest.raises(terrors.Quarantined) as q:
        other.get_or_compile(key, Boom)
    assert q.value.retry_after == pytest.approx(30.0)


def test_unported_store_and_plan_refuse(monkeypatch, tmp_path):
    # the key store is ported (serve/store.py): store= and
    # DHQR_FLEET_STORE attach it; a key's plan is the JAX package's
    from dhqr_tpu_torch.serve import store as tstore

    store = tstore.ExecutableStore(str(tmp_path / "a"))
    assert tcache.ExecutableCache(store=store)._store is store
    monkeypatch.setenv("DHQR_FLEET_STORE", str(tmp_path / "b"))
    tstore.reset_default_store()
    try:
        assert tcache.ExecutableCache()._store is tstore.default_store()
        assert tstore.default_store().root == str(tmp_path / "b")
    finally:
        tstore.reset_default_store()
    key = tcache.CacheKey("qr", 2, 64, 16, "float32", 16, "highest", "high",
                          None, 0, "accurate", "recursive")
    plan = tengine.cache_key_plan(key)
    assert plan.to_dict() == jengine.cache_key_plan(key).to_dict()
    assert plan.describe() == "householder+nb16+recursive+tp-high"


def test_cache_is_per_device_and_refuses_a_mismatch():
    As, bs = _requests(2, np.float32, 16)
    cache = tcache.ExecutableCache()
    dt.batched_lstsq(As, bs, cache=cache, device="cpu")
    assert tcache.default_cache("cpu") is tcache.default_cache("cpu")
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="one cache per device"):
        tengine._dispatch_groups(
            "lstsq", As, bs, tengine._resolve_dispatch_cfg(
                "lstsq", None, {})[0], tconfig.ServeConfig(), cache,
            lambda *a: None, meta)
