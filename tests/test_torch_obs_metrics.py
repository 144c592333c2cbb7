"""PyTorch port: the metrics registry, the flop model, the profiling
utilities and the platform helpers against the JAX package's, on the CPU.

* ``obs.flops``: every closed form equals the JAX module's exactly over a
  sweep of shapes;
* ``MetricsRegistry``: after the same sequence in both packages (a serve
  cache with hits, misses and a failed compile; tracing, xray and pulse
  armed; a fault site visited; the solver and ladder counters), the
  dotted names are the JAX package's letter for letter (``tune.plan_gate.*``
  included; ``armor.*`` reads only while the seam is armed), and the
  shared values are equal; the Prometheus and JSONL exports are the same text;
* ``LatencyHistogram`` / ``Ewma`` / ``Counters`` read the same numbers
  as the JAX package's after the same records;
* ``utils/platform``: ``mfu_fields`` states its basis, complex is
  supported, and the two JAX-only process pins raise ``NotPortedError``.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from dhqr_tpu import faults as jfaults  # noqa: E402
from dhqr_tpu.obs import flops as jflops  # noqa: E402
from dhqr_tpu.obs import metrics as jmetrics  # noqa: E402
from dhqr_tpu.obs import trace as jtrace  # noqa: E402
from dhqr_tpu.serve import errors as jerrors  # noqa: E402
from dhqr_tpu.serve.cache import ExecutableCache as JCache  # noqa: E402
from dhqr_tpu.utils import config as jconfig  # noqa: E402
from dhqr_tpu.utils import profiling as jprof  # noqa: E402

import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch import faults  # noqa: E402
from dhqr_tpu_torch.obs import flops as tflops  # noqa: E402
from dhqr_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from dhqr_tpu_torch.obs import trace as ttrace  # noqa: E402
from dhqr_tpu_torch.serve import cache as tcache  # noqa: E402
from dhqr_tpu_torch.serve import errors as terrors  # noqa: E402
from dhqr_tpu_torch.utils import config as tconfig  # noqa: E402
from dhqr_tpu_torch.utils import platform as tplat  # noqa: E402
from dhqr_tpu_torch.utils import profiling as tprof  # noqa: E402

SHAPES = [(64, 16), (100, 36), (640, 256), (16384, 16384), (65536, 256),
          (4400, 4000), (1, 1), (23296, 64)]


def test_flops_equal_jax_over_a_sweep():
    assert tflops.__all__ == jflops.__all__
    for m, n in SHAPES:
        for name, args in [("qr_flops", (m, n)), ("apply_qt_flops", (m, n)),
                           ("apply_qt_flops", (m, n, 7)),
                           ("back_substitute_flops", (n, 3)),
                           ("lstsq_flops", (m, n)),
                           ("lstsq_flops", (m, n, 2)),
                           ("tsqr_flops", (m, n, 8)),
                           ("cholqr_flops", (m, n, 3)),
                           ("sketched_lstsq_flops", (m, n, 2 * n + 8, 12)),
                           ("qr_update_flops", (m, n)),
                           ("updatable_solve_flops", (m, n, 2)),
                           ("batched_qr_flops", (32, m, n)),
                           ("batched_lstsq_flops", (32, m, n, 1))]:
            got = getattr(tflops, name)(*args)
            assert got == getattr(jflops, name)(*args), (name, args)


class _Compiled:
    """A compiled program stand-in for both caches (the JAX cache calls
    ``.compile()``, the port's ``.compile(profile=)``)."""

    def compile(self, profile=False):
        return self


class _Refused:
    def compile(self, profile=False):
        raise RuntimeError("refused")


def _sequence(cache, pkg_faults, fault_cfg, errors):
    """The same operations on one package: hits, misses, a failed compile
    and its quarantine hit, a visited fault site."""
    for key in [("a", 1), ("b", 2), ("a", 1), ("a", 1)]:
        cache.get_or_compile(key, _Compiled)
    with pytest.raises(errors.CompileFailed):
        cache.get_or_compile(("bad",), _Refused)
    with pytest.raises(errors.Quarantined):
        cache.get_or_compile(("bad",), _Refused)
    return pkg_faults.injected(fault_cfg(sites=(("serve.latency", 0.0,
                                                 None),)))


def test_registry_names_and_values_match_jax():
    jreg, treg = jmetrics.reset_registry(), tmetrics.reset_registry()
    jcache = JCache(max_size=4, quarantine_s=60, store=None)
    tcache_ = tcache.ExecutableCache(max_size=4, quarantine_s=60)
    snaps = []
    for cache, pkg_faults, fcfg, errors, trace, ocfg, reg in [
            (jcache, jfaults, jconfig.FaultConfig, jerrors, jtrace,
             jconfig.ObsConfig, jreg),
            (tcache_, faults, tconfig.FaultConfig, terrors, ttrace,
             tconfig.ObsConfig, treg)]:
        trace.arm(ocfg(enabled=True, xray=True, pulse=True))
        try:
            with _sequence(cache, pkg_faults, fcfg, errors) as harness:
                harness.latency("serve.latency")
                rid = trace.mint()
                trace.event(rid, "submit", kind="lstsq")
                snaps.append(reg.snapshot())
        finally:
            trace.disarm()
    jsnap, tsnap = snaps
    jnames = set(jsnap)
    assert set(tsnap) == jnames
    assert any(k.startswith("tune.plan_gate.") for k in jnames)
    for name in jnames:
        if name.startswith(("serve.cache.", "faults.", "obs.", "xray.",
                            "comms.")) and name != \
                "serve.cache.compile_seconds":
            assert tsnap[name] == jsnap[name], name
    assert tsnap["serve.cache.hits"] == 2 and tsnap["serve.cache.misses"] == 3
    assert tsnap["serve.cache.quarantine_hits"] == 1


def test_exports_match_jax(tmp_path):
    values = {"serve.cache.hits": 3, "serve.cache.p99_ms": 1.25,
              "faults.fired.serve.dispatch": 1,
              "xray.bucket.64x16:float32": 2.0}
    regs = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        reg.register("x", lambda: dict(values))
        reg.register("x", lambda: dict(values))   # two sources sum / max
        regs.append(reg)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].export_prometheus() == regs[1].export_prometheus()
    for name in list(values) + ["9lives", "a..b"]:
        assert tmetrics.prometheus_name(name) == jmetrics.prometheus_name(
            name)
        assert tmetrics.prometheus_name(name, namespace="") == \
            jmetrics.prometheus_name(name, namespace="")
    recs = []
    for i, reg in enumerate(regs):
        path = tmp_path / f"m{i}.jsonl"
        reg.export_jsonl(str(path), clock=lambda: 12.5, phase="warm")
        recs.append(json.loads(path.read_text()))
    assert recs[0] == recs[1]
    with pytest.raises(ValueError):
        tmetrics.MetricsRegistry().register("bad..prefix", lambda: {})


def test_profiling_accounting_matches_jax():
    th, jh = tprof.LatencyHistogram(), jprof.LatencyHistogram()
    for i in range(1, 400):
        s = (i % 37) * 1.7e-4 + i * 1e-6
        th.record(s)
        jh.record(s)
    assert th.snapshot() == jh.snapshot()
    for p in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert th.percentile(p) == jh.percentile(p)
    te, je = tprof.Ewma(0.25), jprof.Ewma(0.25)
    assert te.value is None
    for x in (3.0, 1.0, 4.0, 1.0, 5.0):
        assert te.update(x) == je.update(x)
    with pytest.raises(ValueError):
        tprof.Ewma(0.0)
    timer = tprof.PhaseTimer()
    with timer.measure("panel_factor"):
        timer.observe(torch.ones(3))          # a CPU tensor: no fence
    with pytest.raises(RuntimeError):
        with timer.measure("failed"):
            raise RuntimeError("boom")
    assert list(timer.report()) == ["panel_factor"]
    assert timer.total("panel_factor") > 0
    tprof.sync([torch.zeros(2), {"a": (torch.ones(1),)}])
    with tprof.phase("trailing_update"):
        pass


def test_platform_helpers():
    h100 = "NVIDIA H100 80GB HBM3"
    f = tplat.mfu_fields(98.9e3, h100)
    assert f == {"mfu": 0.1, "mfu_peak_tflops": 989.0,
                 "mfu_convention": tplat.MFU_CONVENTION}
    assert "bf16 tensor-core" in tplat.MFU_CONVENTION
    assert tplat.mfu_fields(1.0, "cpu") == {}
    assert tplat.device_kind("cpu") == "cpu"
    assert tplat.complex_supported_on_backend() is True
    tplat.ensure_complex_supported(torch.complex64)
    for fn in (tplat.force_cpu_platform, tplat.enable_compile_cache):
        with pytest.raises(dt.NotPortedError, match="per call"):
            fn()
