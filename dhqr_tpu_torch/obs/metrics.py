"""MetricsRegistry — one process-wide registry of dotted-name metrics;
port of ``dhqr_tpu/obs/metrics.py``, names letter for letter.

The stack's operational numbers live in the subsystems' own
:class:`~dhqr_tpu_torch.utils.profiling.Counters` (the serve cache's,
the fault harness's, the numeric ladder's, the solvers'); this registry
reads them under stable dotted names (``serve.cache.hits``,
``numeric.fallbacks``, ``faults.fired``, ``obs.spans``, ``xray.captures``,
``comms.captures``, ``solvers.sketch_calls``, ...) and never copies them.

Sources come in two kinds:

* **instances** (``register(prefix, obj)`` with an object exposing
  ``metrics_snapshot() -> dict[str, number]``) are held by weak
  reference: every :class:`~dhqr_tpu_torch.serve.cache.ExecutableCache`
  (``serve.cache.*``), :class:`~dhqr_tpu_torch.serve.AsyncScheduler`
  (``serve.sched.*``), :class:`~dhqr_tpu_torch.serve.Router`
  (``fleet.router.*``) and :class:`~dhqr_tpu_torch.serve.ExecutableStore`
  (``fleet.store.*``) self-registers at construction, and two live
  instances sum under one name;
* **providers** (``register(prefix, callable)``) are held strongly and
  read at snapshot time: the default registry wires lazy providers for
  the armed fault harness, the tuner's plan-gate state
  (``tune.plan_gate.*``), the numeric ladder's counters, the armed trace
  recorder, the armed xray and pulse stores, the solvers' counters and
  the armed armor seam (``armor.*``), so those modules never import obs.

Exporters: :meth:`MetricsRegistry.export_jsonl`
appends one timestamped JSON object per call and
:meth:`MetricsRegistry.export_prometheus` renders the Prometheus text
exposition format (``dhqr_serve_cache_hits 42``).
"""

from __future__ import annotations

import json
import re
import time
import weakref
from typing import Callable, Union

from dhqr_tpu_torch.utils import lockwitness as _lockwitness

Number = Union[int, float]


def _flatten(prefix: str, values: dict) -> "dict[str, float]":
    """``{"hits": 3}`` under ``"serve.cache"`` -> ``{"serve.cache.hits":
    3.0}``; nested dicts flatten recursively; non-numeric values are
    dropped (a snapshot is numbers, not prose)."""
    out: "dict[str, float]" = {}
    for key, val in values.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(name, val))
        elif isinstance(val, bool):
            out[name] = float(val)
        elif isinstance(val, (int, float)):
            out[name] = float(val)
    return out


class MetricsRegistry:
    """Dotted-name metric aggregation over weakly-held instances and
    strongly-held provider callables (module docstring has the model).

    Thread-safe; snapshots are merge-SUMMED per name across sources so
    concurrent subsystems (two schedulers, N caches) read as one
    process. A source whose snapshot raises is skipped for that
    snapshot (telemetry must never take the serving path down with
    it).
    """

    def __init__(self) -> None:
        self._lock = _lockwitness.make_lock("MetricsRegistry._lock")
        # prefix -> list of (weakref-to-instance | callable)
        self._sources: "dict[str, list]" = {}  # guarded by: _lock

    def register(self, prefix: str,
                 source: "object | Callable[[], dict]") -> None:
        """Attach a source under ``prefix``. Instances (anything with a
        ``metrics_snapshot()`` method) are weakly referenced; bare
        callables returning a flat dict are held strongly."""
        if not prefix or not all(
                part for part in prefix.split(".")):
            raise ValueError(f"prefix must be dotted words, got {prefix!r}")
        entry = source if callable(source) and not hasattr(
            source, "metrics_snapshot") else weakref.ref(source)
        with self._lock:
            self._sources.setdefault(prefix, []).append(entry)

    def unregister(self, prefix: str) -> None:
        """Drop every source under ``prefix`` (tests)."""
        with self._lock:
            self._sources.pop(prefix, None)

    def _live_sources(self) -> "list[tuple[str, Callable[[], dict]]]":
        out = []
        with self._lock:
            for prefix, entries in list(self._sources.items()):
                kept = []
                for entry in entries:
                    if isinstance(entry, weakref.ref):
                        obj = entry()
                        if obj is None:
                            continue  # instance was garbage-collected
                        kept.append(entry)
                        out.append((prefix, obj.metrics_snapshot))
                    else:
                        kept.append(entry)
                        out.append((prefix, entry))
                if kept:
                    self._sources[prefix] = kept
                else:
                    del self._sources[prefix]
        return out

    #: Metric-name suffixes that are NOT additive across instances:
    #: config bounds and latency summaries. Two live schedulers' p99s
    #: do not add — summing would stamp a latency no request saw into
    #: the bench summary — so these merge by MAX (the conservative
    #: worst-instance reading, which is what an SLO check wants).
    #: Everything else (counters, occupancy, queue depth) sums.
    _MAX_MERGED_SUFFIXES = ("max_size", "capacity", "demote_after",
                            "p50_ms", "p99_ms", "mean_ms",
                            "skew_max_over_median")

    def snapshot(self) -> "dict[str, float]":
        """One consistent-per-source cut of every registered metric,
        dotted names, merged across same-prefix sources — counters sum,
        the non-additive gauges named in :data:`_MAX_MERGED_SUFFIXES`
        take the max. (Consistency is per SOURCE — each subsystem's
        snapshot is taken under its own lock — not global: a
        registry-wide stop-the-world would stall the serving path for
        telemetry.)"""
        merged: "dict[str, float]" = {}
        for prefix, fn in self._live_sources():
            try:
                values = fn()
            except Exception:
                continue  # telemetry only: a source mid-teardown must not
                # fail an unrelated snapshot; its numbers just skip
            for name, val in _flatten(prefix, values).items():
                if name.rsplit(".", 1)[-1] in self._MAX_MERGED_SUFFIXES:
                    merged[name] = max(merged.get(name, val), val)
                else:
                    merged[name] = merged.get(name, 0.0) + val
        return dict(sorted(merged.items()))

    # ------------------------------------------------------------ exporters

    def export_jsonl(self, path: str, clock=time.time,
                     **extra) -> dict:
        """Append one ``{"ts": ..., "metrics": {...}}`` JSON line to
        ``path`` and return the record. ``clock`` is injectable so
        tests (and fake-clock benchmarks) stamp deterministically;
        ``extra`` keys ride at the top level (phase names, run ids)."""
        record = dict(extra)
        record["ts"] = round(float(clock()), 3)
        record["metrics"] = self.snapshot()
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(record) + "\n")
        return record

    def export_prometheus(self, namespace: str = "dhqr") -> str:
        """The Prometheus text exposition format: one ``# TYPE``-tagged
        gauge per metric, every name sanitized through
        :func:`prometheus_name` (dotted registry
        names — and the dashes/colons inside bucket labels and fault
        site names — must land as VALID prometheus identifiers, and two
        registry names that sanitize identically must not emit
        conflicting duplicate series, so collisions get a
        deterministic ``_dupN`` suffix in sorted-name order). (Gauge,
        not counter, uniformly: the registry also carries
        occupancy/percentile values, and a scraper treats a
        monotonically increasing gauge correctly.)"""
        lines = []
        seen: "dict[str, int]" = {}
        for name, value in self.snapshot().items():  # sorted by name
            metric = prometheus_name(name, namespace=namespace)
            bump = seen.get(metric, 0)
            seen[metric] = bump + 1
            if bump:
                metric = f"{metric}_dup{bump}"
            lines.append(f"# TYPE {metric} gauge")
            if value == int(value):
                lines.append(f"{metric} {int(value)}")
            else:
                lines.append(f"{metric} {value}")
        return "\n".join(lines) + ("\n" if lines else "")


#: What a Prometheus metric name must match (the exposition-format
#: grammar, colons excluded — they are reserved for recording rules).
_PROM_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def prometheus_name(name: str, namespace: str = "dhqr") -> str:
    """One dotted registry name as a VALID prometheus identifier:
    ``serve.cache.hits`` -> ``dhqr_serve_cache_hits``. Every character
    outside ``[a-zA-Z0-9_]`` folds to ``_`` (dots, the dashes/colons in
    bucket labels like ``64x16:float32``, braces from raw XLA property
    names), runs collapse to one ``_``, and a leading digit — possible
    only with an empty namespace — gets a ``_`` prefix."""
    raw = f"{namespace}_{name}" if namespace else str(name)
    metric = re.sub(r"_+", "_", re.sub(r"[^a-zA-Z0-9_]", "_", raw))
    metric = metric.rstrip("_") or "_"
    if not re.match(r"[a-zA-Z_]", metric):
        metric = "_" + metric
    assert _PROM_NAME_RE.match(metric), (name, metric)
    return metric


# --------------------------------------------------------------------------
# The process-default registry + the lazy default providers.

def _faults_provider() -> dict:
    """``faults.fired`` / ``faults.visits`` totals + per-site counts of
    whatever harness is armed (nothing armed = no rows)."""
    from dhqr_tpu_torch.faults import harness as _faults

    armed = _faults.active()
    if armed is None:
        return {}
    per_site = armed.stats()
    out = {
        "fired": sum(s["fired"] for s in per_site.values()),
        "visits": sum(s["visits"] for s in per_site.values()),
    }
    for site, counts in per_site.items():
        out[f"fired.{site}"] = counts["fired"]
        out[f"visits.{site}"] = counts["visits"]
    return out


def _tune_provider() -> dict:
    """The tuner's ``plan_gate_stats()`` as registry numbers: recorded
    numeric-gate failures, failing and demoted keys, demoted lookups."""
    from dhqr_tpu_torch.tune.search import PLAN_DEMOTE_AFTER, plan_gate_stats

    stats = plan_gate_stats()
    failures = stats.get("failures", {})
    return {
        "failures": sum(failures.values()),
        "failing_keys": len(failures),
        "demoted_keys": sum(1 for v in failures.values()
                            if v >= PLAN_DEMOTE_AFTER),
        "demoted_lookups": stats.get("demoted_lookups", 0),
        "wire_demoted_lookups": stats.get("wire_demoted_lookups", 0),
        "demote_after": stats.get("demote_after", PLAN_DEMOTE_AFTER),
    }


def _numeric_provider() -> dict:
    """The numeric ladder's counters (``numeric.fallbacks`` et al.), the
    known names as zeros before the first bump so the series exist in
    every snapshot."""
    from dhqr_tpu_torch.numeric.ladder import COUNTERS

    out: dict = {name: 0 for name in (
        "guarded_calls", "screen_rejects", "fallbacks", "recovered",
        "exhausted")}
    out.update(COUNTERS.snapshot())
    return out


def _obs_provider() -> dict:
    """The armed trace recorder's own accounting, empty when disarmed."""
    from dhqr_tpu_torch.obs import trace as _trace

    recorder = _trace.active()
    if recorder is None:
        return {}
    return recorder.stats()


def _xray_provider() -> dict:
    """The armed xray store's capture accounting, empty when disarmed."""
    from dhqr_tpu_torch.obs import xray as _xray

    store = _xray.active()
    if store is None:
        return {}
    return store.stats()


def _pulse_provider() -> dict:
    """The armed pulse store's runtime-comms accounting (``comms.*``),
    empty when disarmed."""
    from dhqr_tpu_torch.obs import pulse as _pulse

    store = _pulse.active()
    if store is None:
        return {}
    return store.stats()


def _armor_provider() -> dict:
    """The armed armor state's accounting (``armor.verifications``,
    ``armor.detections``, ``armor.recovered_redispatch``,
    ``armor.recovered_degrade``, ``armor.typed_failures``,
    ``armor.degraded_labels``, ``armor.wire_trips``), empty when the
    seam is disarmed."""
    from dhqr_tpu_torch import armor as _armor

    state = _armor.active()
    if state is None:
        return {}
    return state.metrics_snapshot()


def _solvers_provider() -> dict:
    """The solver families' counters (``solvers.sketch_calls``,
    ``solvers.update_refactors``, ...), known names as zeros before the
    first bump."""
    from dhqr_tpu_torch.solvers.sketch import COUNTERS as _sk_counters
    from dhqr_tpu_torch.solvers.update import COUNTERS as _up_counters

    out: dict = {name: 0 for name in (
        "sketch_calls", "sketch_operator_draws", "update_steps",
        "downdate_steps", "update_solves", "update_refactors",
        "update_breakdowns", "update_screen_rejects")}
    out.update(_sk_counters.snapshot())
    out.update(_up_counters.snapshot())
    return out


_REGISTRY: "MetricsRegistry | None" = None
_REGISTRY_LOCK = _lockwitness.make_lock("metrics._REGISTRY_LOCK")


def _new_default_registry() -> MetricsRegistry:
    reg = MetricsRegistry()
    reg.register("faults", _faults_provider)
    reg.register("tune.plan_gate", _tune_provider)
    reg.register("numeric", _numeric_provider)
    reg.register("obs", _obs_provider)
    reg.register("xray", _xray_provider)
    reg.register("comms", _pulse_provider)
    reg.register("solvers", _solvers_provider)
    reg.register("armor", _armor_provider)
    # serve.cache.* / serve.sched.* / fleet.router.* / fleet.store.* have
    # no provider: each instance registers itself at construction (weakly).
    return reg


def registry() -> MetricsRegistry:
    """The process-default registry (created on first use, with the
    default providers wired)."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = _new_default_registry()
    return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Replace the process-default registry with a fresh one; returns
    it."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = _new_default_registry()
    return _REGISTRY
