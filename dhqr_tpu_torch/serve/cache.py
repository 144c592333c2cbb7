"""Bucket-program cache — port of ``dhqr_tpu/serve/cache.py``.

The serving tier's throughput contract is "a repeated request stream never
recompiles": every bucket dispatch goes through this cache, which builds
each program ONCE per key and then hands back the resident one. In the JAX
package that build is ``lower().compile()``, ahead of time; here it is:

* **on the card, a CUDA-graph capture.** :meth:`LoweredProgram.compile`
  makes static input tensors for the key (the identity embedding of empty
  requests, so the warm-up is finite), runs the program once to warm it
  up (cuBLAS handles, workspaces; under ``torch.profiler`` when xray is
  armed), then captures one run into a ``torch.cuda.CUDAGraph``
  (``capture_begin`` / ``capture_end``, with
  ``capture_error_mode="thread_local"``: the scheduler's worker threads
  dispatch while one of them captures; the ``torch.cuda.graph`` context
  would also empty the allocator's cache at every capture). A dispatch
  copies into the static inputs, replays the graph, and copies the
  outputs out: a later replay cannot change what an earlier one returned.
  A capture that fails raises, and the cache turns that into
  :class:`CompileFailed` and a quarantine: nothing falls back to eager by
  catching an error.
* **A program that cannot be captured by design runs eager on the card**,
  decided by a fixed rule on the key, never by catching a capture error:
  ``panel_impl="reconstruct[:<chunk>]"``, whose library QR
  (``torch.linalg.qr``, cuSOLVER) checks its status on the host.
  :meth:`ExecutableCache.program_stats` and the xray report say so.
* **On the CPU**, the caller asked for the CPU, so the "compiled" program
  is the eager program itself.

**Concurrent replays: each key pinned to a lane.** A captured cuBLAS GEMM
bakes in the address of the workspace PyTorch keeps per (handle, stream),
so two graphs captured on one stream by one thread share a workspace, and
so do a graph and any later eager run on that stream. A fresh stream from
torch's pool of 32 per capture would hand one stream to two captures, and
a lock per program would serialize only its own replays: two worker
threads replaying two such keys, or one replaying while another warmed up
a cold key, could write one workspace at once. So each device has
:data:`LANES_PER_DEVICE` lanes (:class:`DeviceLane`: one stream and one
lock), and each key is pinned, round-robin as it is compiled, to one lane,
on which its warm-up, capture, replays (and, for an eager-on-card key, its
runs) all happen under the lane's lock. Keys of one lane share its stream
and are serialized; keys of two lanes have two streams, so two workspaces,
and replay at once. One lane per device was the simpler fix, but a replay
is launch-bound (the card is about half busy during one), so two replays
on two streams overlap where one lane would serialize them. A stream per
key that no other capture reuses would need more streams than the pool
holds. The lanes' streams are the only default-priority streams the port
takes from torch's pool (the lookahead schedule's side stream is a
high-priority one), drawn together, so they are distinct. A lane's stream
waits for the caller's current stream before it reads the inputs, and the
caller's stream waits for the lane before it reads the outputs (each
recorded on the caller's stream for the allocator). A capture holds its
lane, so that lane's replays wait for a cold key's capture, which
``prewarm`` keeps off the steady state. ``chip_smoke.py`` phase 18 (e)
replays two keys of one lane from two threads 200 times each while a third
thread captures a cold key, and two keys of two lanes likewise, and holds
every output to the serial replays bit for bit.

Accounting rides :class:`~dhqr_tpu_torch.utils.profiling.Counters` (hits,
misses, evictions, compile seconds — capture seconds on the card —
failures, quarantine hits) and a :class:`~dhqr_tpu_torch.utils.profiling.
PhaseTimer`, exported under ``serve.cache.*`` by the metrics registry.
Eviction is LRU, bounded by ``ServeConfig.cache_size``; evicting drops the
cache's reference, and the graph with its private memory pool is freed
when the last dispatch holding it returns.

A compile that raises (organically, or at the ``serve.compile`` fault
site) quarantines its key for ``ServeConfig.quarantine_s``: requests that
land on it inside the cooldown get :class:`Quarantined` with a positive
``retry_after`` instead of paying the failing compile again. Quarantine
verdicts export and adopt in the JAX package's cross-process spelling
(:func:`canonical_key`), which the fleet state of ``serve.store`` carries
between replicas. With a key store attached (``store=``, or
``DHQR_FLEET_STORE``), each capture writes its key's record there and each
miss reads it, counted with its reason: a CUDA graph does not outlive its
process, so a record never stands in for a capture (``serve.store``).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, NamedTuple

import torch

from dhqr_tpu_torch.faults import harness as _faults
from dhqr_tpu_torch.obs import metrics as _obs_metrics
from dhqr_tpu_torch.analysis import oplog as _oplog
from dhqr_tpu_torch.obs import xray as _obs_xray
from dhqr_tpu_torch.serve.errors import CompileFailed, Quarantined
from dhqr_tpu_torch.utils import lockwitness as _lockwitness
from dhqr_tpu_torch.utils.config import ServeConfig
from dhqr_tpu_torch.utils.profiling import Counters, PhaseTimer

#: The cross-process key spelling's version (the JAX package's).
CANONICAL_VERSION = "dhqr-exe-v1"


class CacheKey(NamedTuple):
    """Everything that selects a distinct serve program — the JAX
    package's fields, order and spelling, so the same request gives the
    same key tuple in both packages.

    ``kind`` is the program family ("lstsq" | "qr" | "sketch");
    ``batch``/``m``/``n``/``dtype`` the bucketed stacked shape; the rest
    the engine knobs the program is built with. ``sketch`` is the sketched
    kind's ``(s, seed, operator)`` triple, None for the direct kinds."""

    kind: str
    batch: int
    m: int
    n: int
    dtype: str
    block_size: int
    precision: str
    trailing_precision: "str | None"
    apply_precision: "str | None"
    refine: int
    norm: str
    panel_impl: str
    sketch: "tuple | None" = None


def canonical_key(key) -> str:
    """The JAX package's cross-process spelling of a cache key
    (``serve.store.canonical_key``), byte for byte: CacheKeys, strings and
    flat tuples of primitives; anything else raises ``ValueError``. The
    plan segment is the key's plan's ``Plan.describe()``
    (``serve.engine.cache_key_plan``)."""
    if isinstance(key, CacheKey):
        from dhqr_tpu_torch.serve.engine import cache_key_plan

        plan = cache_key_plan(key)
        sketch = "-" if key.sketch is None else \
            ":".join(repr(x) for x in key.sketch)
        return "|".join([
            CANONICAL_VERSION, key.kind, f"b{key.batch}",
            f"{key.m}x{key.n}", key.dtype, plan.describe(),
            f"p={key.precision}", f"a={key.apply_precision or '-'}",
            f"r={key.refine}", f"norm={key.norm}", f"sk={sketch}",
        ])
    if isinstance(key, str):
        return f"{CANONICAL_VERSION}|raw|{key}"
    if isinstance(key, tuple) and all(
            isinstance(x, (str, int, float, bool, type(None)))
            for x in key):
        return (CANONICAL_VERSION + "|tuple|"
                + "|".join(repr(x) for x in key))
    raise ValueError(
        f"no canonical cross-process spelling for cache key "
        f"{key!r:.120} (type {type(key).__name__})")


def _as_tuple(out) -> "tuple[torch.Tensor, ...]":
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


#: Lanes per device: each a stream and a lock; keys are pinned to them
#: round-robin (module docstring).
LANES_PER_DEVICE = 4


class DeviceLane:
    """A stream and the lock under which the serve programs pinned to it
    warm up, are captured, replay and run eager (the module docstring says
    why). On the CPU it is the lock alone."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.lock = _lockwitness.make_lock("serve.cache.DeviceLane.lock")
        self.stream = torch.cuda.Stream(device=self.device) \
            if self.device.type == "cuda" else None

    @contextmanager
    def entered(self):
        """Hold the lane and run the body on its stream: the lane's stream
        first waits for the caller's current stream (the inputs), and the
        caller's stream then waits for the lane's (the outputs)."""
        with self.lock:
            if self.stream is None:
                yield
                return
            caller = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(caller)
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                yield
            caller.wait_stream(self.stream)


# device -> (its lanes, the count of programs pinned so far)
_LANES: "dict[str, list]" = {}   # guarded by: _LANES_LOCK
_LANES_LOCK = _lockwitness.make_lock("cache._LANES_LOCK")


def device_lanes(device) -> "list[DeviceLane]":
    """The process's :data:`LANES_PER_DEVICE` lanes of ``device`` (made
    together on first use)."""
    return _lane_entry(device)[0]


def _lane_entry(device) -> list:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _LANES_LOCK:
        entry = _LANES.get(str(device))
        if entry is None:
            entry = _LANES[str(device)] = [
                [DeviceLane(device) for _ in range(LANES_PER_DEVICE)], 0]
        return entry


def next_lane(device) -> DeviceLane:
    """The lane the next program of ``device`` is pinned to (round-robin
    over :func:`device_lanes`)."""
    entry = _lane_entry(device)
    with _LANES_LOCK:
        lane = entry[0][entry[1] % LANES_PER_DEVICE]
        entry[1] += 1
    return lane


class BucketProgram:
    """One compiled serve program: call it with the stacked inputs.

    ``mode`` is ``"cuda_graph"`` (a captured graph, replayed) or
    ``"eager"`` (the program run as is: on the CPU, or on the card for a
    key that cannot be captured by design; ``reason`` says which).
    ``measured`` / ``memory`` (or their ``*_reason``) are what the capture
    recorded for xray. A graph program's call copies its arguments into
    the static inputs, replays, and returns copies of the static outputs.
    Each program is pinned to a lane of its device (``lane``,
    :class:`DeviceLane`); a graph program, and an eager one on the card,
    runs only in it (the CPU's eager programs share no buffers)."""

    def __init__(self, fn, device, mode: str, reason: "str | None" = None):
        self.fn = fn
        self.device = torch.device(device)
        self.mode = mode
        self.reason = reason
        self.graph = None
        self.static_inputs: "tuple[torch.Tensor, ...]" = ()
        self.static_outputs: "tuple[torch.Tensor, ...]" = ()
        self.single_output = False
        self.measured = None
        self.measured_reason: "str | None" = None
        self.memory = None
        self.memory_reason: "str | None" = None
        self.lane = next_lane(self.device)

    def __call__(self, *args):
        if self.graph is None and self.device.type != "cuda":
            return self.fn(*args)
        with self.lane.entered():
            if self.graph is None:
                out = self.fn(*args)
            else:
                for static, arg in zip(self.static_inputs, args):
                    static.copy_(arg)
                # dhqr: ignore[DHQR603] replay under the lane lock is the design: a graph's static buffers serve one replay at a time
                self.graph.replay()
                outs = tuple(o.clone() for o in self.static_outputs)
                out = outs[0] if self.single_output else outs
        if self.device.type == "cuda":
            caller = torch.cuda.current_stream(self.device)
            for o in _as_tuple(out):
                o.record_stream(caller)
        return out

    def describe(self) -> dict:
        """The key's program stats: how it runs and why."""
        out = {"program": self.mode, "device": str(self.device)}
        if self.reason:
            out["reason"] = self.reason
        return out


class LoweredProgram:
    """What a serve key lowers to: the eager program ``fn`` over stacked
    inputs, the example inputs its capture starts from (``make_inputs()``,
    on ``device``), and, for a key that cannot be captured by design, the
    reason (``eager_reason``). :meth:`compile` is the cache's one build
    step."""

    def __init__(self, fn: Callable, make_inputs: Callable, device,
                 eager_reason: "str | None" = None):
        self.fn = fn
        self.make_inputs = make_inputs
        self.device = torch.device(device)
        self.eager_reason = eager_reason

    def compile(self, profile: bool = False) -> BucketProgram:
        """The program for this key: a captured CUDA graph on the card, the
        eager program on the CPU or for a key that cannot be captured.
        ``profile=True`` (xray armed) profiles the warm-up run. A capture
        that fails raises."""
        if self.device.type != "cuda":
            prog = BucketProgram(self.fn, self.device, "eager",
                                 "the caller asked for the CPU")
            prog.measured_reason = _obs_xray.CPU_REASON
            prog.memory_reason = _obs_xray.CPU_MEMORY_REASON
            return prog
        if self.eager_reason is not None:
            prog = BucketProgram(self.fn, self.device, "eager",
                                 self.eager_reason)
            if profile:
                inputs = self.make_inputs()
                prog.measured, prog.measured_reason = _obs_xray.profile_run(
                    lambda: self.fn(*inputs), self.device)
                if prog.measured is not None:
                    prog.measured["program"] = f"eager: {self.eager_reason}"
            prog.memory_reason = (f"runs eager on the card "
                                  f"({self.eager_reason}): nothing captured")
            return prog
        return self._capture(profile)

    def _capture(self, profile: bool) -> BucketProgram:
        device = self.device
        prog = BucketProgram(self.fn, device, "cuda_graph")
        lane = prog.lane
        with lane.lock:
            # dhqr: ignore[DHQR603] capture-under-lock is the design: one capture per lane, its stream idle first (the twin of the JAX cache's compile-under-lock)
            torch.cuda.synchronize(device)
            if profile:  # the allocator's account of the capture, for xray
                allocated0 = torch.cuda.memory_allocated(device)
                reserved0 = torch.cuda.memory_reserved(device)
                torch.cuda.reset_peak_memory_stats(device)
            static = tuple(self.make_inputs())
            side = lane.stream
            side.wait_stream(torch.cuda.current_stream(device))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.device(device), torch.cuda.stream(side), \
                    torch.no_grad():
                # warm-up on copies (a factor-only program works in
                # place), then the capture on the same stream
                warm = tuple(x.clone() for x in static)
                if profile:
                    prog.measured, prog.measured_reason = \
                        _obs_xray.profile_run(lambda: self.fn(*warm), device)
                    if prog.measured is not None:
                        prog.measured["program"] = "cuda_graph"
                else:
                    self.fn(*warm)
                del warm
                # dhqr: ignore[DHQR603] same capture: the warm-up finishes before capture_begin
                side.synchronize()
                # dhqr: ignore[DHQR603] same capture, held across capture_begin/capture_end
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    with _oplog.scope("capture"):  # the graph's body
                        out = self.fn(*static)
                finally:
                    # dhqr: ignore[DHQR603] same capture, held across capture_begin/capture_end
                    graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(side)
            # dhqr: ignore[DHQR603] same capture: the graph is complete before the lane is released
            torch.cuda.synchronize(device)
        prog.single_output = not isinstance(out, (tuple, list))
        prog.graph = graph
        prog.static_inputs = static
        prog.static_outputs = _as_tuple(out)
        if profile:
            arg_bytes = sum(x.numel() * x.element_size() for x in static)
            out_bytes = sum(x.numel() * x.element_size()
                            for x in prog.static_outputs
                            if not any(x.data_ptr() == s.data_ptr()
                                       for s in static))
            peak = torch.cuda.max_memory_allocated(device) - allocated0
            prog.memory = {
                "argument_bytes": int(arg_bytes),
                "output_bytes": int(out_bytes),
                "temp_bytes": int(max(peak - arg_bytes - out_bytes, 0)),
                "peak_bytes": int(peak),
                "pool_bytes": int(torch.cuda.memory_reserved(device)
                                  - reserved0),
            }
        else:
            prog.memory_reason = "xray was not armed at the capture"
        return prog


class ExecutableCache:
    """LRU-bounded map from hashable keys to compiled bucket programs.

    ``get_or_compile(key, lower_fn)`` is the only entry point: ``lower_fn``
    returns a :class:`LoweredProgram` (or any object with
    ``.compile(profile=...)``); the cache owns the compile, its timing and
    the counters. Keys are usually :class:`CacheKey`, but any hashable
    works."""

    def __init__(self, max_size: "int | None" = None,
                 quarantine_s: "float | None" = None,
                 clock=time.monotonic, store="auto") -> None:
        if max_size is None or quarantine_s is None:
            scfg = ServeConfig.from_env()
            max_size = scfg.cache_size if max_size is None else max_size
            quarantine_s = scfg.quarantine_s if quarantine_s is None \
                else quarantine_s
        if store == "auto":
            # the process-default key store when DHQR_FLEET_STORE names a
            # directory, else none (the per-process cache)
            from dhqr_tpu_torch.serve import store as _store_mod

            store = _store_mod.default_store()
        self._store = store
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        if not quarantine_s > 0:
            raise ValueError(
                f"quarantine_s must be > 0, got {quarantine_s}")
        self.max_size = int(max_size)
        self.quarantine_s = float(quarantine_s)
        self._clock = clock
        # guarded by: _lock
        self._entries: "OrderedDict[object, object]" = OrderedDict()
        # key -> cooldown expiry (clock seconds) after a failed compile
        self._quarantine: "dict[object, float]" = {}  # guarded by: _lock
        # canonical spelling -> cooldown expiry, adopted from another
        # replica's exported verdicts
        self._quarantine_adopted: "dict[str, float]" = {}  # guarded by: _lock
        self.counters = Counters()
        self.timer = PhaseTimer()
        # One lock for lookup + insert + evict + counters, held across a
        # compile too: concurrent requests for one key get one capture.
        self._lock = _lockwitness.make_rlock("ExecutableCache._lock")
        _obs_metrics.registry().register("serve.cache", self)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def _quarantined(self, key) -> None:
        """Raise :class:`Quarantined` inside a cooldown (caller holds the
        lock); drop an expired verdict."""
        until = self._quarantine.get(key)
        if until is not None:
            now = self._clock()
            if now < until:
                self.counters.bump("quarantine_hits")
                raise Quarantined(key, until - now)
            del self._quarantine[key]  # cooldown over: one retry
        if self._quarantine_adopted:
            ks = self._canonical(key)
            until = None if ks is None else self._quarantine_adopted.get(ks)
            if until is not None:
                now = self._clock()
                if now < until:
                    self.counters.bump("quarantine_hits")
                    raise Quarantined(key, until - now)
                del self._quarantine_adopted[ks]

    def get_or_compile(self, key, lower_fn: Callable[[], object]):
        """Return the program for ``key``, compiling on first miss.

        A compile that raises (organically — a failed capture — or at the
        ``serve.compile`` injection site) surfaces as
        :class:`CompileFailed` with the cause chained, and quarantines
        ``key`` for ``quarantine_s``: until the cooldown expires, requests
        for the key raise :class:`Quarantined` without compiling."""
        with self._lock:
            if key in self._entries:
                self.counters.bump("hits")
                self._entries.move_to_end(key)
                return self._entries[key]
            self._quarantined(key)
            self.counters.bump("misses")
            if self._store is not None:
                # The store's record of this key never stands in for a
                # capture (a CUDA graph does not outlive its process):
                # load() counts the miss with its reason, never raises.
                self._store.load(key)
            xray_store = _obs_xray.active()
            before = self.timer.total("aot_compile")
            try:
                with self.timer.measure("aot_compile"):
                    _faults.fire("serve.compile")
                    # dhqr: ignore[DHQR603] compile-under-lock is the design: one compile per key, N waiters (see the _lock comment in __init__)
                    exe = lower_fn().compile(profile=xray_store is not None)
            except Exception as e:
                self.counters.bump("compile_failures")
                self._quarantine[key] = self._clock() + self.quarantine_s
                raise CompileFailed(key, e) from e
            compile_s = self.timer.total("aot_compile") - before
            self.counters.bump("compile_seconds", compile_s)
            if xray_store is not None:
                xray_store.capture(key, exe, compile_seconds=compile_s)
            if self._store is not None:
                self._store.save(key, exe)  # counted, never raises
            self._entries[key] = exe
            while len(self._entries) > self.max_size:
                self._entries.popitem(last=False)
                self.counters.bump("evictions")
            return exe

    def stats(self) -> dict:
        """Counter snapshot + occupancy, JSON-ready: the same numbers the
        metrics registry exports as ``serve.cache.*``, one consistent cut
        under the cache lock."""
        return self.metrics_snapshot()

    def metrics_snapshot(self) -> dict:
        """The registry-facing snapshot; identical to :meth:`stats`."""
        with self._lock:
            snap = self.counters.snapshot()
            now = self._clock()
            for k in [k for k, t in self._quarantine.items() if now >= t]:
                del self._quarantine[k]  # expired: not "in quarantine"
            for k in [k for k, t in self._quarantine_adopted.items()
                      if now >= t]:
                del self._quarantine_adopted[k]
            return {
                "size": len(self._entries),
                "max_size": self.max_size,
                "hits": int(snap.get("hits", 0)),
                "misses": int(snap.get("misses", 0)),
                "evictions": int(snap.get("evictions", 0)),
                "compile_seconds": round(
                    float(snap.get("compile_seconds", 0)), 3),
                "compile_failures": int(snap.get("compile_failures", 0)),
                "quarantined": (len(self._quarantine)
                                + len(self._quarantine_adopted)),
                "quarantine_hits": int(snap.get("quarantine_hits", 0)),
            }

    def program_stats(self) -> "dict[str, dict]":
        """Per resident key: how its program runs (``"cuda_graph"`` or
        ``"eager"``), on which device, and why when eager."""
        with self._lock:
            entries = list(self._entries.items())
        return {str(k): exe.describe() for k, exe in entries
                if hasattr(exe, "describe")}

    @staticmethod
    def _canonical(key) -> "str | None":
        """``key``'s cross-process spelling, or None where it has none."""
        try:
            return canonical_key(key)
        except ValueError:
            return None

    def export_quarantines(self, wall=time.time) -> "dict[str, float]":
        """Active quarantines as {canonical spelling: wall-clock expiry}
        (adopted ones re-export), as the JAX package's."""
        now = self._clock()
        wall_now = wall()
        out: "dict[str, float]" = {}
        with self._lock:
            local = list(self._quarantine.items())
            adopted = list(self._quarantine_adopted.items())
        for key, until in local:
            remaining = until - now
            if remaining <= 0:
                continue
            ks = self._canonical(key)
            if ks is not None:
                out[ks] = max(out.get(ks, 0.0), wall_now + remaining)
        for ks, until in adopted:
            remaining = until - now
            if remaining > 0:
                out[ks] = max(out.get(ks, 0.0), wall_now + remaining)
        return out

    def adopt_quarantines(self, mapping: "dict[str, float]",
                          wall=time.time) -> int:
        """Inherit another replica's verdicts ({canonical spelling:
        wall-clock expiry}); returns how many are active. Later expiries
        win."""
        now = self._clock()
        wall_now = wall()
        adopted = 0
        with self._lock:
            for ks, expiry in mapping.items():
                try:
                    remaining = float(expiry) - wall_now
                except (TypeError, ValueError):
                    continue
                if remaining <= 0:
                    continue
                until = now + remaining
                prev = self._quarantine_adopted.get(str(ks))
                if prev is None or until > prev:
                    self._quarantine_adopted[str(ks)] = until
                adopted += 1
        return adopted

    def clear(self) -> None:
        """Drop every resident program and every active quarantine
        (counters keep accumulating: they are lifetime telemetry)."""
        with self._lock:
            self._entries.clear()
            self._quarantine.clear()
            self._quarantine_adopted.clear()


# One process-default cache per device, made on first serve use (a
# malformed DHQR_SERVE_* variable fails the serve call that reads it, not
# the import). A cache's programs belong to one device: the key spelling is
# the JAX package's, which names no device.
_DEFAULT_CACHES: "dict[str, ExecutableCache]" = {}
_DEFAULT_CACHE_LOCK = _lockwitness.make_lock("cache._DEFAULT_CACHE_LOCK")


def default_cache(device=None) -> ExecutableCache:
    """The process-default serve cache of ``device`` (None: the card)."""
    from dhqr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    name = str(dev)
    with _DEFAULT_CACHE_LOCK:
        if name not in _DEFAULT_CACHES:
            _DEFAULT_CACHES[name] = ExecutableCache()
        return _DEFAULT_CACHES[name]


def cache_stats(device=None) -> dict:
    """Stats of the process-default serve cache of ``device``."""
    return default_cache(device).stats()


def clear_cache(device=None) -> None:
    """Clear the process-default serve cache of ``device``."""
    default_cache(device).clear()
