"""Async serving front-end: deadline-aware continuous micro-batching —
port of ``dhqr_tpu/serve/scheduler.py``, decision for decision.

* :meth:`AsyncScheduler.submit` accepts one request — ``(kind, A, b)`` plus
  ``deadline`` / ``tenant`` / ``policy`` — validates it with the sync
  tier's own checks, and returns a ``concurrent.futures.Future``;
* queued requests coalesce per (kind, bucket, resolved config) group, the
  grouping ``batched_lstsq`` computes for a list, and a dispatcher flushes
  a group as ONE stacked dispatch when it reaches the batch cap ("full"),
  when its oldest request's deadline minus the bucket's EWMA dispatch time
  approaches ("deadline"), or when its oldest request has waited the flush
  interval ("interval");
* within an oversubscribed flush, requests are picked by smooth weighted
  round-robin across tenants (``SchedulerConfig.tenant_weights``), with
  credit kept on the group across flushes and the oldest request always
  taken;
* past ``SchedulerConfig.queue_depth`` queued requests, or when the
  admission price (batches ahead x the bucket's EWMA) exceeds the
  request's budget, ``submit`` raises :class:`BackpressureError` with a
  positive ``retry_after``;
* a failed flush retries with exponential backoff inside the deadlines;
  retries that keep failing bisect the batch until the poison request
  fails alone, typed; a ``NumericalError`` (``guards=``) goes straight to
  bisection; a quarantined key backs off for its cooldown; a crashed
  worker is replaced, its flush requeued. Every future resolves: a result
  or a typed :class:`~dhqr_tpu_torch.serve.errors.ServeError` (or
  ``NumericalError``), never a hang;
* :meth:`AsyncScheduler.drain` / :meth:`AsyncScheduler.shutdown` complete
  everything accepted.

ONE dispatch path, as in the JAX package: a flush calls the engine's own
``_dispatch_groups`` with consumers from the engine's ``_scatter_lstsq`` /
``_scatter_qr``, so the scheduler and the sync tier mint the same
``CacheKey``\\ s and a cache prewarmed for the sync tier serves the queue
with no capture. ``plan=`` (per request, or in the scheduler's config)
resolves per bucket at the flush, through the engine's resolver, so a
scheduler prewarmed with ``prewarm(..., plan="auto")`` replays only tuned
keys.

On the card: the scheduler runs on one device (``device=None``: the
card; without CUDA it raises, ``device="cpu"`` runs the plain path), each
worker thread sets that device before it dispatches, and each bucket
program runs in the lane it is pinned to (``serve.cache.DeviceLane``), so
two workers' replays overlap on the card when their keys sit on two
lanes. **A future resolves only once its
outputs are ready**: a flush records a CUDA event on the dispatching
thread's stream (which waited for the lane) and waits for it, and the
per-bucket EWMA of dispatch seconds is timed to that point, so the
deadline flush and the admission price are priced on device time, not on
launch time. An asynchronous CUDA error that surfaces at that wait is a
``DispatchFailed`` of the chunk's key, as a launch error is. A capture
that fails is ``CompileFailed`` through the futures; nothing runs eager in
its place.

The ``"update"`` kind drives a live
:class:`~dhqr_tpu_torch.solvers.update.UpdatableQR`: ops in submission
order, serialized per session (``_Group.busy``), a ``NumericalError``
failing its op alone and a ``ShardFailure`` going through retry. Its
construction and refactors are the slice's panel-kernel launches.

Latency accounting rides ``utils.profiling``: a :class:`LatencyHistogram`
of submit-to-done seconds, one :class:`Ewma` of dispatch seconds per
bucket, and :class:`Counters`, exported as ``serve.sched.*``. With tracing
armed (``obs.arm``) every request's path is spans: submit, flush,
dispatch, dispatch_ok, retry / isolate / bisect / numeric_isolate,
resolve; a typed error carries its trace id for ``obs.flight_dump_error``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Optional

import torch

from dhqr_tpu_torch.armor.errors import ShardFailure
from dhqr_tpu_torch.faults import harness as _faults
from dhqr_tpu_torch.numeric.errors import NumericalError
from dhqr_tpu_torch.obs import metrics as _obs_metrics
from dhqr_tpu_torch.obs import trace as _obs
from dhqr_tpu_torch.serve import engine as _engine
from dhqr_tpu_torch.serve.buckets import Bucket, plan_bucket
from dhqr_tpu_torch.serve.cache import ExecutableCache, default_cache
from dhqr_tpu_torch.serve.errors import (
    BackpressureError,
    DeadlineExceeded,
    DispatchFailed,
    Quarantined,
    ServeError,
)
from dhqr_tpu_torch.utils import lockwitness as _lockwitness
from dhqr_tpu_torch.utils.config import DHQRConfig, SchedulerConfig, ServeConfig
from dhqr_tpu_torch.utils.device import resolve_device
from dhqr_tpu_torch.utils.profiling import Counters, Ewma, LatencyHistogram

# Deadline-flush lead time: a group flushes when
#   now >= deadline - (_LEAD_FACTOR * ewma + _LEAD_FLOOR_S)
# (the JAX package's constants: the EWMA is the measurable quantity, the
# margin absorbs its variance).
_LEAD_FACTOR = 1.25
_LEAD_FLOOR_S = 1e-3

__all__ = ["AsyncScheduler", "BackpressureError", "dispatch_program"]


@dataclasses.dataclass
class _Pending:
    """One queued request. ``attempts`` counts the failed flushes it has
    ridden; ``claimed`` marks a future a prior flush already moved to
    RUNNING (a requeued request must not claim twice); ``trace_id`` is
    the obs id minted at submit (host-side only, never in a key)."""

    seq: int
    A: object
    b: object
    tenant: str
    submitted_at: float
    deadline_at: float
    future: Future
    attempts: int = 0
    claimed: bool = False
    trace_id: "int | None" = None


class _Group:
    """Pending requests sharing (kind, bucket, resolved config): the unit
    one flush dispatches. For the ``"update"`` kind the group is keyed on
    the live session instead, flushes strictly FIFO and is serialized by
    ``busy``."""

    __slots__ = ("kind", "bucket", "cfg", "pol", "qr_solve_args", "queue",
                 "credits", "not_before", "session", "busy", "gkey")

    def __init__(self, kind, bucket, cfg, pol, qr_solve_args,
                 session=None, gkey=None):
        self.kind = kind
        self.bucket = bucket
        self.cfg = cfg
        self.pol = pol
        self.qr_solve_args = qr_solve_args
        self.session = session      # "update" kind: the UpdatableQR
        self.busy = False           # "update" kind: one flush at a time
        self.gkey = gkey            # "update" kind: for idle pruning
        self.queue: "collections.deque[_Pending]" = collections.deque()
        # smooth-WRR credit per tenant, kept across flushes
        self.credits: "dict[str, float]" = {}
        # retry backoff horizon (clock seconds); drain ignores it
        self.not_before: float = 0.0


class AsyncScheduler:
    """Thread-safe admission queue + micro-batching dispatcher over the
    batched serving tier.

    >>> sched = AsyncScheduler(block_size=8)
    >>> fut = sched.submit("lstsq", A, b, deadline=0.05, tenant="acme")
    >>> x = fut.result(timeout=1.0)  # the x batched_lstsq returns
    >>> sched.stats()["latency"]     # p50/p99, flush reasons, EWMA, ...
    >>> sched.shutdown()             # drains, then stops the workers

    ``config`` / ``**overrides`` are the :class:`DHQRConfig` knobs every
    request inherits (a per-request ``policy=`` makes its own group),
    ``serve_config`` the bucket lattice, ``cache`` the executable cache
    (the device's default, so a cache prewarmed for the sync tier serves
    the queue), ``device`` where the programs run (None: the card).
    ``start=False`` runs no worker: nothing flushes until :meth:`poll` or
    :meth:`drain`, and ``clock`` may be a fake (the tests' way to pin
    deadline and fairness decisions).
    """

    def __init__(
        self,
        config: Optional[DHQRConfig] = None,
        serve_config: Optional[ServeConfig] = None,
        sched_config: Optional[SchedulerConfig] = None,
        cache: Optional[ExecutableCache] = None,
        clock=time.monotonic,
        start: bool = True,
        workers: int = 2,
        device=None,
        **overrides,
    ) -> None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev                     # guarded by: frozen
        self._scfg = serve_config or ServeConfig.from_env()
        self._kcfg = sched_config or SchedulerConfig.from_env()
        self._cache = cache if cache is not None else default_cache(dev)
        self._base_config = config
        self._overrides = dict(overrides)   # guarded by: frozen

        self._clock = clock
        self._lock = _lockwitness.make_lock("AsyncScheduler._lock")
        self._work = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._resolved: dict = {}              # guarded by: _lock
        # fail fast on a bad base config (the sync tier's checks)
        self._resolve(None, None, "lstsq")
        self._groups: "dict[tuple, _Group]" = {}   # guarded by: _lock
        self._depth = 0            # queued, not yet popped for dispatch
        self._inflight = 0         # popped, dispatch not yet completed
        self._seq = 0
        self._draining = False
        self._closed = False
        self._crash_streak = 0     # consecutive worker crashes
        self._last_crash: "str | None" = None

        self.counters = Counters()
        self.latency = LatencyHistogram()
        self._ewma: "dict[Bucket, Ewma]" = {}  # guarded by: _lock
        self.keys_seen: set = set()            # guarded by: _lock
        _obs_metrics.registry().register("serve.sched", self)

        # Each worker runs the same select -> take -> flush loop against
        # the shared lock: one worker pads and scatters on the host while
        # another's programs run in their lanes.
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._threads: "list[threading.Thread]" = []  # guarded by: _lock
        if start:
            self._threads = [
                threading.Thread(target=self._run,
                                 name=f"dhqr-serve-dispatch-{i}", daemon=True)
                for i in range(workers)
            ]
            for t in self._threads:
                t.start()

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------ admission

    def _resolve(self, policy, plan, kind):
        """(policy, plan, kind) -> (cfg, pol, qr_solve_args) through the
        engine's own resolver, memoized per combination."""
        try:
            memo_key = (kind, policy, plan)
            with self._lock:
                hit = self._resolved.get(memo_key)
        except TypeError:           # unhashable policy/plan object
            memo_key, hit = None, None
        if hit is not None:
            return hit
        ov = dict(self._overrides)
        if policy is not None:
            ov["policy"] = policy
        if plan is not None:
            ov["plan"] = plan
        resolved = _engine._resolve_dispatch_cfg(kind, self._base_config, ov)
        if memo_key is not None:
            with self._lock:
                self._resolved[memo_key] = resolved
        return resolved

    def submit(
        self,
        kind: str,
        A,
        b=None,
        *,
        deadline: "float | None" = None,
        tenant: str = "default",
        policy=None,
        plan=None,
    ) -> Future:
        """Queue one request; returns a Future resolving to what the sync
        tier returns for it (``x`` for "lstsq" / "sketch", a
        ``QRFactorization`` for "qr"; for "update", ``A`` is an
        ``UpdatableQR`` and ``b`` the op ``("update", u, v)``,
        ``("downdate", u, v)`` or ``("solve", rhs)``).

        ``deadline`` is the latency budget in seconds from now
        (``SchedulerConfig.slo_ms`` when omitted). Raises
        :class:`BackpressureError` past the queue's high-water mark or an
        unmeetable admission price, and ``RuntimeError`` after
        :meth:`shutdown`."""
        if kind == "update":
            from dhqr_tpu_torch.solvers.update import UpdatableQR

            if not isinstance(A, UpdatableQR):
                raise ValueError(
                    "kind='update' takes an UpdatableQR session as its "
                    f"first argument, got {type(A).__name__}"
                )
            if policy is not None or plan is not None:
                raise ValueError(
                    "kind='update' ops take no policy=/plan= — the "
                    "session's numerics were fixed at construction"
                )
            if (not isinstance(b, tuple) or not b
                    or b[0] not in ("update", "downdate", "solve")
                    or (b[0] == "solve" and len(b) != 2)
                    or (b[0] in ("update", "downdate") and len(b) != 3)):
                raise ValueError(
                    "kind='update' payload must be ('update', u, v), "
                    "('downdate', u, v) or ('solve', rhs), got "
                    f"{b!r:.120}"
                )
            cfg = pol = qr_solve_args = None
        else:
            cfg, pol, qr_solve_args = self._resolve(policy, plan, kind)
            if kind in ("lstsq", "sketch"):
                if b is None:
                    raise ValueError(
                        f"kind={kind!r} needs a right-hand side b")
                _engine._validate_requests([A], [b])
            else:
                if b is not None:
                    raise ValueError("kind='qr' takes no right-hand side")
                _engine._validate_requests([A], None)
        bucket = plan_bucket(A.shape[0], A.shape[1], A.dtype, self._scfg)
        if deadline is None:
            deadline = self._kcfg.slo_ms / 1e3
        elif not deadline > 0:
            raise ValueError(f"deadline must be > 0 seconds, got {deadline}")

        now = self._clock()
        fut: Future = Future()
        rec = _obs.active()
        tid = rec.mint() if rec is not None else None
        if tid is not None:
            fut.trace_id = tid
        est = None
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is shut down")
            if self._depth >= self._kcfg.queue_depth:
                self.counters.bump("rejected")
                retry = self._retry_after_locked()
                err = BackpressureError(
                    f"admission queue full ({self._depth} >= "
                    f"{self._kcfg.queue_depth}); retry in ~{retry:.3f}s",
                    retry_after=retry)
                if rec is not None:
                    rec.attach(err, tid)
                    rec.event(tid, "reject", t=now, cause="queue_full",
                              retry_after=round(retry, 6),
                              depth=self._depth)
                raise err
            # Admission-priced deadline: reject now, with a priced hint,
            # a request the queue's expected drain time already dooms. A
            # bucket with no measurement yet is always admitted.
            est = self._admission_estimate_locked(bucket)
            if est is not None and est > deadline:
                self.counters.bump("rejected_unmeetable")
                retry = max(self._kcfg.flush_interval_ms / 1e3,
                            est - deadline)
                err = BackpressureError(
                    f"deadline {deadline:.3f}s cannot be met at the "
                    f"current queue (expected wait ~{est:.3f}s); retry "
                    f"in ~{retry:.3f}s", retry_after=retry)
                if rec is not None:
                    rec.attach(err, tid)
                    rec.event(tid, "reject", t=now, cause="unmeetable",
                              est_s=round(est, 6),
                              retry_after=round(retry, 6))
                raise err
            gkey = (kind, id(A)) if kind == "update" else \
                (kind, bucket, cfg, qr_solve_args)
            group = self._groups.get(gkey)
            if group is None:
                group = self._groups[gkey] = _Group(
                    kind, bucket, cfg, pol, qr_solve_args,
                    session=A if kind == "update" else None,
                    gkey=gkey if kind == "update" else None)
            self._seq += 1
            # the submit span lands before the entry becomes visible, so
            # a flight dump always opens at "submit"
            if rec is not None:
                attrs = {"kind": kind, "bucket": bucket.label,
                         "tenant": tenant, "deadline_s": round(deadline, 6),
                         "depth": self._depth + 1}
                if est is not None:
                    attrs["est_s"] = round(est, 6)
                rec.event(tid, "submit", t=now, **attrs)
            group.queue.append(_Pending(
                self._seq, A, b, tenant, now, now + deadline, fut,
                trace_id=tid))
            self._depth += 1
            self.counters.bump("submitted")
            self._work.notify()
        return fut

    def _retry_after_locked(self) -> float:
        """Backpressure hint: batches queued x the mean EWMA dispatch
        time, floored at the flush interval (a cold scheduler's product
        is 0)."""
        lat = [e.value for e in self._ewma.values() if e.value is not None]
        avg = sum(lat) / len(lat) if lat else 0.0
        batches = -(-self._depth // max(1, self._scfg.max_batch))
        return max(self._kcfg.flush_interval_ms / 1e3, batches * avg)

    def _admission_estimate_locked(self, bucket: Bucket) -> "float | None":
        """Expected seconds until a request submitted now into ``bucket``
        completes (queue depth x the bucket's EWMA), None before the
        bucket's first measurement."""
        ewma = self._ewma.get(bucket)
        val = ewma.value if ewma is not None else None
        if val is None or val <= 0.0:
            return None
        batches = -(-(self._depth + 1) // max(1, self._scfg.max_batch))
        return batches * val

    # ----------------------------------------------------------- flush policy

    def _lead_s(self, bucket: Bucket) -> float:
        ewma = self._ewma.get(bucket)
        val = ewma.value if ewma is not None else None
        return _LEAD_FACTOR * (val or 0.0) + _LEAD_FLOOR_S

    def _flush_reason(self, group: _Group, now: float) -> "str | None":
        if now < group.not_before:
            return None         # retry backoff window (drain bypasses)
        if len(group.queue) >= self._scfg.max_batch:
            return "full"
        oldest = group.queue[0]
        if now >= oldest.deadline_at - self._lead_s(group.bucket):
            return "deadline"
        if now - oldest.submitted_at >= self._kcfg.flush_interval_ms / 1e3:
            return "interval"
        return None

    def _next_wake_locked(self, now: float) -> "float | None":
        """Seconds until the earliest flush condition, None when nothing
        is queued (a busy update session and a group in backoff do not
        pull the horizon to now)."""
        soonest = None
        for group in self._groups.values():
            if not group.queue or group.busy:
                continue
            oldest = group.queue[0]
            t = min(
                oldest.deadline_at - self._lead_s(group.bucket),
                oldest.submitted_at + self._kcfg.flush_interval_ms / 1e3,
            )
            t = max(t, group.not_before)
            soonest = t if soonest is None else min(soonest, t)
        if soonest is None:
            return None
        return max(soonest - now, 0.0)

    def _select_locked(self, now: float, drain: bool):
        """The most urgent ready group, earliest oldest-deadline first:
        ``(group, reason)`` or None."""
        best, best_reason = None, None
        for group in self._groups.values():
            if not group.queue or group.busy:
                continue
            reason = "drain" if drain else self._flush_reason(group, now)
            if reason is None:
                continue
            if best is None or \
                    group.queue[0].deadline_at < best.queue[0].deadline_at:
                best, best_reason = group, reason
        return (best, best_reason) if best is not None else None

    def _take_locked(self, group: _Group, count: int) -> "list[_Pending]":
        """Pop up to ``count`` requests: the group's oldest always first,
        the rest by smooth weighted round-robin across tenants (FIFO
        within a tenant). Each round every tenant with work gains its
        weight, the richest (ties to the oldest head) yields its head and
        pays the active total back; credit stays on the group across
        flushes and is dropped for tenants with nothing queued. The
        "update" kind is strict FIFO."""
        if group.kind == "update":
            taken = [group.queue.popleft()
                     for _ in range(min(count, len(group.queue)))]
            self._depth -= len(taken)
            return taken
        by_tenant: "dict[str, collections.deque[_Pending]]" = {}
        for p in group.queue:
            by_tenant.setdefault(p.tenant, collections.deque()).append(p)
        if len(by_tenant) == 1:     # nothing to arbitrate
            taken = [group.queue.popleft()
                     for _ in range(min(count, len(group.queue)))]
            self._depth -= len(taken)
            group.credits.clear()
            return taken
        credit = group.credits
        taken: "list[_Pending]" = []

        def take_round(forced: "str | None" = None) -> None:
            total = sum(self._kcfg.weight_for(t) for t in by_tenant)
            winner = forced
            for t in by_tenant:
                credit[t] = credit.get(t, 0.0) + self._kcfg.weight_for(t)
                if forced is None and (
                        winner is None or credit[t] > credit[winner] or (
                            credit[t] == credit[winner]
                            and by_tenant[t][0].seq
                            < by_tenant[winner][0].seq)):
                    winner = t
            credit[winner] = credit.get(winner, 0.0) - total
            taken.append(by_tenant[winner].popleft())
            if not by_tenant[winner]:
                del by_tenant[winner]

        take_round(forced=group.queue[0].tenant)   # head of line first
        while len(taken) < count and by_tenant:
            take_round()
        taken_ids = {id(p) for p in taken}
        remaining = [p for p in group.queue if id(p) not in taken_ids]
        group.queue.clear()
        group.queue.extend(remaining)
        still_active = {p.tenant for p in remaining}
        for t in [t for t in credit if t not in still_active]:
            del credit[t]
        self._depth -= len(taken)
        return taken

    # ------------------------------------------------------------- dispatch

    def _span_batch(self, requests, name: str, t: "float | None" = None,
                    per=None, **attrs) -> None:
        """One span per request: the one spelling of every batch-level
        hop; ``per(p, now)`` adds per-request attributes."""
        rec = _obs.active()
        if rec is None:
            return
        now = self._clock() if t is None else t
        for p in requests:
            extra = per(p, now) if per is not None else {}
            rec.event(p.trace_id, name, t=now, **attrs, **extra)

    def _fence(self) -> None:
        """Wait for every device op this thread has enqueued, the lanes'
        replays included (this thread's stream waited for each lane): a
        CUDA event on the thread's current stream, never a device-wide
        synchronize, which would also wait for the other workers."""
        if self._device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._device))
        event.synchronize()

    def _flush(self, group: _Group, taken: "list[_Pending]",
               reason: str) -> None:
        """Dispatch one popped micro-batch through the engine's shared
        path, outside the scheduler lock. A dispatch failure is handled
        here (retry, bisect, or typed resolution), so it never reaches the
        worker loop. Every future is claimed first: a client's cancel()
        drops it here, and a claimed future cannot be cancelled later."""
        live: "list[_Pending]" = []
        for p in taken:
            if p.claimed or p.future.set_running_or_notify_cancel():
                p.claimed = True
                live.append(p)
            else:
                self.counters.bump("cancelled")
        if not live:
            return
        self.counters.bump(f"flush_{reason}")
        self._span_batch(
            live, "flush", reason=reason, batch=len(live),
            per=lambda p, now: {"wait_s": round(now - p.submitted_at, 6)})
        try:
            self._dispatch_batch(group, live)
        except Exception as e:
            # chunks that completed before the failure are resolved
            self._handle_failure(
                group, [p for p in live if not p.future.done()], e)

    def _dispatch_batch(self, group: _Group,
                        batch: "list[_Pending]") -> None:
        """One engine dispatch of ``batch``: resolves every future on
        success; on failure raises (typed where the engine or the cache
        classified it) without touching the unresolved futures."""
        if group.kind == "update":
            self._dispatch_update_ops(group, batch)
            return
        self.counters.bump("dispatches")
        self._span_batch(batch, "dispatch", bucket=group.bucket.label,
                         batch=len(batch))
        As = [p.A for p in batch]
        resolved: "list[tuple[int, object]]" = []
        keys: list = []
        emit = lambda i, val: resolved.append((i, val))  # noqa: E731
        if group.kind in ("lstsq", "sketch"):
            bs = [p.b for p in batch]
            consume_inner = _engine._scatter_lstsq(As, emit)
        else:
            bs = None
            consume_inner = _engine._scatter_qr(
                As, emit, group.qr_solve_args, self._device)

        def consume(chunk, key, outs):
            with self._lock:
                self.keys_seen.add(key)
            keys.append(key)
            consume_inner(chunk, key, outs)

        t0 = self._clock()
        compile0 = self._cache.timer.total("aot_compile")
        try:
            _engine._dispatch_groups(
                group.kind, As, bs, group.cfg, self._scfg, self._cache,
                consume, self._device, pol=group.pol)
        except Exception:
            # finished chunks of a multi-chunk batch resolve now; only the
            # failed remainder retries
            self._resolve_completed_chunks(batch, resolved)
            raise
        out: "list[object | None]" = [None] * len(batch)
        for i, val in resolved:
            out[i] = val
        try:
            self._fence()
        except Exception as e:
            raise DispatchFailed(keys[-1] if keys else
                                 (group.kind, group.bucket), e) from e
        # The EWMA prices WARM dispatch to the fence: a capture inside
        # this flush is taken out (priced with it, one spike would have
        # admission reject the bucket until the EWMA decays, which it
        # cannot while every request is rejected).
        compile_s = self._cache.timer.total("aot_compile") - compile0
        seconds = max(self._clock() - t0 - compile_s, 0.0)
        chunks = -(-len(batch) // self._scfg.max_batch)
        with self._lock:
            self._ewma.setdefault(group.bucket, Ewma()).update(
                seconds / max(1, chunks))
            self._crash_streak = 0  # dispatching again: crash storm over
        done = self._clock()
        self._span_batch(batch, "dispatch_ok", t=done,
                         seconds=round(seconds, 6),
                         compile_s=round(compile_s, 6), chunks=chunks)
        for p, val in zip(batch, out):
            self._resolve_success(p, val, done)

    def _dispatch_update_ops(self, group: _Group,
                             batch: "list[_Pending]") -> None:
        """The ``"update"`` kind's flush: each op against the group's live
        ``UpdatableQR`` in submission order, each resolved once its device
        work is fenced. The fault sites, the typed errors, the spans and
        the latency accounting are the batched kinds'. A
        ``NumericalError`` is the op's data: it fails that op alone (the
        session rolled it back) and the stream goes on; a ``ShardFailure``
        and any other failure raise out of the flush with the resolved ops
        excluded, so ``_handle_failure`` retries the remainder in order."""
        self.counters.bump("dispatches")
        self._span_batch(batch, "dispatch", bucket=group.bucket.label,
                         batch=len(batch))
        session = group.session
        for p in sorted(batch, key=lambda q: q.seq):
            _faults.latency("serve.latency")
            key = ("update", group.bucket.label, p.b[0])
            try:
                _faults.fire("serve.dispatch")
                op = p.b[0]
                if op == "solve":
                    val = session.solve(p.b[1])
                elif op == "update":
                    val = session.update(p.b[1], p.b[2])
                else:
                    val = session.downdate(p.b[1], p.b[2])
                self._fence()
            except ShardFailure:
                raise               # presumed transient: retry path
            except NumericalError as e:
                self.counters.bump("numeric_failures")
                self.counters.bump("poisoned")
                self._span_batch([p], "numeric_isolate",
                                 cause=type(e).__name__, batch=1)
                self._fail(p, e)
                continue
            except ServeError:
                raise
            except Exception as e:
                raise DispatchFailed(key, e) from e
            self._resolve_success(p, val, self._clock())

    def _resolve_success(self, p: _Pending, val, done: float) -> None:
        self.latency.record(done - p.submitted_at)
        if done > p.deadline_at:
            self.counters.bump("deadline_misses")
        self.counters.bump("completed")
        _obs.event(p.trace_id, "resolve", t=done, outcome="ok",
                   e2e_s=round(done - p.submitted_at, 6))
        p.future.set_result(val)

    def _resolve_completed_chunks(self, batch, resolved) -> None:
        """A chunked dispatch failed after some chunks consumed: fence
        them and resolve their futures; if the fence fails too, resolve
        nothing (everything retries). No EWMA sample either way."""
        if not resolved:
            return
        try:
            self._fence()
        except Exception:
            return
        done = self._clock()
        for i, val in resolved:
            self._resolve_success(batch[i], val, done)

    # ------------------------------------------------------ failure handling

    def _typed_error(self, group: _Group, exc: BaseException):
        """Every failure a future carries is typed: a ServeError or a
        NumericalError as raised, anything else a DispatchFailed."""
        if isinstance(exc, (ServeError, NumericalError)):
            return exc
        err = DispatchFailed((group.kind, group.bucket), exc)
        err.__cause__ = exc
        return err

    def _fail(self, p: _Pending, err: RuntimeError) -> None:
        self.counters.bump("failed")
        rec = _obs.active()
        if rec is not None:
            rec.event(p.trace_id, "resolve", t=self._clock(),
                      outcome=type(err).__name__, error=str(err)[:200])
            rec.on_error(err, p.trace_id)
        p.future.set_exception(err)

    def _requeue(self, group: _Group, batch: "list[_Pending]",
                 not_before: float) -> None:
        """Put a failed batch back at the FRONT of its group, in order,
        and arm the backoff horizon."""
        with self._lock:
            group.queue.extendleft(reversed(batch))
            self._depth += len(batch)
            group.not_before = max(group.not_before, not_before)
            self._work.notify_all()

    def _handle_failure(self, group: _Group, batch: "list[_Pending]",
                        exc: Exception) -> None:
        """Retry / bisect / typed failure of one failed flush, the JAX
        package's state machine:

        1. requests past their deadline fail typed now
           (``DeadlineExceeded`` chaining the error);
        2. ``Quarantined`` backs the group off for the cooldown, per
           request as its deadline allows (a drain fails them typed);
        3. a ``NumericalError`` (not a ``ShardFailure``) skips retry: a
           lone request fails typed, a batch bisects;
        4. other failures retry with backoff ``retry_base_ms * 2**k``
           within ``max_retries`` and the deadline, per request (the
           "update" kind moves as one unit, keyed on its head op);
        5. out of budget, a batch bisects until the poison request fails
           alone and the rest complete."""
        err = self._typed_error(group, exc)
        now = self._clock()
        self.counters.bump("flush_failures")
        alive: "list[_Pending]" = []
        for p in batch:
            if now >= p.deadline_at:
                dead = DeadlineExceeded(
                    f"deadline passed after a failed dispatch "
                    f"({type(err).__name__}: {err})")
                dead.__cause__ = err
                self._fail(p, dead)
            else:
                alive.append(p)
        if not alive:
            return
        if isinstance(err, Quarantined):
            wait = err.retry_after
            can_wait = [] if self._draining else \
                [p for p in alive if now + wait < p.deadline_at]
            waiting = set(map(id, can_wait))
            for p in alive:
                if id(p) not in waiting:
                    self._fail(p, err)
            if can_wait:
                self.counters.bump("retries")
                self._span_batch(can_wait, "retry", t=now,
                                 cause="Quarantined",
                                 cooldown_s=round(wait, 6))
                self._requeue(group, can_wait, now + wait)
            return
        if isinstance(err, NumericalError) and \
                not isinstance(err, ShardFailure):
            self.counters.bump("numeric_failures")
            self._span_batch(alive, "numeric_isolate", t=now,
                             cause=type(err).__name__, batch=len(alive))
            if len(alive) == 1:
                self.counters.bump("poisoned")
                self._fail(alive[0], err)
            else:
                self._isolate_now(group, alive, err)
            return
        if group.kind == "update":
            for p in alive:
                p.attempts += 1
            head = alive[0]
            backoff = (self._kcfg.retry_base_ms / 1e3
                       * (2 ** (head.attempts - 1)))
            if head.attempts <= self._kcfg.max_retries and \
                    now + backoff < head.deadline_at:
                self.counters.bump("retries")
                self._span_batch(alive, "retry", t=now,
                                 cause=type(err).__name__,
                                 backoff_s=round(backoff, 6),
                                 per=lambda p, _: {"attempt": p.attempts})
                self._requeue(group, alive, now + backoff)
            else:
                self._isolate_now(group, alive, err)
            return
        for p in alive:
            p.attempts += 1
        base = self._kcfg.retry_base_ms / 1e3
        can_wait, escalate = [], []
        for p in alive:
            backoff = base * (2 ** (p.attempts - 1))
            if p.attempts <= self._kcfg.max_retries and \
                    now + backoff < p.deadline_at:
                can_wait.append(p)
            else:
                escalate.append(p)
        if can_wait:
            self.counters.bump("retries")
            # the group horizon takes the soonest requeued backoff, and
            # the span records that actual wait
            soonest = min(base * (2 ** (p.attempts - 1)) for p in can_wait)
            self._span_batch(can_wait, "retry", t=now,
                             cause=type(err).__name__,
                             backoff_s=round(soonest, 6),
                             per=lambda p, _: {"attempt": p.attempts})
            self._requeue(group, can_wait, now + soonest)
        if escalate:
            self._isolate_now(group, escalate, err)

    def _isolate_now(self, group: _Group, batch: "list[_Pending]",
                     err: ServeError) -> None:
        """Escalation without retry budget: a batch bisects, a lone
        request gets one immediate re-dispatch (the attempt a bisection
        half would get) and fails typed only if it fails again."""
        self._span_batch(batch, "isolate", cause=type(err).__name__,
                         batch=len(batch))
        if len(batch) > 1:
            self._bisect(group, batch)
        else:
            self._dispatch_or_isolate(group, batch)

    def _bisect(self, group: _Group, batch: "list[_Pending]") -> None:
        self.counters.bump("bisections")
        self._span_batch(batch, "bisect", size=len(batch))
        mid = len(batch) // 2
        self._dispatch_or_isolate(group, batch[:mid])
        self._dispatch_or_isolate(group, batch[mid:])

    def _dispatch_or_isolate(self, group: _Group,
                             batch: "list[_Pending]") -> None:
        """Bisection leg: dispatch ``batch``; on failure split again until
        the culprit fails alone (O(log batch) splits)."""
        try:
            self._dispatch_batch(group, batch)
        except Exception as e:
            err = self._typed_error(group, e)
            batch = [p for p in batch if not p.future.done()]
            if not batch:
                return
            if len(batch) == 1:
                self.counters.bump("poisoned")
                self._fail(batch[0], err)
                return
            self._bisect(group, batch)

    def _flush_count(self, reason: str, queued: int) -> int:
        """How many requests a flush takes: everything on drain (the
        engine chunks past the cap), the cap when full, else the largest
        power of two <= queued (the batch axis is pow2-bucketed: 16 now
        and the rest later pads less than 19 padded to 32)."""
        if reason == "drain":
            return queued
        if queued >= self._scfg.max_batch:
            return self._scfg.max_batch
        return 1 << (queued.bit_length() - 1)

    def poll(self) -> int:
        """Flush every currently-ready group once; returns the number of
        flushes. The manual-mode twin of the worker loop."""
        flushed = 0
        while True:
            with self._lock:
                pick = self._select_locked(self._clock(), self._draining)
                if pick is None:
                    if flushed:
                        self._idle.notify_all()
                    return flushed
                group, reason = pick
                count = len(group.queue) if group.kind == "update" \
                    else self._flush_count(reason, len(group.queue))
                taken = self._take_locked(group, count)
                self._inflight += len(taken)
                if group.kind == "update":
                    group.busy = True   # serialize ops per session
            try:
                self._flush(group, taken, reason)
            except BaseException:
                # a crash past the failure handler (a bug, an injected
                # worker fault): requeue what this flush still owes before
                # the exception takes the worker down
                self._requeue(group,
                              [p for p in taken if not p.future.done()],
                              not_before=0.0)
                raise
            finally:
                with self._lock:
                    self._inflight -= len(taken)
                    if group.kind == "update":
                        group.busy = False
                        if not group.queue:
                            # idle update groups are pruned: keyed per
                            # live session, they would pin every session
                            self._groups.pop(group.gkey, None)
                        self._work.notify()
                    self._idle.notify_all()
            flushed += 1

    def _run(self) -> None:
        """Worker loop: wait for work or the next flush horizon, flush
        what is ready, repeat. A crash anywhere (the ``serve.worker``
        fault site included) is counted and answered by a respawn."""
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            while True:
                _faults.fire("serve.worker")
                with self._lock:
                    if self._closed and self._depth == 0:
                        return
                    now = self._clock()
                    ready = self._select_locked(
                        now, self._draining) is not None
                    if not ready:
                        timeout = self._next_wake_locked(now)
                        self._work.wait(timeout)
                        continue
                self.poll()
        except BaseException as e:
            self._on_worker_crash(threading.current_thread(), cause=e)

    def _on_worker_crash(self, thread: threading.Thread,
                         cause: "BaseException | None" = None) -> None:
        """Account a worker's death and spawn its replacement.

        The respawn gate is ``_run``'s own exit condition, so a crash
        during ``shutdown(drain=True)`` still finishes the queue.
        Consecutive crashes back the replacement off exponentially (to a
        ~2 s heartbeat), and a storm (two in a row) fails the queued
        requests whose deadline has passed, typed ``DeadlineExceeded``, so
        even a permanent crash cause resolves every finite deadline."""
        expired: "list[_Pending]" = []
        with self._lock:
            self.counters.bump("worker_crashes")
            if cause is not None:
                self._last_crash = "".join(traceback.format_exception(
                    type(cause), cause, cause.__traceback__))[-2000:]
            if self._closed and self._depth == 0:
                return
            self._crash_streak += 1
            if self._crash_streak >= 2:
                now = self._clock()
                for group in self._groups.values():
                    if any(now >= p.deadline_at for p in group.queue):
                        expired.extend(p for p in group.queue
                                       if now >= p.deadline_at)
                        group.queue = collections.deque(
                            p for p in group.queue if now < p.deadline_at)
                if expired:
                    self._depth -= len(expired)
                    self._idle.notify_all()
            delay = min(0.01 * (2 ** min(self._crash_streak - 1, 8)), 2.0)
            replacement = threading.Thread(
                target=self._respawned_run, args=(delay,),
                name=thread.name, daemon=True)
            try:
                self._threads[self._threads.index(thread)] = replacement
            except ValueError:  # an unmanaged caller thread: still recover
                self._threads.append(replacement)
        # respawn first: resolving the swept futures runs client callbacks
        replacement.start()
        for p in expired:
            if p.claimed or p.future.set_running_or_notify_cancel():
                dead = DeadlineExceeded(
                    "deadline passed while the dispatcher was "
                    "crash-looping (worker died repeatedly before the "
                    "request could flush)")
                dead.__cause__ = cause
                self._fail(p, dead)
            else:
                self.counters.bump("cancelled")

    def _respawned_run(self, delay: float) -> None:
        if delay > 0:
            time.sleep(delay)   # wall clock: crash-loop damping only
        self._run()

    # ------------------------------------------------------- lifecycle/stats

    def drain(self, timeout: "float | None" = None) -> None:
        """Flush and complete everything queued, regardless of deadlines
        (flush reason "drain"); blocks until the queue and the in-flight
        dispatches are empty. Without live workers it drains inline."""
        with self._lock:
            threads = list(self._threads)
        if not any(t.is_alive() for t in threads):
            with self._lock:
                self._draining = True
            try:
                self.poll()
            finally:
                with self._lock:
                    self._draining = False
            return
        # dhqr: ignore[DHQR008] drain's timeout bounds a REAL hang (wedged dispatch); it must keep ticking even under an injected scheduler clock
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            self._draining = True
            self._work.notify()
            while self._depth or self._inflight:
                left = None if deadline is None else \
                    deadline - time.monotonic()  # dhqr: ignore[DHQR008] same wall-clock hang bound as above
                if left is not None and left <= 0:
                    self._draining = False
                    raise TimeoutError(
                        f"drain timed out with {self._depth} queued, "
                        f"{self._inflight} in flight")
                if not self._idle.wait(0.05 if left is None else
                                       min(left, 0.05)):
                    self._work.notify()
            self._draining = False

    def shutdown(self, drain: bool = True,
                 timeout: "float | None" = None) -> None:
        """Stop accepting work and stop the workers. ``drain=True``
        completes everything accepted first; ``drain=False`` cancels the
        queued futures (a requeued retry, already running, fails typed).
        Admission closes before the drain, and futures resolve outside the
        lock (a router's relay callback may resubmit into a sibling)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if drain:
            self.drain(timeout=timeout)
        cancelled: "list[_Pending]" = []
        with self._lock:
            if not drain:
                for group in self._groups.values():
                    while group.queue:
                        cancelled.append(group.queue.popleft())
                        self._depth -= 1
            self._work.notify_all()
            threads = list(self._threads)
        for p in cancelled:
            if not p.future.cancel():
                self.counters.bump("failed")
                p.future.set_exception(ServeError(
                    "scheduler shut down (drain=False) "
                    "before the request's retry could run"))
        for t in threads:
            if t.is_alive():
                t.join(timeout=5.0)

    def __enter__(self) -> "AsyncScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    def queue_depth(self) -> int:
        with self._lock:
            return self._depth

    @property
    def healthy(self) -> bool:
        """Whether a fleet router should route new work here: open for
        admission and not crash-storming (two crashes in a row)."""
        with self._lock:
            return not self._closed and self._crash_streak < 2

    #: The counters the registry exports (``serve.sched.<name>``) and
    #: stats() mirrors.
    _METRIC_COUNTERS = (
        "submitted", "completed", "failed", "rejected",
        "rejected_unmeetable", "cancelled", "deadline_misses",
        "dispatches", "flush_failures", "retries", "bisections",
        "numeric_failures", "poisoned", "worker_crashes",
    )

    def metrics_snapshot(self) -> dict:
        """The registry-facing flat snapshot (``serve.sched.*``): every
        counter, the queue's occupancy, the flush reasons
        (``flush.<reason>``) and the latency summary (``latency.p99_ms``,
        ...)."""
        snap = self.counters.snapshot()
        with self._lock:
            depth, inflight = self._depth, self._inflight
        out: dict = {name: int(snap.get(name, 0))
                     for name in self._METRIC_COUNTERS}
        out["queue_depth"] = depth
        out["inflight"] = inflight
        for reason in ("full", "deadline", "interval", "drain"):
            out[f"flush.{reason}"] = int(snap.get(f"flush_{reason}", 0))
        for key, val in self.latency.snapshot().items():
            out[f"latency.{key}"] = val
        return out

    def stats(self) -> dict:
        """JSON-ready snapshot: :meth:`metrics_snapshot` in the JAX
        package's dict layout, with the per-bucket EWMA (ms), the last
        worker crash and the cache's stats."""
        m = self.metrics_snapshot()
        with self._lock:
            last_crash = self._last_crash
            ewma_ms = {
                b.label: round((e.value or 0.0) * 1e3, 3)
                for b, e in sorted(self._ewma.items())
            }
        out = {name: m[name] for name in
               ("queue_depth", "inflight") + self._METRIC_COUNTERS}
        out["last_worker_crash"] = last_crash
        out["flushes"] = {
            reason: m[f"flush.{reason}"]
            for reason in ("full", "deadline", "interval", "drain")
        }
        out["latency"] = {
            key: m[f"latency.{key}"]
            for key in ("count", "mean_ms", "p50_ms", "p99_ms")
        }
        out["bucket_ewma_ms"] = ewma_ms
        out["cache"] = self._cache.stats()
        return out


def dispatch_program(kind: str, config: Optional[DHQRConfig] = None,
                     **overrides):
    """The program one async flush dispatches: the engine's own
    :func:`~dhqr_tpu_torch.serve.engine.bucket_program` (the scheduler owns
    no second lowering path)."""
    return _engine.bucket_program(kind, config, **overrides)
