"""Fleet replica router: K in-process schedulers behind one submit() — port
of ``dhqr_tpu/serve/router.py``.

:class:`Router` fronts K :class:`~dhqr_tpu_torch.serve.scheduler.
AsyncScheduler` replicas that share one device's executable cache (and the
key store under it, when ``DHQR_FLEET_STORE`` is set), and owns what no
single scheduler can:

* **Tenant-aware weighted balancing.** Each tenant has its own smooth-WRR
  credit vector over the replicas: replica ``i`` earns ``weight[i]`` per
  pick, the richest wins and pays the round's total back, so a tenant's
  stream spreads weight-proportionally and two tenants interleave.
* **Backpressure composition.** A replica's
  :class:`~dhqr_tpu_torch.serve.errors.BackpressureError` is a reroute:
  the router tries the other healthy replicas in credit order and refuses
  only when every one refused, with the **minimum** of their priced
  ``retry_after`` hints.
* **Typed failover.** A replica that dies with requests queued (``kill``,
  an external ``shutdown(drain=False)``, a crash storm) cancels or fails
  them with the scheduler's bare ``ServeError``; the relay callback
  resubmits each to a healthy sibling within the request's deadline and
  ``FleetConfig.failovers``, else resolves it
  :class:`~dhqr_tpu_torch.serve.errors.ReplicaLost`. Every future the
  router hands out resolves, a result or a typed ``ServeError``.

``kind="update"`` sessions are sticky: a live ``UpdatableQR``'s ops are
serialized inside one scheduler, so the router pins a session to one
replica and re-pins only on failover.

On the card the replicas share one device and its lanes (``serve.cache.
DeviceLane``): K replicas multiply admission queues and host workers; two
replays overlap on the card only when their keys sit on two lanes. Everything here is host-side; killing a replica loses
queue position, never data.
"""

from __future__ import annotations

import time
from concurrent.futures import Future

from dhqr_tpu_torch.obs import metrics as _obs_metrics
from dhqr_tpu_torch.serve.errors import BackpressureError, ReplicaLost, ServeError
from dhqr_tpu_torch.serve.scheduler import AsyncScheduler
from dhqr_tpu_torch.utils import lockwitness as _lockwitness
from dhqr_tpu_torch.utils.config import FleetConfig
from dhqr_tpu_torch.utils.profiling import Counters


class _Relay:
    """One accepted request's routing state: the client's future, the
    submit arguments (for a resubmission), the absolute deadline and the
    failover budget left. Mutated only by its own chain of callbacks."""

    __slots__ = ("kind", "A", "b", "tenant", "policy", "plan",
                 "deadline_at", "failovers_left", "attempts",
                 "replica_idx", "outer")

    def __init__(self, kind, A, b, tenant, policy, plan,
                 deadline_at, failovers_left, replica_idx, outer):
        self.kind = kind
        self.A = A
        self.b = b
        self.tenant = tenant
        self.policy = policy
        self.plan = plan
        self.deadline_at = deadline_at
        self.failovers_left = failovers_left
        self.attempts = 1          # submits that a replica accepted
        self.replica_idx = replica_idx
        self.outer = outer


class Router:
    """Tenant-aware smooth-WRR router over K in-process scheduler replicas,
    with fleet-wide backpressure composition and typed failover.

    >>> router = Router(replicas=3)
    >>> fut = router.submit("lstsq", A, b, tenant="acme")
    >>> x = fut.result(timeout=1.0)  # the x one scheduler returns
    >>> router.kill(0)               # a whole replica dies mid-stream
    >>> router.shutdown()            # drains the rest, saves fleet state

    ``replicas`` is an int (that many ``scheduler_factory()`` replicas,
    default ``AsyncScheduler(**sched_kwargs)``) or a list of schedulers.
    ``weights`` skews the WRR rates (default equal). With
    ``fleet.state_path`` set, construction adopts the shared fleet state
    and :meth:`shutdown` publishes this process's verdicts back."""

    def __init__(
        self,
        replicas=None,
        *,
        fleet: "FleetConfig | None" = None,
        weights=None,
        scheduler_factory=None,
        clock=time.monotonic,
        **sched_kwargs,
    ) -> None:
        self._fleet = fleet or FleetConfig.from_env()
        self._clock = clock
        if replicas is None:
            replicas = self._fleet.replicas
        if isinstance(replicas, int):
            if replicas < 1:
                raise ValueError(f"replicas must be >= 1, got {replicas}")
            factory = scheduler_factory or \
                (lambda: AsyncScheduler(**sched_kwargs))
            self._replicas = [factory() for _ in range(replicas)]
        else:
            self._replicas = list(replicas)     # guarded by: frozen
            if not self._replicas:
                raise ValueError("replicas list must be non-empty")
        k = len(self._replicas)
        if weights is None:
            weights = [1.0] * k
        weights = [float(w) for w in weights]
        if len(weights) != k or any(w <= 0 for w in weights):
            raise ValueError(
                f"weights must be {k} positive numbers, got {weights!r}")
        self._weights = weights                 # guarded by: frozen
        self._lock = _lockwitness.make_lock("Router._lock")
        # tenant -> per-replica smooth-WRR credits
        self._credits: "dict[str, list[float]]" = {}  # guarded by: _lock
        self._dead = [False] * k                # guarded by: _lock
        # id(update session) -> pinned replica
        self._sticky: "dict[int, int]" = {}     # guarded by: _lock
        self._closed = False                    # guarded by: _lock
        self.counters = Counters()
        _obs_metrics.registry().register("fleet.router", self)
        if self._fleet.state_path:
            from dhqr_tpu_torch.serve import store as _store_mod

            _store_mod.load_fleet_state(self._fleet.state_path,
                                        cache=self._replicas[0]._cache)

    # ------------------------------------------------------------ balancing

    def _healthy_indices(self) -> "list[int]":
        # each replica's ``healthy`` takes its own lock: read outside ours
        with self._lock:
            dead = list(self._dead)
        return [i for i, r in enumerate(self._replicas)
                if not dead[i] and r.healthy]

    def _pick_order(self, tenant: str, healthy: "list[int]",
                    exclude: "int | None" = None) -> "list[int]":
        """One smooth-WRR pick: every healthy replica earns its weight,
        the richest wins and pays the total back. Returns every candidate,
        the winner first, then by descending credit (the try order)."""
        candidates = [i for i in healthy if i != exclude]
        if not candidates:
            return []
        with self._lock:
            credits = self._credits.get(tenant)
            if credits is None:
                credits = self._credits[tenant] = [0.0] * len(self._replicas)
            total = 0.0
            for i in candidates:
                credits[i] += self._weights[i]
                total += self._weights[i]
            best = max(candidates, key=lambda i: (credits[i], -i))
            credits[best] -= total
            rest = sorted((i for i in candidates if i != best),
                          key=lambda i: (-credits[i], i))
        return [best] + rest

    # ------------------------------------------------------------ admission

    def submit(self, kind: str, A, b=None, *, deadline: "float | None" = None,
               tenant: str = "default", policy=None, plan=None) -> Future:
        """Route one request; returns a future resolving to what the
        chosen scheduler's future resolves to, across failovers included.
        Raises :class:`BackpressureError` (the fleet's minimum
        ``retry_after``) only when every healthy replica refused,
        :class:`ReplicaLost` when none is healthy, and ``RuntimeError``
        after :meth:`shutdown`."""
        with self._lock:
            if self._closed:
                raise RuntimeError("router is shut down")
        if deadline is None:
            deadline = self._replicas[0]._kcfg.slo_ms / 1e3
        elif not deadline > 0:
            raise ValueError(f"deadline must be > 0 seconds, got {deadline}")
        healthy = self._healthy_indices()
        if not healthy:
            self.counters.bump("lost")
            raise ReplicaLost(
                f"no healthy replica among {len(self._replicas)} "
                "(all shut down or crash-storming)")
        if kind == "update":
            order = self._sticky_order(A, healthy, tenant)
        else:
            order = self._pick_order(tenant, healthy)
        self.counters.bump("submitted")
        deadline_at = self._clock() + deadline
        outer: Future = Future()
        min_retry = None
        for n, idx in enumerate(order):
            try:
                inner = self._replicas[idx].submit(
                    kind, A, b, deadline=deadline, tenant=tenant,
                    policy=policy, plan=plan)
            except BackpressureError as err:
                if min_retry is None or err.retry_after < min_retry:
                    min_retry = err.retry_after
                continue
            except RuntimeError as err:
                if isinstance(err, NotImplementedError):
                    raise           # a refused knob (NotPortedError) is the caller's
                # closed under us between the health check and the submit
                self._mark_dead(idx)
                continue
            if n > 0:
                self.counters.bump("backpressure_reroutes")
            self.counters.bump("routed")
            relay = _Relay(kind, A, b, tenant, policy, plan, deadline_at,
                           self._fleet.failovers, idx, outer)
            tid = getattr(inner, "trace_id", None)
            if tid is not None:
                outer.trace_id = tid
            self._chain(relay, inner)
            return outer
        if min_retry is not None:
            self.counters.bump("rejected")
            raise BackpressureError(
                f"all {len(order)} healthy replicas refused admission; "
                f"retry in ~{min_retry:.3f}s", retry_after=min_retry)
        self.counters.bump("lost")
        raise ReplicaLost(
            "every healthy replica shut down while routing the request")

    def _sticky_order(self, session, healthy: "list[int]",
                      tenant: str) -> "list[int]":
        """Pin an update session to one replica; re-pin by WRR when the
        pinned replica is gone."""
        sid = id(session)
        with self._lock:
            idx = self._sticky.get(sid)
        if idx is not None and idx in healthy:
            return [idx]
        order = self._pick_order(tenant, healthy)
        with self._lock:
            self._sticky[sid] = order[0]
        return [order[0]]

    # ------------------------------------------------------------- failover

    def _chain(self, relay: _Relay, inner: Future) -> None:
        def _on_done(f: Future, relay=relay) -> None:
            try:
                self._relay_done(relay, f)
            except Exception as err:
                # runs inside a scheduler's resolution path: nothing may
                # escape, and the outer future still resolves typed
                if not relay.outer.done():
                    if relay.outer.set_running_or_notify_cancel():
                        relay.outer.set_exception(ServeError(
                            f"router relay failed: "
                            f"{type(err).__name__}: {err}"))
        inner.add_done_callback(_on_done)

    def _relay_done(self, relay: _Relay, inner: Future) -> None:
        """Resolve the outer future from a finished inner one, or fail the
        request over when the inner one died of its replica's death
        (cancelled, or exactly the bare ``ServeError`` of a drain=False
        shutdown: every deliberate failure is a subclass and passes)."""
        outer = relay.outer
        if outer.cancelled():
            self.counters.bump("cancelled")
            return
        if inner.cancelled():
            err = None
            replica_died = True
        else:
            err = inner.exception()
            replica_died = type(err) is ServeError
        if not replica_died:
            if not outer.set_running_or_notify_cancel():
                self.counters.bump("cancelled")
                return
            if err is not None:
                outer.set_exception(err)
            else:
                outer.set_result(inner.result())
            return
        self._mark_dead(relay.replica_idx)
        remaining = relay.deadline_at - self._clock()
        healthy = self._healthy_indices()
        if relay.failovers_left > 0 and remaining > 0 and healthy:
            order = self._pick_order(relay.tenant, healthy,
                                     exclude=relay.replica_idx)
            for idx in order:
                try:
                    nxt = self._replicas[idx].submit(
                        relay.kind, relay.A, relay.b, deadline=remaining,
                        tenant=relay.tenant, policy=relay.policy,
                        plan=relay.plan)
                except (BackpressureError, RuntimeError):
                    continue
                relay.failovers_left -= 1
                relay.attempts += 1
                relay.replica_idx = idx
                if relay.kind == "update":
                    with self._lock:
                        self._sticky[id(relay.A)] = idx
                self.counters.bump("failovers")
                self._chain(relay, nxt)
                return
        self.counters.bump("lost")
        if outer.set_running_or_notify_cancel():
            cause = ("no healthy sibling accepted the retry"
                     if relay.failovers_left > 0 and remaining > 0
                     else "failover budget exhausted"
                     if remaining > 0 else "deadline already passed")
            lost = ReplicaLost(
                f"replica {relay.replica_idx} died with the request "
                f"queued and {cause} (attempts={relay.attempts})",
                attempts=relay.attempts)
            lost.__cause__ = err
            outer.set_exception(lost)
        else:
            self.counters.bump("cancelled")

    def _mark_dead(self, idx: int) -> None:
        with self._lock:
            if not self._dead[idx]:
                self._dead[idx] = True
                self.counters.bump("replicas_lost")

    # ------------------------------------------------------ chaos/lifecycle

    def kill(self, idx: int) -> None:
        """Hard-kill replica ``idx`` mid-stream (``shutdown(drain=False)``:
        its queued futures cancel and fail over through the relay
        callbacks before this returns). Idempotent."""
        self._mark_dead(idx)
        self.counters.bump("replica_kills")
        self._replicas[idx].shutdown(drain=False)

    def prewarm(self, shapes, kind: str = "lstsq", **kwargs):
        """Capture the programs a request mix needs into the cache the
        replicas share, before routing traffic
        (:func:`dhqr_tpu_torch.serve.engine.prewarm` on the first
        replica's cache and device)."""
        from dhqr_tpu_torch.serve import engine as _engine

        first = self._replicas[0]
        kwargs.setdefault("cache", first._cache)
        kwargs.setdefault("device", first.device)
        return _engine.prewarm(shapes, kind=kind, **kwargs)

    def drain(self, timeout: "float | None" = None) -> None:
        """Complete everything queued on every live replica; a second pass
        covers requests that failed over during the first."""
        for _ in range(2):
            with self._lock:
                dead = list(self._dead)
            for i, rep in enumerate(self._replicas):
                if not dead[i]:
                    rep.drain(timeout=timeout)

    def shutdown(self, drain: bool = True,
                 timeout: "float | None" = None) -> None:
        """Stop the fleet: close admission, shut every replica down
        (``drain=True`` completes accepted work first), and publish this
        process's verdicts to the shared state file when one is set."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            dead = list(self._dead)
        for i, rep in enumerate(self._replicas):
            rep.shutdown(drain=drain and not dead[i], timeout=timeout)
            self._mark_dead(i)
        if self._fleet.state_path:
            from dhqr_tpu_torch.serve import store as _store_mod

            _store_mod.save_fleet_state(self._fleet.state_path,
                                        cache=self._replicas[0]._cache)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    # ---------------------------------------------------------------- stats

    @property
    def replicas(self) -> "list[AsyncScheduler]":
        return list(self._replicas)

    def queue_depth(self) -> int:
        with self._lock:
            dead = list(self._dead)
        return sum(r.queue_depth() for i, r in enumerate(self._replicas)
                   if not dead[i])

    _METRIC_COUNTERS = (
        "submitted", "routed", "backpressure_reroutes", "rejected",
        "failovers", "lost", "cancelled", "replica_kills", "replicas_lost",
    )

    def metrics_snapshot(self) -> dict:
        """The registry-facing flat snapshot (``fleet.router.*``): the
        routing counters, the fleet's occupancy and health."""
        snap = self.counters.snapshot()
        out: dict = {name: int(snap.get(name, 0))
                     for name in self._METRIC_COUNTERS}
        out["replicas"] = len(self._replicas)
        out["replicas_healthy"] = len(self._healthy_indices())
        out["queue_depth"] = self.queue_depth()
        return out

    def stats(self) -> dict:
        """JSON-ready snapshot: the router metrics and each replica's own
        ``metrics_snapshot()`` with its health."""
        out = self.metrics_snapshot()
        with self._lock:
            dead = list(self._dead)
        out["per_replica"] = [
            {"healthy": (not dead[i]) and rep.healthy,
             **rep.metrics_snapshot()}
            for i, rep in enumerate(self._replicas)
        ]
        return out


__all__ = ["Router"]

