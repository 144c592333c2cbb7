"""The serving tier of the port (``dhqr_tpu_torch.serve``), ported from
``dhqr_tpu.serve``: bucket planning, the bucket-program cache (CUDA graphs
captured once per key on the card, each pinned to one of its device's
lanes), the
batched entry points, the async scheduler, the fleet router and the key
store with the shared fleet state.

    >>> xs = dhqr_tpu_torch.batched_lstsq(As, bs)        # list in, list out
    >>> facts = dhqr_tpu_torch.batched_qr(As)
    >>> serve.prewarm([(32, 384, 128), (8, 640, 256)])   # capture ahead
    >>> serve.cache_stats()                              # hits, misses, ...
    >>> sched = serve.AsyncScheduler()                   # deadlines, WRR
    >>> x = sched.submit("lstsq", A, b, deadline=0.5).result(timeout=1)
    >>> router = serve.Router(replicas=3)                # failover, WRR
"""

from dhqr_tpu_torch.serve.buckets import (
    Bucket,
    bucket_batch,
    bucket_dim,
    pad_group,
    plan_bucket,
)
from dhqr_tpu_torch.serve.cache import (
    CacheKey,
    ExecutableCache,
    cache_stats,
    canonical_key,
    clear_cache,
    default_cache,
)
from dhqr_tpu_torch.serve.engine import (
    batched_lstsq,
    batched_qr,
    batched_sketched_lstsq,
    bucket_program,
    prewarm,
)
from dhqr_tpu_torch.serve.router import Router
from dhqr_tpu_torch.serve.scheduler import AsyncScheduler
from dhqr_tpu_torch.serve.store import (
    ExecutableStore,
    default_store,
    load_fleet_state,
    save_fleet_state,
)
from dhqr_tpu_torch.serve.errors import (
    BackpressureError,
    CompileFailed,
    DeadlineExceeded,
    DispatchFailed,
    Quarantined,
    ReplicaLost,
    ServeError,
)

__all__ = [
    "AsyncScheduler",
    "BackpressureError",
    "Bucket",
    "CacheKey",
    "CompileFailed",
    "DeadlineExceeded",
    "DispatchFailed",
    "ExecutableCache",
    "ExecutableStore",
    "Quarantined",
    "ReplicaLost",
    "Router",
    "ServeError",
    "batched_lstsq",
    "batched_qr",
    "batched_sketched_lstsq",
    "bucket_batch",
    "bucket_dim",
    "bucket_program",
    "cache_stats",
    "canonical_key",
    "clear_cache",
    "default_cache",
    "default_store",
    "load_fleet_state",
    "save_fleet_state",
    "pad_group",
    "plan_bucket",
    "prewarm",
]
