"""Batched serving entry points — port of ``dhqr_tpu/serve/engine.py``:
group -> stack -> one dispatch -> scatter.

``batched_qr`` / ``batched_lstsq`` / ``batched_sketched_lstsq`` take a LIST
of heterogeneous requests and turn them into a handful of dispatches of
the batched engine:

1. every request's ``(m, n, dtype)`` is rounded onto the bucket lattice
   (``serve.buckets.plan_bucket``: exact orthogonal-column and zero-row
   padding, so truncated answers are exact);
2. each bucket group is stacked into one buffer on the device (one
   host-to-device copy for host arrays) and dispatched through the bucket
   program cache (``serve.cache``: a CUDA graph captured once per key on
   the card, replayed per dispatch);
3. the results are sliced back out IN INPUT ORDER, truncated to each
   request's own shape, from copies of the program's outputs, so a later
   replay of the same key cannot change them.

Engine scope, as in the JAX package: the blocked Householder engine with
the plain panel loop, single device (``pallas=False`` there: the fused
panel kernel is a single-problem tier). Here that is the stacked engine of
``ops/blocked.py`` (``_batched_qr_impl``), one batched op per panel step
and trailing update, and no Hopper panel kernel. Precision policies and
refinement compose as on ``lstsq``: the policy's panel/trailing go to the
factor stage, ``apply`` to the Q^H-apply, ``refine`` into sweeps inside
the program. ``plan=`` ("auto", "default" or a
:class:`~dhqr_tpu_torch.tune.Plan`) resolves once per bucket, on the
bucket's shape (:func:`_resolve_bucket_plan`), before the key is minted, so
a tuned dispatch and its prewarm hit the same program.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from functools import partial
from typing import List, Optional, Sequence

import torch

from dhqr_tpu_torch.faults import harness as _faults
from dhqr_tpu_torch.numeric import guards as _nguards
from dhqr_tpu_torch.numeric.errors import Breakdown
from dhqr_tpu_torch.obs import pulse as _pulse
from dhqr_tpu_torch.obs import trace as _obs
from dhqr_tpu_torch.obs import xray as _obs_xray
from dhqr_tpu_torch.ops import blocked as _blocked
from dhqr_tpu_torch.ops import gemm as _gemm
from dhqr_tpu_torch.ops import solve as _solve
from dhqr_tpu_torch.serve.buckets import (
    Bucket,
    bucket_batch,
    dtype_name,
    pad_group,
    plan_bucket,
)
from dhqr_tpu_torch.serve.cache import (
    CacheKey,
    ExecutableCache,
    LoweredProgram,
    default_cache,
)
from dhqr_tpu_torch.serve.errors import DispatchFailed, ServeError
from dhqr_tpu_torch.tune.registry import SERVE_PROGRAM_KINDS
from dhqr_tpu_torch.utils.config import (
    DHQRConfig,
    ServeConfig,
    SketchConfig,
)
from dhqr_tpu_torch.utils.device import as_tensor, resolve_device

# Default compact-WY panel width of the batched dispatches (block_size=
# None), the JAX package's: measured on the CPU there (nb=32 beat 128 by
# 2.4-4.5x on stacks of 16); the card's best width is not measured.
SERVE_DEFAULT_BLOCK = 32

#: Why a key with the reconstruct panel engine runs eager on the card.
RECONSTRUCT_EAGER = (
    "panel_impl='reconstruct' factors its panels with torch.linalg.qr, "
    "whose cuSOLVER path checks its status on the host: a host read "
    "cannot be captured in a CUDA graph")


def _batched_lstsq_impl(A, b, block_size, precision="highest",
                        trailing_precision=None, apply_precision=None,
                        refine=0, norm="accurate", panel_impl="loop"):
    """One bucket's least-squares program over stacks A (B, m, n) and
    b (B, m): the batched blocked factorization of a copy of A, the
    two-stage solve, and ``refine`` refinement sweeps (residual matvec at
    full precision, reusing the factorization). Returns x (B, n)."""
    ap = precision if apply_precision is None else apply_precision
    H, alpha = _blocked._batched_qr_impl(
        A.clone(), block_size, precision=precision, norm=norm,
        panel_impl=panel_impl, trailing_precision=trailing_precision)

    def qr_solve(r):
        c = _blocked._apply_qt_impl(H, r, block_size, precision=ap)
        return _solve._back_substitute(H, alpha, c)

    x = qr_solve(b)
    for _ in range(refine):
        resid = b - _gemm.matmul(A, x[..., None], "highest")[..., 0]
        x = x + qr_solve(resid)
    return x


def _check_panel_impl(cfg: DHQRConfig) -> None:
    """The JAX package's panel_impl validation (``qr_model``)."""
    if cfg.panel_impl.startswith("reconstruct"):
        _blocked._reconstruct_chunk(cfg.panel_impl)
    elif cfg.panel_impl not in ("loop", "recursive"):
        raise ValueError(
            f"panel_impl must be 'loop', 'recursive', 'reconstruct' or "
            f"'reconstruct:<chunk>', got {cfg.panel_impl!r}")
    if cfg.panel_impl != "loop" and not cfg.blocked:
        raise ValueError(
            "panel_impl applies to the blocked engines only "
            f"(got panel_impl={cfg.panel_impl!r} with blocked=False)")


def _resolve_serve_cfg(config: Optional[DHQRConfig],
                       overrides) -> "tuple[DHQRConfig, object]":
    """Shared config/policy resolution of the serve entry points — the
    single-request API's chain, so a config error reads the same served
    singly or batched. Returns ``(cfg, policy)`` with the policy's
    precision fields folded into the classic knobs."""
    from dhqr_tpu_torch.models.qr_model import _resolve_policy_cfg

    cfg = dataclasses.replace(config or DHQRConfig(), **overrides)
    cfg, pol = _resolve_policy_cfg(cfg)
    if cfg.engine != "householder":
        raise ValueError(
            f"the serving tier's configs keep engine='householder' (got "
            f"engine={cfg.engine!r}): program families are selected by "
            "the KIND — batched_lstsq/batched_qr batch the blocked "
            "householder engine, batched_sketched_lstsq is the sketched "
            "kind (its knobs steer the sketch core) — while the "
            "tsqr/cholqr families are single-problem fast paths"
        )
    if not cfg.blocked:
        raise ValueError(
            "the serving tier batches the blocked engine only "
            "(got blocked=False)"
        )
    if cfg.use_pallas == "always":
        raise ValueError(
            "use_pallas='always' is not supported on the serving tier: "
            "the fused panel kernel is a single-problem VMEM tier; "
            "batched dispatches run the vmapped XLA path"
        )
    if cfg.lookahead or cfg.agg_panels:
        raise ValueError(
            "lookahead/agg_panels are panel-schedule levers for large "
            "single factorizations; the serving tier's buckets are small "
            f"(got lookahead={cfg.lookahead}, agg_panels={cfg.agg_panels})"
        )
    if cfg.norm not in ("accurate", "fast"):
        raise ValueError(
            f"norm must be 'accurate' or 'fast', got {cfg.norm!r}"
        )
    if cfg.refine < 0:
        raise ValueError(f"refine must be >= 0, got {cfg.refine}")
    _check_panel_impl(cfg)
    _check_plan_spec(cfg.plan)
    return cfg, pol


def _check_plan_spec(spec) -> None:
    """Refuse a ``plan=`` that is not None, "auto", "default" or a Plan
    when the request is resolved (the JAX package finds it at the
    bucket's resolution, with the same message)."""
    from dhqr_tpu_torch.tune import Plan

    if spec is None or isinstance(spec, Plan) or spec in ("auto",
                                                          "default"):
        return
    raise ValueError(
        f"plan must be 'auto', 'default', None or a "
        f"dhqr_tpu_torch.tune.Plan, got {spec!r}"
    )


def _resolve_bucket_plan(kind: str, cfg: DHQRConfig, bucket: Bucket, pol,
                         device=None) -> DHQRConfig:
    """Per-bucket twin of ``models.qr_model._resolve_plan_cfg`` (the JAX
    package's rules and messages): the serve tier's plan key is the
    BUCKET shape on the dispatch's device, so ``plan="auto"`` resolves
    once per bucket, and the tuned knobs land on the config before
    :func:`_plan_key` mints the cache key."""
    spec = cfg.plan
    if spec is None:
        return cfg
    if isinstance(spec, str) and spec == "default":
        return dataclasses.replace(cfg, plan=None)
    from dhqr_tpu_torch.tune import Plan, apply_plan_to_config, resolve_plan

    if cfg.block_size is not None or cfg.panel_impl != "loop":
        raise ValueError(
            "pass either plan= or block_size=/panel_impl=, not both "
            f"(got block_size={cfg.block_size}, "
            f"panel_impl={cfg.panel_impl!r} with plan={spec!r})"
        )
    if isinstance(spec, Plan):
        plan = spec
    else:
        _check_plan_spec(spec)
        plan = resolve_plan(f"serve_{kind}", bucket.m, bucket.n,
                            bucket.dtype, policy=pol, device=device)
        if plan is None:  # DB miss with on_miss="default"
            return dataclasses.replace(cfg, plan=None)
    if plan.engine != "householder" or plan.lookahead or plan.agg_panels \
            or plan.comms:
        raise ValueError(
            "serve plans carry block_size/panel_impl/trailing_precision "
            "only (the serving tier batches the blocked householder "
            "engine — no schedule levers, and no collectives for a "
            f"comms wire format to compress); got {plan.describe()!r}"
        )
    if plan.trailing_precision and cfg.trailing_precision is not None:
        raise ValueError(
            f"the plan carries trailing_precision="
            f"{plan.trailing_precision!r} but the policy/config already "
            f"set {cfg.trailing_precision!r} — drop one"
        )
    return apply_plan_to_config(cfg, plan)


def _sketch_triple(m: int, n: int) -> "tuple[int, int, str]":
    """``(s, seed, operator)`` of a sketch bucket, from ``SketchConfig``."""
    from dhqr_tpu_torch.solvers import sketch as _sketch

    skcfg = SketchConfig.from_env()
    s = _sketch.sketch_dim(m, n, factor=skcfg.factor)
    return s, skcfg.seed, _sketch.resolve_operator(skcfg.operator, m)


def _plan_key(kind: str, count: int, m: int, n: int, dtype,
              cfg: DHQRConfig, scfg: ServeConfig) -> "tuple[CacheKey, Bucket]":
    """The ONE place a request shape + config becomes a cache key, shared
    by live dispatch and :func:`prewarm` (the JAX package's rule, field
    for field). ``cfg.comms`` is not a key field: bucket programs run no
    collective."""
    bucket = plan_bucket(m, n, dtype, scfg)
    batch = bucket_batch(count, scfg)
    nb = min(cfg.block_size or SERVE_DEFAULT_BLOCK, bucket.n)
    if kind == "sketch":
        key = CacheKey(kind, batch, bucket.m, bucket.n, bucket.dtype, nb,
                       cfg.precision, cfg.trailing_precision, None,
                       cfg.refine, cfg.norm, "loop",
                       sketch=_sketch_triple(bucket.m, bucket.n))
        return key, bucket
    if kind == "qr":
        # refine/apply live in the solve stage: a factor-only program is
        # the same across them
        key = CacheKey(kind, batch, bucket.m, bucket.n, bucket.dtype, nb,
                       cfg.precision, cfg.trailing_precision, None, 0,
                       cfg.norm, cfg.panel_impl)
    else:
        key = CacheKey(kind, batch, bucket.m, bucket.n, bucket.dtype, nb,
                       cfg.precision, cfg.trailing_precision,
                       cfg.apply_precision, cfg.refine, cfg.norm,
                       cfg.panel_impl)
    return key, bucket


def cache_key_plan(key: CacheKey):
    """The :class:`~dhqr_tpu_torch.tune.Plan` a serve key carries — the
    inverse of the plan application in :func:`_resolve_bucket_plan`:
    serve plans carry only block_size / panel_impl / trailing_precision,
    so those three round-trip exactly (``serve.cache.canonical_key``
    spells the plan segment with its ``describe()``)."""
    from dhqr_tpu_torch.tune import Plan

    return Plan(engine="householder", block_size=key.block_size,
                panel_impl=key.panel_impl,
                trailing_precision=key.trailing_precision or None)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _key_program(key: CacheKey, device):
    """The eager program of ``key`` on ``device``: ``fn(A)`` (qr) or
    ``fn(A, b)`` over the key's stacked shapes."""
    if key.kind == "sketch":
        from dhqr_tpu_torch.solvers import sketch as _sketch

        s, seed, op = key.sketch
        return _sketch.batched_sketch_program(
            key.m, key.n, s, seed, op, key.block_size,
            precision=key.precision,
            trailing_precision=key.trailing_precision, norm=key.norm,
            refine=key.refine, dtype=_torch_dtype(key.dtype), device=device)
    if key.kind == "qr":
        return partial(_blocked._batched_qr_impl, block_size=key.block_size,
                       precision=key.precision, norm=key.norm,
                       panel_impl=key.panel_impl,
                       trailing_precision=key.trailing_precision)
    return partial(_batched_lstsq_impl, block_size=key.block_size,
                   precision=key.precision,
                   trailing_precision=key.trailing_precision,
                   apply_precision=key.apply_precision, refine=key.refine,
                   norm=key.norm, panel_impl=key.panel_impl)


def _lower_for_key(key: CacheKey, device) -> LoweredProgram:
    """The :class:`LoweredProgram` of a serve key (the cache owns the
    ``.compile()``): the program, its example inputs (the identity
    embedding of empty requests, finite through every program), and the
    eager rule."""
    dtype = _torch_dtype(key.dtype)

    def make_inputs():
        eye = torch.eye(key.m, key.n, dtype=dtype, device=device)
        A = eye.expand(key.batch, key.m, key.n).clone()
        if key.kind == "qr":
            return (A,)
        return A, torch.zeros((key.batch, key.m), dtype=dtype, device=device)

    eager = RECONSTRUCT_EAGER if key.panel_impl.startswith("reconstruct") \
        else None
    return LoweredProgram(_key_program(key, device), make_inputs, device,
                          eager_reason=eager)


def bucket_program(kind: str, config: Optional[DHQRConfig] = None,
                   **overrides):
    """The eager program a serve bucket dispatch runs, as a plain function
    of the stacked tensors (``fn(A)`` for "qr", ``fn(A, b)`` otherwise),
    on their device."""
    cfg, pol = _resolve_serve_cfg(config, overrides)
    if cfg.plan is not None:
        raise ValueError(
            "bucket_program takes resolved knobs (block_size=, ...): "
            "plan= is resolved per bucket by the serve entry points"
        )
    if pol is not None and pol.refine:
        cfg = dataclasses.replace(cfg, refine=pol.refine)

    def lstsq_fn(A, b):
        nb = min(cfg.block_size or SERVE_DEFAULT_BLOCK, A.shape[2])
        return _batched_lstsq_impl(
            A, b, nb, precision=cfg.precision,
            trailing_precision=cfg.trailing_precision,
            apply_precision=cfg.apply_precision, refine=cfg.refine,
            norm=cfg.norm, panel_impl=cfg.panel_impl)

    def qr_fn(A):
        nb = min(cfg.block_size or SERVE_DEFAULT_BLOCK, A.shape[2])
        return _blocked._batched_qr_impl(
            A, nb, precision=cfg.precision, norm=cfg.norm,
            panel_impl=cfg.panel_impl,
            trailing_precision=cfg.trailing_precision)

    if kind == "lstsq":
        return lstsq_fn
    if kind == "qr":
        return qr_fn
    if kind == "sketch":
        from dhqr_tpu_torch.solvers import sketch as _sketch

        skcfg = SketchConfig.from_env()

        def sketch_fn(A, b):
            _, m, n = A.shape
            s, seed, op = _sketch_triple(m, n)
            nb = min(cfg.block_size or SERVE_DEFAULT_BLOCK, n)
            prog = _sketch.batched_sketch_program(
                m, n, s, seed, op, nb, precision=cfg.precision,
                trailing_precision=cfg.trailing_precision, norm=cfg.norm,
                refine=skcfg.refine + cfg.refine, dtype=A.dtype,
                device=A.device)
            return prog(A, b)

        return sketch_fn
    raise ValueError(
        f"kind must be one of {SERVE_PROGRAM_KINDS}, got {kind!r}")


def _resolve_dispatch_cfg(kind: str, config: Optional[DHQRConfig],
                          overrides):
    """The ONE place serve resolution places the policy's refine for a
    program family (shared by the entry points and :func:`prewarm`).

    Returns ``(cfg, pol, qr_solve_args)``: for "lstsq" the policy's refine
    folds into ``cfg.refine`` (sweeps in the program); for "sketch" the
    total CGLS count is ``SketchConfig.refine`` plus the caller's; for
    "qr" an explicit ``refine=`` is refused and ``qr_solve_args = (apply
    precision, solve refine)`` is what each returned factorization
    records."""
    cfg, pol = _resolve_serve_cfg(config, overrides)
    if kind == "lstsq":
        if pol is not None and pol.refine:
            cfg = dataclasses.replace(cfg, refine=pol.refine)
        return cfg, pol, None
    if kind == "sketch":
        if cfg.panel_impl != "loop":
            raise ValueError(
                "panel_impl applies to the blocked householder kinds "
                f"(kind='sketch', panel_impl={cfg.panel_impl!r}: the "
                "sketch core's panel interior is fixed)"
            )
        extra = pol.refine if pol is not None else cfg.refine
        cfg = dataclasses.replace(
            cfg, refine=SketchConfig.from_env().refine + extra)
        return cfg, pol, None
    if kind != "qr":
        raise ValueError(
            f"kind must be one of {SERVE_PROGRAM_KINDS}, got {kind!r}")
    if cfg.refine:
        raise ValueError(
            "refine applies to batched_lstsq only — batched_qr returns raw "
            "factorizations; pass a policy= with refine > 0 to arm "
            "refinement on the factorizations' solves"
        )
    solve_refine = pol.refine if pol is not None else 0
    apply_prec = cfg.apply_precision or cfg.precision
    return cfg, pol, (apply_prec, solve_refine)


def _scatter_lstsq(As: Sequence, emit):
    """Input-order scatter for lstsq dispatches: each request's solution
    sliced out of the stacked output (a copy of the program's buffers),
    handed to ``emit(i, x_i)``."""

    def consume(chunk, key, xs):
        for row, i in enumerate(chunk):
            emit(i, xs[row, :As[i].shape[1]])

    return consume


def _scatter_qr(As: Sequence, emit, qr_solve_args, device):
    """Input-order scatter for factor-only dispatches: each stacked
    factorization truncated to its request's shape, wrapped in a
    ``QRFactorization`` armed with the resolved solve-stage fields."""
    from dhqr_tpu_torch.models.qr_model import QRFactorization

    apply_prec, solve_refine = qr_solve_args

    def consume(chunk, key, outs):
        Hs, alphas = outs
        for row, i in enumerate(chunk):
            m, n = As[i].shape
            emit(i, QRFactorization(
                Hs[row, :m, :n], alphas[row, :n],
                block_size=key.block_size, precision=apply_prec,
                refine=solve_refine,
                matrix=as_tensor(As[i], device) if solve_refine else None,
            ))

    return consume


def _validate_requests(As: Sequence, bs: "Sequence | None"):
    if bs is not None and len(As) != len(bs):
        raise ValueError(
            f"got {len(As)} matrices but {len(bs)} right-hand sides"
        )
    for t in list(As) + list(bs or ()):
        _blocked.refuse_batched_grad(t)
    for i, A in enumerate(As):
        shape = getattr(A, "shape", None)
        if shape is None or len(shape) != 2:
            raise ValueError(
                f"request {i}: expected a 2-D matrix, got shape {shape}"
            )
        m, n = shape
        if m < n or n < 1:
            raise ValueError(
                f"request {i}: the serving tier factors tall problems "
                f"(m >= n >= 1), got shape ({m}, {n})"
            )
        if bs is not None:
            b = bs[i]
            bshape = getattr(b, "shape", None)
            if bshape is None or tuple(bshape) != (m,):
                raise ValueError(
                    f"request {i}: b must be a length-m vector matching A "
                    f"(A is ({m}, {n}), b has shape {bshape}); block "
                    "right-hand sides are not batched yet — stack them as "
                    "separate requests"
                )
            if dtype_name(b.dtype) != dtype_name(A.dtype):
                # the stack takes A's dtype: a wider b would be downcast
                raise ValueError(
                    f"request {i}: b dtype {dtype_name(b.dtype)} does "
                    f"not match A dtype {dtype_name(A.dtype)}; cast "
                    "explicitly (the stacked dispatch runs entirely in A's "
                    "dtype)"
                )


def _group_by_bucket(As: Sequence, scfg: ServeConfig):
    """bucket -> list of request indices, insertion-ordered."""
    groups: "dict[Bucket, list[int]]" = {}
    for i, A in enumerate(As):
        m, n = A.shape
        groups.setdefault(plan_bucket(m, n, A.dtype, scfg), []).append(i)
    return groups


def _dispatch_groups(kind, As, bs, cfg, scfg, cache, consume, device,
                     trace_id=None, pol=None):
    """The one group -> chunk -> key -> compile -> pad -> dispatch loop of
    every entry point. ``consume(chunk, key, outs)`` gets each dispatched
    chunk's request indices, cache key and stacked outputs.

    The cache raises typed ``CompileFailed`` / ``Quarantined``; the launch
    here is wrapped into :class:`DispatchFailed`, with the ``serve.latency``
    / ``serve.dispatch`` fault sites at the launch. ``consume`` is outside
    the wrap. With ``cfg.guards`` armed, non-finite stacked outputs raise
    :class:`Breakdown` before the scatter (a check outside the program:
    same key, same program). ``pol`` (the resolved policy) keys the
    per-bucket plan resolution."""
    rec = _obs.active() if trace_id is not None else None
    for bucket, idxs in _group_by_bucket(As, scfg).items():
        cfg_b = _resolve_bucket_plan(kind, cfg, bucket, pol, device)
        for lo in range(0, len(idxs), scfg.max_batch):
            chunk = idxs[lo:lo + scfg.max_batch]
            key, _ = _plan_key(kind, len(chunk), bucket.m, bucket.n,
                               bucket.dtype, cfg_b, scfg)
            was_resident = rec is not None and key in cache
            compile0 = cache.timer.total("aot_compile") \
                if rec is not None and not was_resident else 0.0
            compiled = cache.get_or_compile(
                key, partial(_lower_for_key, key, device))
            if compiled.device != device:
                raise ValueError(
                    f"this cache holds {key!r} for {compiled.device}, not "
                    f"{device}: pass one cache per device")
            if rec is not None:
                compile_s = 0.0 if was_resident else max(
                    cache.timer.total("aot_compile") - compile0, 0.0)
                rec.event(trace_id, "dispatch", bucket=bucket.label,
                          batch=key.batch, requests=len(chunk),
                          compile_s=round(compile_s, 6))
            A_buf, b_buf = pad_group(
                [(As[i], None if bs is None else bs[i]) for i in chunk],
                bucket, key.batch, device)
            _faults.latency("serve.latency")
            try:
                _faults.fire("serve.dispatch")
                if _pulse.active() is None:
                    outs = (compiled(A_buf) if kind == "qr"
                            else compiled(A_buf, b_buf))
                else:
                    def launch(A_buf=A_buf, b_buf=b_buf):
                        # pulse runs the thunk twice, and an eager factor
                        # program works in place: each run takes a copy
                        if kind == "qr":
                            return compiled(A_buf.clone())
                        return compiled(A_buf, b_buf)

                    def pair(report, key=key):
                        if report.comms is not None:
                            xstore = _obs_xray.active()
                            if xstore is not None:
                                xstore.attach_comms(key, report.comms)
                    outs = _pulse.observed_dispatch(
                        "serve:" + ":".join(str(f) for f in key),
                        launch, contract_families=(), n_devices=1,
                        on_report=pair, device=device)
            except ServeError:
                raise
            except Exception as e:
                raise DispatchFailed(key, e) from e
            if cfg_b.guards is not None:
                bad = (_nguards.any_nonfinite(*outs) if kind == "qr"
                       else _nguards.any_nonfinite(outs))
                if bad:
                    raise Breakdown(
                        f"non-finite rows in the stacked {kind} dispatch "
                        f"for {key!r}: a request in this batch is "
                        "numerically poisoned (NaN input or breakdown); "
                        "bisect to isolate it",
                        engine=cfg_b.engine)
            consume(chunk, key, outs)


def _trace_sync_call(kind: str, n_requests: int):
    """Mint a call-scoped trace id for a sync batched entry point: ``(rec,
    trace_id)``, both None when tracing is disarmed."""
    rec = _obs.active()
    if rec is None:
        return None, None
    tid = rec.mint()
    rec.event(tid, "submit", kind=kind, sync=True, requests=n_requests)
    return rec, tid


@contextmanager
def _trace_sync_resolve(rec, tid):
    """Close a sync call's span path: "resolve ok", or a typed-outcome
    resolve, the error's trace id and the ``on_error`` hook."""
    if rec is None:
        yield
        return
    try:
        yield
    except Exception as e:
        rec.event(tid, "resolve", outcome=type(e).__name__,
                  error=str(e)[:200])
        rec.on_error(e, tid)
        raise
    rec.event(tid, "resolve", outcome="ok")


def _setup(kind, config, serve_config, cache, device, overrides):
    scfg = serve_config or ServeConfig.from_env()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cache = cache if cache is not None else default_cache(dev)
    cfg, pol, qr_args = _resolve_dispatch_cfg(kind, config, overrides)
    return scfg, dev, cache, cfg, pol, qr_args


def _batched_solve(kind, As, bs, config, serve_config, cache, device,
                   overrides) -> List[torch.Tensor]:
    scfg, dev, cache, cfg, pol, _ = _setup(kind, config, serve_config,
                                           cache, device, overrides)
    _validate_requests(As, bs)
    rec, tid = _trace_sync_call(kind, len(As))
    out: "list[torch.Tensor | None]" = [None] * len(As)
    consume = _scatter_lstsq(As, lambda i, x: out.__setitem__(i, x))
    with _trace_sync_resolve(rec, tid):
        _dispatch_groups(kind, As, bs, cfg, scfg, cache, consume, dev,
                         trace_id=tid, pol=pol)
    return out


def batched_lstsq(
    As: Sequence,
    bs: Sequence,
    config: Optional[DHQRConfig] = None,
    serve_config: Optional[ServeConfig] = None,
    cache: Optional[ExecutableCache] = None,
    device=None,
    **overrides,
) -> List[torch.Tensor]:
    """Least squares for a heterogeneous batch of requests.

    ``As``/``bs``: equal-length sequences of tall matrices (m_i, n_i) and
    vectors (m_i,), numpy arrays or tensors. Returns the solutions ``x_i``
    (n_i,) on ``device`` (None: the card), in input order — each what
    ``lstsq(As[i], bs[i])`` on the same engine settings returns, to
    roundoff, computed by one dispatch per shape bucket through the
    bucket-program cache. ``config``/``**overrides`` are the usual
    :class:`DHQRConfig` knobs (``policy=`` composes as on ``lstsq``);
    ``serve_config`` shapes the bucket lattice and batch cap; ``cache``
    overrides the device's default cache."""
    return _batched_solve("lstsq", As, bs, config, serve_config, cache,
                          device, overrides)


def batched_sketched_lstsq(
    As: Sequence,
    bs: Sequence,
    config: Optional[DHQRConfig] = None,
    serve_config: Optional[ServeConfig] = None,
    cache: Optional[ExecutableCache] = None,
    device=None,
    **overrides,
) -> List[torch.Tensor]:
    """Sketched least squares for a heterogeneous batch — the ``"sketch"``
    kind: the pipeline of :func:`batched_lstsq`, each bucket running
    :func:`dhqr_tpu_torch.solvers.sketch.batched_sketch_program`. The
    operator comes from ``DHQR_SKETCH_*`` per bucket and rides the cache
    key; ``policy=``'s refine adds CGLS iterations to the
    ``SketchConfig`` baseline; precision knobs steer the core's Gram
    product."""
    return _batched_solve("sketch", As, bs, config, serve_config, cache,
                          device, overrides)


def batched_qr(
    As: Sequence,
    config: Optional[DHQRConfig] = None,
    serve_config: Optional[ServeConfig] = None,
    cache: Optional[ExecutableCache] = None,
    device=None,
    **overrides,
) -> List:
    """Factor a heterogeneous batch: per-request ``QRFactorization``\\ s, in
    input order, each the packed factorization of its request to roundoff.
    Each bucket's program factors its stack in place (the JAX package
    donates the stack; here the stacked H is the stack's storage). A
    ``policy=`` with ``refine > 0`` arms refinement on each returned
    factorization's solves, as ``qr(A, policy=...)`` does."""
    scfg, dev, cache, cfg, pol, qr_solve_args = _setup(
        "qr", config, serve_config, cache, device, overrides)
    _validate_requests(As, None)
    rec, tid = _trace_sync_call("qr", len(As))
    out: "list | None" = [None] * len(As)
    consume = _scatter_qr(As, lambda i, f: out.__setitem__(i, f),
                          qr_solve_args, dev)
    with _trace_sync_resolve(rec, tid):
        _dispatch_groups("qr", As, None, cfg, scfg, cache, consume, dev,
                         trace_id=tid, pol=pol)
    return out


def prewarm(
    shapes: Sequence,
    kind: str = "lstsq",
    config: Optional[DHQRConfig] = None,
    serve_config: Optional[ServeConfig] = None,
    cache: Optional[ExecutableCache] = None,
    device=None,
    **overrides,
) -> List[CacheKey]:
    """Compile (capture, on the card) the programs a request mix needs,
    ahead of traffic.

    ``shapes``: ``(count, m, n)`` or ``(count, m, n, dtype)`` specs (dtype
    defaults to float32); ``count`` same-shape requests arriving in one
    batched call. The compiled key set is the union of each spec's own
    arrival (chunked past ``max_batch`` as live dispatch chunks) and, for
    specs sharing a bucket, their combined arrival, so a mix served as
    declared — specs separately or together — hits only prewarmed keys.
    Returns the deduplicated keys in compile order. ``plan="auto"``
    resolves once per bucket here (tuning on a DB miss: prewarm is where
    that cost belongs), through the resolver live dispatch uses."""
    scfg, dev, cache, cfg, pol, _ = _setup(kind, config, serve_config,
                                           cache, device, overrides)
    per_arrival: "list[tuple[Bucket, int]]" = []
    merged: "dict[Bucket, int]" = {}
    for spec in shapes:
        spec = tuple(spec)
        if len(spec) == 3:
            count, m, n = spec
            dtype = "float32"
        elif len(spec) == 4:
            count, m, n, dtype = spec
        else:
            raise ValueError(
                f"prewarm spec must be (count, m, n[, dtype]), got {spec!r}"
            )
        bucket = plan_bucket(int(m), int(n), dtype, scfg)
        per_arrival.append((bucket, int(count)))
        merged[bucket] = merged.get(bucket, 0) + int(count)
    keys: "list[CacheKey]" = []
    bucket_cfgs: "dict[Bucket, DHQRConfig]" = {}
    for bucket, count in per_arrival + list(merged.items()):
        if bucket not in bucket_cfgs:
            bucket_cfgs[bucket] = _resolve_bucket_plan(kind, cfg, bucket,
                                                       pol, dev)
        cfg_b = bucket_cfgs[bucket]
        for lo in range(0, count, scfg.max_batch):
            chunk_count = min(scfg.max_batch, count - lo)
            key, _ = _plan_key(kind, chunk_count, bucket.m, bucket.n,
                               bucket.dtype, cfg_b, scfg)
            if key not in keys:
                keys.append(key)
                cache.get_or_compile(key, partial(_lower_for_key, key, dev))
    return keys
