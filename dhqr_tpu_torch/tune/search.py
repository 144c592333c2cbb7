"""Measurement-driven execution-plan search — port of
``dhqr_tpu/tune/search.py``.

``tune()`` times a PRUNED candidate grid of :class:`Plan`\\ s for one
(kind, shape, dtype, mesh, policy) key on the device and records the
winner in the plan database; ``resolve_plan()`` is the lookup (+
tune-on-miss) the ``plan="auto"`` API paths call.

Pruning rules (the grid, in deterministic order — the JAX package's):

1. The static default ``Plan()`` is always candidate 0 — every tune
   measures the baseline it claims to beat, and the recorded entry
   carries the measured speedup.
2. nb ladder: powers of two from 8 to 256 with ``nb <= n``, on the
   blocked-householder engine (the single-problem kinds from 32, the
   serve kinds from 8).
3. Panel-interior variants (``recursive``, ``reconstruct``) only at
   ``n >= 64`` and only for ``nb >= 64``; ``reconstruct`` only for a
   real dtype.
4. ``trailing_precision="high"`` only on the card (``torch-cuda``: there
   the bf16 passes are cuBLAS GEMMs, so a split can cost less; on the CPU
   the plain version computes the same passes in f32 and a split is pure
   key noise) and only when the caller did NOT fix precision via a
   policy. The JAX package offers it on the TPU alone, for the same
   reason: the port's ``torch-cuda`` grid is the JAX ``tpu`` grid, its
   ``torch-cpu`` grid the JAX ``cpu`` grid.
5. Alt engines (``tsqr``, ``cholqr2``, ``sketch``) are lstsq-only,
   policy-free candidates, gated on aspect ratio: ``cholqr2`` at
   ``m/n >= 8``, ``tsqr`` at ``m/n >= 32``, ``sketch`` at ``m/n >=
   SketchConfig.min_aspect``. The serve kinds never route engines.
6. Mesh schedule levers only when the mesh has ``nproc > 1`` ranks; the
   depth-k pipelined broadcast rungs ride lookahead and are pruned when a
   pulse probe of the lookahead schedule measures an exposed comms floor
   of 0 (offered when no probe ran). The compressed-wire rungs (6b) and
   the two-tier ``dcn:*`` rungs (6c, pod meshes only) are lstsq-only and
   offered only when the caller did not pin precision via a policy.
7. The grid is truncated at ``TuneConfig.budget`` candidates from the
   END (defaults and the nb ladder first).

Every timed lstsq candidate is VERIFIED against the reference acceptance
rule — normal-equations residual within 8x the LAPACK oracle's, the
oracle solved once per tune on the host — and a failing candidate is
disqualified however fast it ran. qr candidates gate on the Gram proxy
``||A^H A - R^H R|| / ||A^H A||`` against the default plan's, computed in
float64 on the factors' device (the JAX package computes the same
quantity in float64 numpy on the host).

``use_pallas`` is deliberately NOT a plan axis: candidates run through
the public entry points under "auto", which on the card routes f32 and
c64 panels through the Hopper panel kernel whatever ``panel_impl`` says
(as the Pallas kernel does in the JAX package), so a ``recursive``
candidate there times the same program as its nb twin. The serve kinds
time the program serving runs: each candidate's bucket program is
compiled (captured as a CUDA graph on the card) once, and the replays are
timed. The tuner never flips the TF32 switches and times from the
caller's thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List

from dhqr_tpu_torch.tune.db import (
    PlanDB,
    default_db,
    plan_key,
    platform_of,
    policy_tag,
)
from dhqr_tpu_torch.tune.plan import DEFAULT_PLAN, Plan
from dhqr_tpu_torch.tune.registry import (
    GRID_ALT_DCN,
    GRID_ALT_ENGINES,
    GRID_ALT_WIRE,
    GRID_DCN_PLANS,
    GRID_MESH_LEVERS,
    GRID_OVERLAP_PLANS,
    GRID_WIRE_PLANS,
    TUNE_KINDS,
)
from dhqr_tpu_torch.utils.device import dtype_name

#: Gate failures on one plan key before ``resolve_plan`` demotes the
#: stored plan (falls back to the static default instead of replaying
#: it): one failure can be one adversarial matrix; a plan whose route
#: keeps breaking down is mis-tuned for the traffic.
PLAN_DEMOTE_AFTER = 3

# key -> numeric-gate failure count, reported by the numeric ladder
# (numeric.ladder._note_plan_failure) whenever rung 0 of a guarded call
# failed under an active plan. In memory only: a demotion is evidence
# about the live traffic, not a measurement to persist.
_GATE_FAILURES: "dict[str, int]" = {}
_GATE_LOCK = threading.Lock()
_DEMOTED_LOOKUPS = [0]
# resolve_plan lookups answered with a comms-stripped plan because the
# armor seam demoted the key's compressed wire.
_WIRE_DEMOTED_LOOKUPS = [0]


def _nproc(mesh) -> int:
    import numpy as np

    return int(np.prod(list(mesh.shape.values())))


def note_gate_failure(kind: str, m: int, n: int, dtype="float32", *,
                      nproc: int = 1, policy=None, device=None) -> int:
    """Record one numeric-gate failure against the plan key for this
    (kind, shape, dtype, nproc, policy) on ``device``'s platform; returns
    the running count. After :data:`PLAN_DEMOTE_AFTER` failures,
    ``resolve_plan`` stops replaying the stored plan for the key."""
    from dhqr_tpu_torch.precision import resolve_policy

    pol = resolve_policy(policy) if policy is not None else None
    key = plan_key(kind, m, n, dtype, nproc=nproc,
                   policy_tag=policy_tag(pol), device=device)
    with _GATE_LOCK:
        _GATE_FAILURES[key] = _GATE_FAILURES.get(key, 0) + 1
        return _GATE_FAILURES[key]


def plan_gate_stats() -> dict:
    """JSON-ready snapshot of the numeric-gate / demotion state: per-key
    failure counts, the threshold, and how many ``resolve_plan`` lookups
    a demotion answered."""
    with _GATE_LOCK:
        return {
            "failures": dict(_GATE_FAILURES),
            "demote_after": PLAN_DEMOTE_AFTER,
            "demoted_lookups": _DEMOTED_LOOKUPS[0],
            "wire_demoted_lookups": _WIRE_DEMOTED_LOOKUPS[0],
        }


def adopt_gate_failures(failures: "dict[str, int]") -> None:
    """Inherit another replica's numeric-gate failure counts, merged by
    MAX per plan key (a count is monotone evidence: adopting can raise
    this process's count, never forget a local strike)."""
    with _GATE_LOCK:
        for key, count in failures.items():
            try:
                count = int(count)
            except (TypeError, ValueError):
                continue
            if count > _GATE_FAILURES.get(str(key), 0):
                _GATE_FAILURES[str(key)] = count


def reset_gate_failures() -> None:
    """Clear the demotion state (tests; or after re-tuning a key)."""
    with _GATE_LOCK:
        _GATE_FAILURES.clear()
        _DEMOTED_LOOKUPS[0] = 0
        _WIRE_DEMOTED_LOOKUPS[0] = 0


def _demoted(key: str) -> bool:
    with _GATE_LOCK:
        if _GATE_FAILURES.get(key, 0) >= PLAN_DEMOTE_AFTER:
            _DEMOTED_LOOKUPS[0] += 1
            return True
        return False


#: Batch the serve kinds are timed at: the batch axis reshapes every
#: candidate's GEMMs alike, so one nominal batch ranks them.
TUNE_SERVE_BATCH = 8

_NB_LADDER = (8, 16, 32, 64, 128, 256)

#: Aspect-ratio gates of the alt-engine candidates (rule 5).
CHOLQR_MIN_ASPECT = 8
TSQR_MIN_ASPECT = 32


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One timed candidate (``seconds=None`` -> disqualified)."""

    plan: Plan
    seconds: "float | None"
    residual: "float | None" = None
    reason: "str | None" = None


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one ``tune()`` call."""

    key: str
    plan: Plan
    seconds: float
    baseline_seconds: float
    measurements: "tuple[Measurement, ...]"

    @property
    def speedup(self) -> float:
        """Measured default-plan time / winner time (>= 1 by
        construction: the default is always a candidate)."""
        return self.baseline_seconds / self.seconds


def _is_real(dtype) -> bool:
    return not dtype_name(dtype).startswith("complex")


def _mesh_topology(mesh) -> "tuple[int, int] | None":
    """``(dcn_size, ici_size)`` of a two-tier pod mesh (axis names exactly
    ``("dcn", "ici")``), else None. Attribute reads only."""
    names = tuple(getattr(mesh, "axis_names", ()) or ())
    if names == ("dcn", "ici"):
        return (int(mesh.shape["dcn"]), int(mesh.shape["ici"]))
    return None


def candidate_plans(kind: str, m: int, n: int, dtype="float32",
                    nproc: int = 1, policy=None,
                    platform: "str | None" = None,
                    budget: "int | None" = None,
                    topology: "tuple[int, int] | None" = None,
                    exposed_floor_s: "float | None" = None,
                    device=None) -> List[Plan]:
    """The pruned, deterministically ordered candidate grid (module
    docstring rules 1-7). Pure: no timing, no device access. ``platform``
    None is :func:`~dhqr_tpu_torch.tune.db.platform_of` ``(device)``.
    ``topology`` (a pod mesh's ``(dcn_size, ici_size)``) arms the
    ``dcn:*`` rungs; ``exposed_floor_s`` (the pulse-measured exposed
    collective floor of the lookahead schedule) prunes the deeper
    ``overlap_depth`` rungs at 0.0 and keeps them at None."""
    if kind not in TUNE_KINDS:
        raise ValueError(f"kind must be one of {TUNE_KINDS}, got {kind!r}")
    if n < 1 or m < n:
        raise ValueError(
            f"tuning covers tall problems (m >= n >= 1), got ({m}, {n})"
        )
    if platform is None:
        platform = platform_of(device)
    if budget is None:
        from dhqr_tpu_torch.utils.config import TuneConfig

        budget = TuneConfig.from_env().budget
    if kind == "serve_sketch":
        # The sketched bucket program has no panel loop: one candidate,
        # so plan="auto" on the sketch kind records a measured baseline.
        return [DEFAULT_PLAN]
    out: List[Plan] = [DEFAULT_PLAN]
    serve = kind.startswith("serve_")
    # Rule 2 — nb ladder.
    ladder = [v for v in _NB_LADDER if v <= n and (serve or v >= 32)]
    out.extend(Plan(block_size=v) for v in ladder)
    # Rule 3 — panel-interior variants at GEMM-sized widths.
    if not serve and n >= 64:
        impls = ["recursive"]
        if _is_real(dtype):
            impls.append("reconstruct")
        for impl in impls:
            out.extend(Plan(block_size=v, panel_impl=impl)
                       for v in ladder if v >= 64)
    # Rule 4 — trailing split, on the card only, never under a policy.
    if not serve and platform == "torch-cuda" and policy is None:
        out.extend(Plan(block_size=v, trailing_precision="high")
                   for v in ladder if v >= 64)
    # Rule 5 — alt engines, lstsq-only, policy-free, aspect-gated.
    if kind == "lstsq" and policy is None:
        aspect = m / n
        from dhqr_tpu_torch.utils.config import SketchConfig

        min_aspect = {"cholqr2": CHOLQR_MIN_ASPECT,
                      "tsqr": TSQR_MIN_ASPECT,
                      "sketch": SketchConfig.from_env().min_aspect}
        for engine in GRID_ALT_ENGINES:
            if aspect >= min_aspect[engine]:
                out.append(Plan(engine=engine))
    # Rule 6 — mesh schedule levers.
    if not serve and nproc > 1:
        base_nb = ladder[-1] if ladder else None
        out.extend(Plan(block_size=base_nb, **lever)
                   for lever in GRID_MESH_LEVERS)
        # Rule 6d — deeper broadcast rings, measurement-pruned.
        if exposed_floor_s is None or exposed_floor_s > 0.0:
            out.extend(Plan(block_size=base_nb, **lever)
                       for lever in GRID_OVERLAP_PLANS)
        # Rule 6b — compressed collectives, lstsq-only, policy-free.
        if policy is None and kind == "lstsq":
            out.extend(Plan(block_size=base_nb, **wire)
                       for wire in GRID_WIRE_PLANS)
            aspect = m / n
            alt_gate = {"cholqr2": CHOLQR_MIN_ASPECT,
                        "tsqr": TSQR_MIN_ASPECT}
            out.extend(Plan(engine=engine, comms=comms)
                       for engine, comms in GRID_ALT_WIRE
                       if aspect >= alt_gate[engine])
            # Rule 6c — topology-tiered rungs on a two-tier mesh.
            if topology is not None and topology[0] > 1:
                out.extend(Plan(block_size=base_nb, **dcn)
                           for dcn in GRID_DCN_PLANS)
                out.extend(Plan(engine=engine, comms=comms)
                           for engine, comms in GRID_ALT_DCN
                           if aspect >= alt_gate[engine])
    # Dedupe preserving order, then rule 7 — truncation from the end.
    seen = set()
    unique = []
    for p in out:
        if p not in seen:
            seen.add(p)
            unique.append(p)
    return unique[:max(1, int(budget))]


def apply_plan_to_config(cfg, plan: Plan):
    """Fold a plan's knobs into a :class:`DHQRConfig` (``plan`` cleared).
    A ``trailing_precision`` (or ``comms``) the config already carries (a
    resolved policy) wins over the plan's."""
    trailing = (cfg.trailing_precision
                if cfg.trailing_precision is not None
                else plan.trailing_precision)
    comms = cfg.comms if cfg.comms is not None else plan.comms
    return dataclasses.replace(
        cfg, engine=plan.engine, block_size=plan.block_size,
        panel_impl=plan.panel_impl, trailing_precision=trailing,
        lookahead=plan.lookahead, agg_panels=plan.agg_panels,
        overlap_depth=plan.overlap_depth, comms=comms, plan=None,
    )


def _serve_runner(kind: str, plan: Plan, policy, device) -> Callable:
    """The bucket program serving runs for ``plan``: the candidate's key
    (``serve.engine._plan_key`` over a config with the plan applied, at
    the timed stack's own shape) compiled once, on the first call — a
    CUDA graph on the card, replayed per call."""
    from dhqr_tpu_torch.serve import engine as _engine
    from dhqr_tpu_torch.utils.config import DHQRConfig, ServeConfig

    program = kind[len("serve_"):]
    cfg, _, _ = _engine._resolve_dispatch_cfg(
        program, DHQRConfig(policy=policy), {})
    cfg = apply_plan_to_config(cfg, plan)
    compiled: list = []

    def runner(A, b=None):
        if not compiled:
            B, m, n = A.shape
            key, _ = _engine._plan_key(program, B, m, n, A.dtype, cfg,
                                       ServeConfig.from_env())
            key = key._replace(batch=B, m=m, n=n)
            compiled.append(_engine._lower_for_key(key, device).compile())
        prog = compiled[0]
        if program == "qr":
            # an eager factor program works in place; a replay copies in
            return prog(A if prog.graph is not None else A.clone())
        return prog(A, b)

    return runner


def _build_runner(kind: str, plan: Plan, policy, mesh,
                  device=None) -> Callable:
    """A ``runner(*tensors) -> outputs`` executing ``kind`` under ``plan``
    through the same code the public API dispatches."""
    from dhqr_tpu_torch.utils.config import DHQRConfig

    if kind in ("qr", "lstsq"):
        from dhqr_tpu_torch.models import qr_model

        cfg = apply_plan_to_config(DHQRConfig(policy=policy), plan)
        if kind == "qr":
            def runner(A):
                fact = qr_model.qr(A, config=cfg, mesh=mesh, device=device)
                return (fact.natural_H(), fact.alpha)
        else:
            def runner(A, b):
                return qr_model.lstsq(A, b, config=cfg, mesh=mesh,
                                      device=device)
        return runner
    return _serve_runner(kind, plan, policy, device)


def _problem(kind: str, m: int, n: int, dtype, seed: int, device=None):
    """Deterministic tune inputs for ``kind`` at (m, n) on ``device``
    (drawn with numpy, as the JAX package's)."""
    import numpy as np
    import torch

    from dhqr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    np_dtype = np.dtype(dtype_name(dtype))

    def draw(shape):
        a = rng.standard_normal(shape)
        if not _is_real(dtype):
            a = a + 1j * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np_dtype)).to(dev)

    if kind == "qr":
        return (draw((m, n)),)
    if kind == "lstsq":
        return draw((m, n)), draw((m,))
    if kind == "serve_qr":
        return (draw((TUNE_SERVE_BATCH, m, n)),)
    return draw((TUNE_SERVE_BATCH, m, n)), draw((TUNE_SERVE_BATCH, m))


def _analytic_flops(kind: str, m: int, n: int) -> "float | None":
    """Closed-form useful-work flops of one timed call of ``kind``
    (:mod:`dhqr_tpu_torch.obs.flops`; the serve kinds time a
    TUNE_SERVE_BATCH stacked dispatch)."""
    from dhqr_tpu_torch.obs import flops as _oflops

    if kind == "qr":
        return _oflops.qr_flops(m, n)
    if kind == "lstsq":
        return _oflops.lstsq_flops(m, n)
    if kind == "serve_qr":
        return _oflops.batched_qr_flops(TUNE_SERVE_BATCH, m, n)
    if kind == "serve_lstsq":
        return _oflops.batched_lstsq_flops(TUNE_SERVE_BATCH, m, n)
    if kind == "serve_sketch":
        from dhqr_tpu_torch.solvers.sketch import sketch_dim
        from dhqr_tpu_torch.utils.config import SketchConfig

        skcfg = SketchConfig.from_env()
        return TUNE_SERVE_BATCH * _oflops.sketched_lstsq_flops(
            m, n, sketch_dim(m, n, factor=skcfg.factor),
            refine=skcfg.refine)
    return None


def _measure_wall(plan: Plan, runner: Callable, args, repeats: int) -> float:
    """Min wall seconds over ``repeats`` timed calls after the warm-up,
    each fenced with a CUDA synchronize on the card
    (:func:`~dhqr_tpu_torch.utils.profiling.sync`). ``plan`` rides along
    for signature parity with injected stubs."""
    from dhqr_tpu_torch.utils.profiling import sync

    sync(runner(*args))  # build + warm
    best = float("inf")
    for _ in range(max(1, repeats)):
        # dhqr: ignore[DHQR008] the tuner MEASURES real wall seconds per candidate — tests inject `timing=` a level up instead
        t0 = time.perf_counter()
        sync(runner(*args))
        # dhqr: ignore[DHQR008] same measurement, closing read
        best = min(best, time.perf_counter() - t0)
    return best


class _Oracle:
    """What the accuracy gate compares candidates with, computed once per
    tune: for lstsq kinds the host ``(A^H A, A^H b)`` of each problem
    (row) and the LAPACK oracle's normal-equations residual
    (:func:`~dhqr_tpu_torch.utils.testing.oracle_residual`), so that a
    candidate's residual is ``||A^H A x - A^H b||`` evaluated as
    :func:`~dhqr_tpu_torch.utils.testing.normal_equations_residual`
    does; for qr kinds ``A^H A`` in float64 on the device."""

    def __init__(self, kind: str, args):
        import numpy as np
        import torch

        from dhqr_tpu_torch.utils.testing import oracle_residual

        self.kind = kind
        if kind in ("lstsq", "serve_lstsq", "serve_sketch"):
            As, bs = args
            if kind == "lstsq":
                As, bs = As[None], bs[None]
            self.rows = []
            for A, b in zip(As.cpu().numpy(), bs.cpu().numpy()):
                Ah = A.conj().T
                # dhqr: ignore[DHQR002] host-side numpy oracle, no policy product
                self.rows.append((Ah @ A, Ah @ b, oracle_residual(A, b)))
            return
        A = args[0] if kind == "qr" else args[0][0]
        wide = torch.complex128 if A.is_complex() else torch.float64
        A64 = A.to(wide)
        self.gram_a = A64.mH @ A64  # dhqr: ignore[DHQR002] f64 check, no policy product
        self.m = max(A.shape)
        self.eps = float(torch.finfo(A.dtype).eps)


def _verify(kind: str, out, args, baseline_err: "float | None",
            oracle: "_Oracle | None" = None):
    """(ok, err) accuracy gate of one candidate's warm-up output.

    lstsq kinds: normal-equations residual within 8x the LAPACK oracle's
    (per batch row for serve). qr kinds: the Gram proxy within 8x the
    default plan's own (``baseline_err``; the default itself gates on an
    absolute bar). ``oracle`` (the tune's :class:`_Oracle` of ``args``)
    is built here when not passed."""
    import numpy as np
    import torch

    from dhqr_tpu_torch.utils.testing import TOLERANCE_FACTOR

    if oracle is None:
        oracle = _Oracle(kind, args)
    if kind in ("lstsq", "serve_lstsq", "serve_sketch"):
        xs = out[None] if kind == "lstsq" else out
        worst = 0.0
        for (gram, rhs, ref), x in zip(oracle.rows, xs):
            x = x.cpu().numpy()
            if not np.all(np.isfinite(x)):
                return False, float("inf")
            # dhqr: ignore[DHQR002] host-side numpy oracle, no policy product
            res = float(np.linalg.norm(gram @ x - rhs))
            ratio = res / ref if ref > 0 else float(res > 0)
            worst = max(worst, ratio)
            if res > TOLERANCE_FACTOR * ref:
                return False, worst
        return True, worst
    H, alpha = out
    if H.ndim == 3:  # serve_qr: gate on the first stacked problem
        H, alpha = H[0], alpha[0]
    if not bool(torch.isfinite(torch.view_as_real(H) if H.is_complex()
                               else H).all()) \
            or not bool(torch.isfinite(torch.view_as_real(alpha)
                                       if alpha.is_complex()
                                       else alpha).all()):
        return False, float("inf")
    n = H.shape[1]
    wide = oracle.gram_a.dtype
    R = (torch.triu(H[:n, :n], 1) + torch.diag(alpha)).to(wide)
    # ||A^H A - R^H R|| / ||A^H A||: Q's orthogonality makes the two Gram
    # matrices equal, so a broken or precision-degraded R shows here.
    # dhqr: ignore[DHQR002] f64 check, no policy product
    gram_err = float(torch.linalg.norm(oracle.gram_a - R.mH @ R)
                     / max(float(torch.linalg.norm(oracle.gram_a)), 1e-30))
    if baseline_err is None:
        bar = 8.0 * oracle.m * oracle.eps
        return gram_err <= max(bar, 1e-6), gram_err
    return gram_err <= max(8.0 * baseline_err, 1e-5), gram_err


def _from_rank0(values, mesh) -> list:
    """Rank 0's ``values`` (floats or None) on every rank of ``mesh``:
    one float64 broadcast through the wire seam (None travels as NaN)."""
    import math

    import torch

    from dhqr_tpu_torch.parallel import wire

    t = torch.tensor([math.nan if v is None else float(v) for v in values],
                     dtype=torch.float64, device=mesh.device)
    t = wire.wire_broadcast(t, 0, mesh)
    return [None if math.isnan(v) else v for v in t.tolist()]


def _probe_overlap_headroom(kind: str, m: int, n: int, dtype, mesh,
                            nproc: int, policy, seed: int) -> "dict | None":
    """Pulse-probe the one-panel lookahead schedule at this key and
    return its measured comms roofline (``obs.netmodel.comms_roofline``
    fields — ``overlap_headroom_s``, ``exposed_floor_s``,
    ``comms_fraction``), or None when the measurement degrades."""
    from dhqr_tpu_torch.obs import pulse as _pulse

    try:
        runner = _build_runner(kind, Plan(lookahead=True), policy, mesh)
        args = _problem(kind, m, n, dtype, seed, mesh.device)
        _, report = _pulse.measure(
            f"tune_probe[{kind},{m}x{n},P={nproc}]",
            lambda: runner(*args), mesh=mesh, n_devices=nproc)
    except Exception:  # advisory: an unmeasurable backend keeps the grid
        return None
    comms = report.comms
    if not comms or comms.get("comms_bound") is None:
        return None
    return comms


def tune(kind: str, m: int, n: int, dtype="float32", *,
         mesh=None, policy=None, db: "PlanDB | None" = None,
         budget: "int | None" = None, repeats: "int | None" = None,
         measure: "Callable | None" = None, seed: int = 0,
         save: bool = True, device=None) -> TuneResult:
    """Time the candidate grid for one key; record + persist the winner.

    ``measure(plan, runner, args, repeats) -> seconds`` is injectable (a
    stub skips the accuracy gate, which needs real outputs, and the
    device: it is handed ``args=None``). ``save=False`` records in memory
    only. ``device`` (None: the card; a mesh's own device with ``mesh=``)
    is where the candidates run and the key's platform."""
    from dhqr_tpu_torch.precision import resolve_policy
    from dhqr_tpu_torch.utils.config import TuneConfig

    tcfg = TuneConfig.from_env()
    budget = tcfg.budget if budget is None else budget
    repeats = tcfg.repeats if repeats is None else repeats
    pol = resolve_policy(policy) if policy is not None else None
    nproc = 1
    topology = None
    if mesh is not None:
        nproc = _nproc(mesh)
        topology = _mesh_topology(mesh)
        device = mesh.device
    platform = platform_of(device)
    key = plan_key(kind, m, n, dtype, nproc=nproc,
                   policy_tag=policy_tag(pol), platform=platform)
    stubbed = measure is not None
    headroom = None
    if not stubbed and mesh is not None and nproc > 1 \
            and kind in ("qr", "lstsq"):
        headroom = _probe_overlap_headroom(kind, m, n, dtype, mesh,
                                           nproc, policy, seed)
        fields = ("overlap_headroom_s", "exposed_floor_s", "comms_fraction")
        agreed = _from_rank0([None if headroom is None else
                              headroom.get(f) for f in fields], mesh)
        headroom = None if agreed[1] is None else dict(zip(fields, agreed))
    candidates = candidate_plans(
        kind, m, n, dtype, nproc=nproc, policy=pol, platform=platform,
        budget=budget, topology=topology,
        exposed_floor_s=(headroom.get("exposed_floor_s")
                         if headroom is not None else None))
    timer = measure or _measure_wall
    args = oracle = None
    if not stubbed:
        args = _problem(kind, m, n, dtype, seed, device)
        oracle = _Oracle(kind, args)
    rows: "list[Measurement]" = []
    baseline_err = None
    baseline_seconds = None
    for plan in candidates:
        runner = _build_runner(kind, plan, policy, mesh, device)
        try:
            if not stubbed:
                out = runner(*args)
                ok, err = _verify(kind, out, args, baseline_err, oracle)
                del out
                if plan == DEFAULT_PLAN and kind in ("qr", "serve_qr"):
                    baseline_err = err
                if not ok:
                    rows.append(Measurement(plan, None, residual=err,
                                            reason="accuracy"))
                    continue
            else:
                err = None
            seconds = timer(plan, runner, args, repeats)
            rows.append(Measurement(plan, float(seconds), residual=err))
        except Exception as e:  # a candidate that cannot run is skipped,
            rows.append(Measurement(  # never fatal to the search
                plan, None, reason=f"{type(e).__name__}: {e}"))
        if plan == DEFAULT_PLAN and rows and rows[-1].seconds is not None:
            baseline_seconds = rows[-1].seconds
    if mesh is not None and not stubbed:
        # every rank timed the candidates; rank 0's clock decides, so that
        # every rank records (and later dispatches) the same winner
        agreed = _from_rank0([r.seconds for r in rows], mesh)
        rows = [dataclasses.replace(r, seconds=t) for r, t in
                zip(rows, agreed)]
        baseline_seconds = next((r.seconds for r in rows
                                 if r.plan == DEFAULT_PLAN), None)
    timed = [r for r in rows if r.seconds is not None]
    if not timed:
        raise RuntimeError(
            f"tune({key}): no candidate survived "
            f"({[(r.plan.describe(), r.reason) for r in rows]})"
        )
    if baseline_seconds is None:
        # The default failed to time: anchor the speedup at the winner.
        baseline_seconds = min(r.seconds for r in timed)
    winner = min(timed, key=lambda r: (r.seconds, candidates.index(r.plan)))
    if db is None:
        db = default_db()
    extra = {}
    if not stubbed:
        # Measured entries carry their analytic throughput (useful-work
        # flops over the winner's seconds); stubbed searches would mint
        # fake GF/s.
        analytic = _analytic_flops(kind, m, n)
        if analytic and winner.seconds > 0:
            extra["analytic_flops"] = analytic
            extra["gflops"] = round(analytic / winner.seconds / 1e9, 2)
    if headroom is not None:
        for field in ("overlap_headroom_s", "exposed_floor_s",
                      "comms_fraction"):
            if headroom.get(field) is not None:
                extra[field] = headroom[field]
    db.record(
        key, winner.plan,
        seconds=round(winner.seconds, 6),
        baseline_seconds=round(baseline_seconds, 6),
        speedup=round(baseline_seconds / winner.seconds, 4),
        candidates=len(candidates),
        source="stub" if stubbed else "measured",
        **extra,
    )
    if save and db.path:
        db.save()
    return TuneResult(key=key, plan=winner.plan, seconds=winner.seconds,
                      baseline_seconds=baseline_seconds,
                      measurements=tuple(rows))


def resolve_plan(kind: str, m: int, n: int, dtype="float32", *,
                 nproc: int = 1, mesh=None, policy=None,
                 db: "PlanDB | None" = None,
                 on_miss: "str | None" = None, device=None,
                 **tune_kwargs) -> "Plan | None":
    """The ``plan="auto"`` resolution: DB hit -> stored plan; miss -> tune
    now (``on_miss="tune"``) or None (``on_miss="default"``: the caller
    keeps its static knobs). ``nproc`` and the device come from ``mesh``
    when one is passed.

    A key with :data:`PLAN_DEMOTE_AFTER` or more recorded numeric-gate
    failures (:func:`note_gate_failure`) is DEMOTED: the lookup returns
    None without consulting or re-tuning the DB. A stored COMPRESSED plan
    whose key keeps tripping the armor seam
    (:func:`dhqr_tpu_torch.armor.wire_demoted`) comes back with ``comms``
    stripped. ``reset_gate_failures()`` / ``armor.reset_wire_trips()``
    (or a restart) re-admit them."""
    from dhqr_tpu_torch.precision import resolve_policy
    from dhqr_tpu_torch.utils.config import TuneConfig

    pol = resolve_policy(policy) if policy is not None else None
    if mesh is not None:
        nproc = _nproc(mesh)
        device = mesh.device
    if db is None:
        db = default_db()
    key = plan_key(kind, m, n, dtype, nproc=nproc,
                   policy_tag=policy_tag(pol), device=device)
    if _demoted(key):
        return None
    hit = db.get(key)
    if hit is not None:
        if hit.comms:
            from dhqr_tpu_torch import armor as _armor

            if _armor.wire_demoted(kind, m, n, dtype, nproc):
                with _GATE_LOCK:
                    _WIRE_DEMOTED_LOOKUPS[0] += 1
                return dataclasses.replace(hit, comms=None)
        return hit
    if on_miss is None:
        on_miss = TuneConfig.from_env().on_miss
    if on_miss == "default":
        return None
    return tune(kind, m, n, dtype, mesh=mesh, policy=policy, db=db,
                device=device, **tune_kwargs).plan
