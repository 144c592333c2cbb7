"""Condition-aware fallback ladder: breakdown detection and typed
escalation — port of ``dhqr_tpu/numeric/ladder.py``.

* :func:`guarded_lstsq` / :func:`guarded_qr` screen the input
  (:mod:`~dhqr_tpu_torch.numeric.guards`: non-finite scan, zero-column
  detection), run the requested engine, health-check the output, and on a
  detected breakdown ESCALATE down a fixed engine ladder::

      cholqr2 -> cholqr3 (shifted, +1 pass) -> tsqr -> householder

  followed by POLICY escalation on the stable engine (``fast`` ->
  ``accurate`` -> ``accurate`` + one more refinement sweep). Every rung is
  recorded (:class:`Attempt`) and the taken path rides on the returned
  :class:`GuardedResult`.
* Exhausting the ladder raises TYPED
  (:mod:`dhqr_tpu_torch.numeric.errors`): ``Breakdown`` when factors went
  non-finite, ``IllConditioned`` when the cheap condition lower bound
  implicates conditioning (or the input is structurally singular),
  ``ResidualGateFailed`` when every rung returned finite-but-wrong
  (``guards="full"`` only: the probe is one host LAPACK solve).

Rung 0 is the caller's resolved route verbatim, so an unguarded call and a
guarded one that answers on rung 0 run the same engine, the same panels on
the Hopper kernel and the same launches; the guards add a few reductions
and host reads. Fallback rungs deliberately do NOT inherit a policy's
trailing-GEMM or apply split: Gram rounding is squared through Cholesky
(``ops/cholqr.py``), so a cheap product narrows the very conditioning
window the ladder is escaping. A fallback rung runs the policy's panel
precision with full-precision composition; refinement sweeps carry over
where the engine supports them (tsqr has none: its rung runs refine=0 and
leans on the residual gate).

The ladder absorbs NUMERICAL failures only: non-finite output, a shape or
knob an engine refuses (``ValueError``, except on rung 0, where it is the
caller's own error), the residual gate, and the armor errors. Anything
else a rung raises propagates: a kernel that fails to build or launch, or
a panel the kernel route refuses (``hopper_panel.KernelRefusal``, a
``ValueError`` of its own type), is a fault of the program or the card,
never a rung to escalate past.

Deterministic testing: the ``numeric.nan`` fault site fires at the input
screen (as if the scan had found a NaN) and ``numeric.breakdown`` fires per
rung (as if that rung's output came back non-finite), so every escalation
path replays without crafting a matrix for it. A rung-0 failure under an
active plan is reported to the tuner (:func:`_note_plan_failure`), so a
plan whose gate keeps failing is demoted out of ``plan="auto"``
resolution.
"""

from __future__ import annotations

import dataclasses

import torch

from dhqr_tpu_torch.armor.errors import ArmorError
from dhqr_tpu_torch.faults import harness as _faults
from dhqr_tpu_torch.numeric import guards as _guards
from dhqr_tpu_torch.ops.hopper_panel import KernelRefusal
from dhqr_tpu_torch.numeric.errors import (
    Breakdown,
    IllConditioned,
    NonFiniteInput,
    NumericalError,
    ResidualGateFailed,
)
from dhqr_tpu_torch.obs import trace as _obs
from dhqr_tpu_torch.utils.device import as_tensor
from dhqr_tpu_torch.utils.profiling import Counters

#: Process-wide guardrail accounting: ``guarded_calls`` (entries into a
#: guarded_* call), ``screen_rejects`` (typed refusals at the input
#: screen), ``fallbacks`` (ladder rungs that FAILED — breakdown,
#: inapplicable, residual gate, corruption — recovered or not; a
#: ``zero_pivot`` rung is not one, the call refuses instead), ``recovered``
#: (guarded calls that escalated and still answered), ``exhausted``
#: (post-screen typed refusals).
COUNTERS = Counters()

#: Escalation order per starting engine: strictly toward stability.
ENGINE_LADDER = {
    "cholqr2": ("cholqr3", "tsqr", "householder"),
    "cholqr3": ("tsqr", "householder"),
    "tsqr": ("householder",),
    "householder": (),
    # A sketched solve that breaks down (or fails the residual probe)
    # escalates straight to the stable direct engine.
    "sketch": ("householder",),
}

GUARD_MODES = ("screen", "fallback", "full")


@dataclasses.dataclass(frozen=True)
class Attempt:
    """One ladder rung's outcome.

    ``outcome`` is "ok", "breakdown" (non-finite output — organic, or
    injected when ``detail`` says so), "inapplicable" (the engine refused
    the problem's shape or knobs), "residual_gate" (finite but over the 8x
    criterion; ratio in ``residual_ratio``), "corruption" (a typed armor
    error: the rung's transport failed, so the ladder escalates as for a
    breakdown), or "zero_pivot" (``guarded_qr``: finite factors with an
    exactly-zero R diagonal entry). Anything else a rung raises propagates
    — the ladder absorbs numerical failures, not bugs."""

    engine: str
    policy: str
    outcome: str
    detail: "str | None" = None
    residual_ratio: "float | None" = None


@dataclasses.dataclass(frozen=True)
class GuardedResult:
    """A guarded call's value plus its provenance.

    ``value`` is what the unguarded API returns (``x`` for lstsq, a
    ``QRFactorization`` for qr); ``engine``/``policy`` name the rung that
    produced it; ``attempts`` is the full per-rung record (length 1 when
    nothing escalated); ``residual_ratio`` is the probe's measurement when
    ``guards="full"`` ran it; ``cond_estimate`` is the R-diagonal
    condition lower bound when the mode computed one (``guarded_qr``
    under ``"full"``); ``trace_id`` is the obs trace id of the call (None
    when tracing was disarmed)."""

    value: object
    engine: str
    policy: str
    attempts: "tuple[Attempt, ...]"
    residual_ratio: "float | None" = None
    cond_estimate: "float | None" = None
    trace_id: "int | None" = None

    @property
    def x(self):
        """The solution tensor (lstsq spelling of ``value``)."""
        return self.value

    @property
    def factorization(self):
        """The factorization (qr spelling of ``value``)."""
        return self.value

    @property
    def escalations(self) -> int:
        """How many rungs failed before the one that answered."""
        return len(self.attempts) - 1


def _trace_guarded(kind: str, engine: str, mode: str, shape):
    """Mint a call-scoped trace id and record its admission span. Returns
    ``(recorder, trace_id)``, None/None when tracing is disarmed (every
    helper below no-ops on recorder None)."""
    rec = _obs.active()
    if rec is None:
        return None, None
    tid = rec.mint()
    rec.event(tid, "submit", kind=kind, engine=engine, mode=mode,
              m=int(shape[0]), n=int(shape[1]))
    return rec, tid


def _trace_rung(rec, tid, att: Attempt) -> None:
    """One ladder rung as a span, recorded where the rung ran."""
    if rec is None:
        return
    attrs = {"engine": att.engine, "policy": att.policy,
             "outcome": att.outcome}
    if att.detail:
        attrs["detail"] = att.detail[:200]
    if att.residual_ratio is not None:
        attrs["residual_ratio"] = round(att.residual_ratio, 4)
    rec.event(tid, "rung", **attrs)


def _trace_refusal(rec, tid, exc: BaseException) -> None:
    """Close a guarded call's path with its typed refusal: the resolve
    span, the trace id on the error, and the on_error auto-dump hook."""
    if rec is None:
        return
    rec.event(tid, "resolve", outcome=type(exc).__name__,
              error=str(exc)[:200])
    rec.on_error(exc, tid)


def _attempt_recorder(attempts: list, rec, tid):
    """The one place a ladder rung is recorded: the summary (attempts),
    the accounting (``fallbacks``) and the rung span."""
    def _att(att: Attempt) -> None:
        attempts.append(att)
        if att.outcome in ("breakdown", "inapplicable", "residual_gate",
                           "corruption"):
            COUNTERS.bump("fallbacks")
        _trace_rung(rec, tid, att)
    return _att


def _refuse(rec, tid, err: BaseException) -> "BaseException":
    """The typed-refusal epilogue every dead end shares: count it, close
    the trace, hand the error back for ``raise``."""
    COUNTERS.bump("exhausted")
    _trace_refusal(rec, tid, err)
    return err


def _mode(cfg) -> str:
    mode = cfg.guards or "fallback"
    if mode not in GUARD_MODES:
        raise ValueError(
            f"guards must be one of {GUARD_MODES} or None, got {mode!r}"
        )
    return mode


def _policy_desc(pol, cfg) -> str:
    """Compact policy spelling for the records: ``policy_tag`` of the
    policy, the classic knobs folded into a PrecisionPolicy first."""
    from dhqr_tpu_torch.precision import PrecisionPolicy
    from dhqr_tpu_torch.tune.db import policy_tag

    if pol is None:
        pol = PrecisionPolicy(
            panel=cfg.precision, trailing=cfg.trailing_precision,
            apply=cfg.apply_precision, refine=cfg.refine)
    return policy_tag(pol)


def _screen(A, b, engine_hint: "str | None") -> None:
    """Input screening: typed raises, nothing else. The ``numeric.nan``
    fault site fires here — an injected trigger is treated exactly as a
    detected non-finite entry."""
    try:
        _faults.fire("numeric.nan")
    except _faults.FaultInjected as e:
        raise NonFiniteInput(
            "non-finite input detected (injected numeric.nan fault)",
            engine=engine_hint) from e
    bad_A, zero_col, bad_b = _guards.screen_input(A, b, device=A.device)
    if bad_A or bad_b:
        which = "A" if bad_A else "b"
        raise NonFiniteInput(
            f"input {which} carries non-finite entries; no engine can "
            "recover a poisoned input — clean or drop the request",
            engine=engine_hint)
    if zero_col:
        raise IllConditioned(
            "input has an exactly-zero column (structurally "
            "rank-deficient, cond = inf); regularize or drop the column",
            engine=engine_hint, cond_estimate=float("inf"))


def _resolve_start(A, cfg, mesh, device):
    """Mirror ``lstsq``'s own policy/plan resolution so that rung 0 runs
    the program the unguarded call would have run. Returns
    ``(cfg0, pol, plan_active)``: ``plan_active`` is True only when a
    stored or explicit plan actually landed on the config (a DB miss
    falling back to the static default never feeds plan demotion)."""
    from dhqr_tpu_torch.models import qr_model as _qm

    cfg, pol = _qm._resolve_policy_cfg(cfg)
    if pol is not None and pol.refine:
        cfg = dataclasses.replace(cfg, refine=pol.refine)
    applied: list = []
    cfg = _qm._resolve_plan_cfg(cfg, "lstsq", tuple(A.shape), A.dtype,
                                mesh, pol, device=device, applied=applied)
    return cfg, pol, bool(applied)


def _fallback_cfg(engine: str, pol, base, mesh):
    """Config for a FALLBACK rung: the stable engine's defaults plus the
    caller's accuracy-relevant knobs (panel precision, norm, refinement
    where the engine supports it). Trailing/apply splits are deliberately
    dropped (see the module docstring)."""
    from dhqr_tpu_torch.utils.config import DHQRConfig

    refine = pol.refine if pol is not None else base.refine
    if engine == "tsqr" or (mesh is not None
                            and engine in ("cholqr2", "cholqr3")):
        refine = 0  # unsupported there (tsqr tree; mesh cholqr)
    return DHQRConfig(
        engine=engine,
        precision=(pol.panel if pol is not None else base.precision),
        norm=base.norm, mesh_axis=base.mesh_axis, refine=refine,
    )


def _escalation_policies(pol, base):
    """The policy-escalation tail on the stable engine — ``fast ->
    accurate -> refine+1`` (:func:`dhqr_tpu_torch.precision.
    escalation_policies`)."""
    from dhqr_tpu_torch.precision import escalation_policies

    if pol is not None:
        return escalation_policies(pol)
    cheap = bool(base.trailing_precision or base.apply_precision
                 or base.precision != "highest")
    return escalation_policies(base_refine=base.refine, cheap=cheap)


def _note_plan_failure(A, mesh, pol) -> None:
    """Rung 0 failed under an active plan: report it to the tuner so that
    ``plan="auto"`` demotes a repeat offender (``tune/search.py``), keyed
    on the platform of the device A lives on."""
    from dhqr_tpu_torch.tune.search import _nproc, note_gate_failure

    nproc = _nproc(mesh) if mesh is not None else 1
    note_gate_failure("lstsq", A.shape[0], A.shape[1], A.dtype,
                      nproc=nproc, policy=pol, device=A.device)


def _classify_exhausted(A, attempts, probe_ran: bool):
    """Build the typed error once every rung has failed."""
    broken = [a for a in attempts if a.outcome == "breakdown"]
    gated = [a for a in attempts if a.outcome == "residual_gate"]
    first_engine = attempts[0].engine if attempts else None
    if broken:
        est = _guards.estimate_condition(
            A if A.shape[0] >= A.shape[1] else A.mH, device=A.device)
        window = None
        eng = broken[0].engine
        if eng in ("cholqr2", "cholqr3"):
            from dhqr_tpu_torch.ops.cholqr import cholqr_max_cond

            window = cholqr_max_cond(A.dtype, shift=eng == "cholqr3")
        if est is not None and window is not None and est > window:
            return IllConditioned(
                f"{eng} broke down and the condition lower bound "
                f"{est:.3e} exceeds its window (~{window:.1e}); "
                f"{len(attempts)} rung(s) tried without success",
                engine=first_engine, cond_estimate=est, attempts=attempts)
        return Breakdown(
            f"factorization broke down on every applicable rung "
            f"({len(attempts)} tried; condition lower bound "
            f"{'unavailable' if est is None else format(est, '.3e')})",
            engine=first_engine, cond_estimate=est, attempts=attempts)
    if gated and probe_ran:
        worst = max(a.residual_ratio for a in gated
                    if a.residual_ratio is not None)
        return ResidualGateFailed(
            f"every rung returned a finite solution above the "
            f"8x-LAPACK residual criterion (worst ratio {worst:.2f}x); "
            "refusing to return silent garbage",
            engine=first_engine,
            cond_estimate=_guards.estimate_condition(A, device=A.device),
            attempts=attempts, residual_ratio=worst)
    # Nothing ran at all (every rung inapplicable): a ladder bug surfacing
    # loudly rather than silently.
    return Breakdown(
        f"no ladder rung was applicable ({len(attempts)} recorded)",
        engine=first_engine, attempts=attempts)


def _inputs(A, b, mesh, device):
    """A (and b) as tensors on the call's device: ``mesh.device`` with a
    mesh, else ``device`` (None: the card)."""
    A = as_tensor(A, device if mesh is None else mesh.device)
    return A, (None if b is None else as_tensor(b, A.device))


def guarded_lstsq(A, b, config=None, mesh=None, device=None,
                  **overrides) -> GuardedResult:
    """Least squares with numeric guardrails: screen -> run -> health
    check -> escalate -> typed refusal.

    The guard mode comes from ``config.guards`` (or ``guards=`` in
    overrides): ``"screen"`` = input screening only, then the unguarded
    call; ``"fallback"`` (the default here) = screening + breakdown
    detection + the engine/policy ladder; ``"full"`` = fallback + the
    one-shot residual probe on every rung's output (one host LAPACK solve
    per call). ``lstsq(A, b, guards=...)`` routes here and returns ``.x``;
    call this for the provenance (:class:`GuardedResult`). ``device`` and
    ``mesh`` are :func:`~dhqr_tpu_torch.lstsq`'s.
    """
    from dhqr_tpu_torch.models import qr_model as _qm
    from dhqr_tpu_torch.utils.config import DHQRConfig
    from dhqr_tpu_torch.utils.testing import TOLERANCE_FACTOR

    cfg = dataclasses.replace(config or DHQRConfig(), **overrides)
    mode = _mode(cfg)
    cfg = dataclasses.replace(cfg, guards=None)
    A, b = _inputs(A, b, mesh, device)
    dev = A.device if mesh is None else None

    rec, tid = _trace_guarded("guarded_lstsq", cfg.engine, mode, A.shape)
    COUNTERS.bump("guarded_calls")
    try:
        _screen(A, b, cfg.engine)
    except NumericalError as e:
        COUNTERS.bump("screen_rejects")
        _trace_refusal(rec, tid, e)
        raise
    if rec is not None:
        rec.event(tid, "screen", outcome="ok")
    if mode == "screen":
        x = _qm.lstsq(A, b, config=cfg, mesh=mesh, device=dev)
        pol_desc = _policy_desc(None, cfg) if cfg.policy is None else \
            str(cfg.policy)
        att = Attempt(cfg.engine, pol_desc, "ok")
        _trace_rung(rec, tid, att)
        if rec is not None:
            rec.event(tid, "resolve", outcome="ok", engine=cfg.engine)
        return GuardedResult(x, cfg.engine, pol_desc, (att,),
                             trace_id=tid)

    cfg0, pol, plan_active = _resolve_start(A, cfg, mesh, A.device)
    probe = mode == "full"
    m, n = A.shape

    # Rung list: (engine, config, policy description). Rung 0 is the
    # caller's resolved route verbatim; the m < n minimum-norm path has
    # exactly one engine, so its ladder is policy escalation only.
    rungs: "list[tuple[str, object, str]]" = [
        (cfg0.engine, cfg0, _policy_desc(pol, cfg0))]
    if m >= n:
        for eng in ENGINE_LADDER.get(cfg0.engine, ()):
            fcfg = _fallback_cfg(eng, pol, cfg0, mesh)
            rungs.append((eng, fcfg, _policy_desc(None, fcfg)))
    from dhqr_tpu_torch.tune.db import policy_tag

    for esc in _escalation_policies(pol, cfg0):
        ecfg = dataclasses.replace(
            _fallback_cfg("householder", None, cfg0, mesh),
            precision=DHQRConfig.precision, refine=0, policy=esc)
        desc = policy_tag(esc)
        # Dedupe against EVERY queued rung: an identical config is never
        # factored twice.
        if all((eng, d) != ("householder", desc) for eng, _, d in rungs):
            rungs.append(("householder", ecfg, desc))

    attempts: "list[Attempt]" = []
    last_armor: "ArmorError | None" = None
    _att = _attempt_recorder(attempts, rec, tid)
    for i, (eng, rcfg, desc) in enumerate(rungs):
        try:
            _faults.fire("numeric.breakdown")
        except _faults.FaultInjected:
            _att(Attempt(eng, desc, "breakdown",
                         detail="injected numeric.breakdown"))
            if i == 0 and plan_active:
                _note_plan_failure(A, mesh, pol)
            continue
        try:
            x = _qm.lstsq(A, b, config=rcfg, mesh=mesh, device=dev)
        except KernelRefusal:
            raise  # the kernel route's fault, never an inapplicable rung
        except ValueError as e:
            if i == 0:
                raise  # the caller's own config error — never masked
            _att(Attempt(eng, desc, "inapplicable", detail=str(e)))
            continue
        except ArmorError as e:
            # The armor seam refused the rung's TRANSPORT; the next rung
            # dispatches a different program.
            last_armor = e
            _att(Attempt(eng, desc, "corruption", detail=str(e)[:200]))
            if i == 0 and plan_active:
                _note_plan_failure(A, mesh, pol)
            continue
        if _guards.any_nonfinite(x):
            _att(Attempt(eng, desc, "breakdown"))
            if i == 0 and plan_active:
                _note_plan_failure(A, mesh, pol)
            continue
        ratio = None
        if probe:
            ratio = _guards.residual_ratio(A, b, x)
            if ratio > TOLERANCE_FACTOR:
                _att(Attempt(eng, desc, "residual_gate",
                             residual_ratio=ratio))
                if i == 0 and plan_active:
                    _note_plan_failure(A, mesh, pol)
                continue
        _att(Attempt(eng, desc, "ok", residual_ratio=ratio))
        if len(attempts) > 1:
            COUNTERS.bump("recovered")
        if rec is not None:
            rec.event(tid, "resolve", outcome="ok", engine=eng,
                      escalations=len(attempts) - 1)
        return GuardedResult(x, eng, desc, tuple(attempts),
                             residual_ratio=ratio, trace_id=tid)
    if last_armor is not None and not any(
            a.outcome in ("breakdown", "residual_gate") for a in attempts):
        # Every failure was transport: the armor error is the right typed
        # refusal (it carries the label / shard / trace id).
        last_armor.attempts = tuple(attempts)
        raise _refuse(rec, tid, last_armor)
    raise _refuse(rec, tid, _classify_exhausted(A, tuple(attempts), probe))


def _factor_health(fact, mesh) -> "tuple[bool, bool]":
    """``(non-finite factors, exactly-zero R pivot)`` of a factorization.
    On a mesh each rank holds its own block of H, so the non-finite flag
    is summed over the ranks (every rank takes the same branch); alpha is
    R's whole diagonal on every rank."""
    flags = torch.stack([
        _guards._nonfinite(fact.H) | _guards._nonfinite(fact.alpha),
        (fact.alpha == 0).any()]).to(torch.float32)
    if mesh is not None:
        from dhqr_tpu_torch.parallel.wire import wire_psum

        flags = wire_psum(flags, mesh)
    bad, zero = (flags > 0).tolist()
    return bad, zero


def guarded_qr(A, config=None, mesh=None, device=None,
               **overrides) -> GuardedResult:
    """Packed QR with numeric guardrails.

    ``qr()`` supports one engine family (householder — the packed-reflector
    contract), so the ladder here is POLICY escalation only: the caller's
    configuration, then ``accurate``. Screening and typed refusal match
    :func:`guarded_lstsq`; a structurally singular factorization (an
    exactly-zero R diagonal entry — every later solve would divide by it)
    raises :class:`IllConditioned` rather than returning.
    ``guards="full"`` also records the R-diagonal condition lower bound on
    the result (no residual probe — a factorization has no residual).
    ``qr(A, guards=..., donate=True)`` is refused: escalation must be able
    to re-read A.
    """
    from dhqr_tpu_torch.models import qr_model as _qm
    from dhqr_tpu_torch.precision import PRECISION_POLICIES
    from dhqr_tpu_torch.utils.config import DHQRConfig

    cfg = dataclasses.replace(config or DHQRConfig(), **overrides)
    mode = _mode(cfg)
    cfg = dataclasses.replace(cfg, guards=None)
    A, _ = _inputs(A, None, mesh, device)
    dev = A.device if mesh is None else None

    rec, tid = _trace_guarded("guarded_qr", cfg.engine, mode, A.shape)
    COUNTERS.bump("guarded_calls")
    try:
        _screen(A, None, cfg.engine)
    except NumericalError as e:
        COUNTERS.bump("screen_rejects")
        _trace_refusal(rec, tid, e)
        raise
    if rec is not None:
        rec.event(tid, "screen", outcome="ok")
    if mode == "screen":
        fact = _qm.qr(A, config=cfg, mesh=mesh, device=dev)
        desc = _policy_desc(None, cfg) if cfg.policy is None else \
            str(cfg.policy)
        att = Attempt(cfg.engine, desc, "ok")
        _trace_rung(rec, tid, att)
        if rec is not None:
            rec.event(tid, "resolve", outcome="ok", engine=cfg.engine)
        return GuardedResult(fact, cfg.engine, desc, (att,),
                             trace_id=tid)

    rungs: "list[tuple[object, str]]" = [(cfg, "caller")]
    defaults = DHQRConfig()
    # The "accurate" rung exists only when the caller's FACTOR program is
    # cheaper than it; otherwise it would re-factor the same program.
    pol0 = None
    if cfg.policy is not None:
        from dhqr_tpu_torch.precision import resolve_policy

        pol0 = resolve_policy(cfg.policy)
    factor_cheap = (
        (pol0 is not None and (pol0.panel != "highest"
                               or pol0.split_trailing() is not None))
        or (pol0 is None and (cfg.precision != defaults.precision
                              or cfg.trailing_precision is not None))
        or cfg.norm != defaults.norm)
    if factor_cheap:
        acc = dataclasses.replace(
            defaults, policy=PRECISION_POLICIES["accurate"],
            mesh_axis=cfg.mesh_axis, block_size=cfg.block_size)
        rungs.append((acc, "accurate"))

    attempts: "list[Attempt]" = []
    last_armor: "ArmorError | None" = None
    _att = _attempt_recorder(attempts, rec, tid)
    for rcfg, desc in rungs:
        try:
            _faults.fire("numeric.breakdown")
        except _faults.FaultInjected:
            _att(Attempt("householder", desc, "breakdown",
                         detail="injected numeric.breakdown"))
            continue
        try:
            # config errors propagate
            fact = _qm.qr(A, config=rcfg, mesh=mesh, device=dev)
        except ArmorError as e:
            last_armor = e
            _att(Attempt("householder", desc, "corruption",
                         detail=str(e)[:200]))
            continue
        bad, zero_pivot = _factor_health(fact, mesh)
        if bad:
            _att(Attempt("householder", desc, "breakdown"))
            continue
        if zero_pivot:
            # Record the rung that OBSERVED the zero pivot.
            _att(Attempt("householder", desc, "zero_pivot"))
            raise _refuse(rec, tid, IllConditioned(
                "R has an exactly-zero diagonal entry (rank-deficient "
                "to working precision); solves from this factorization "
                "would divide by zero",
                engine="householder", cond_estimate=float("inf"),
                attempts=tuple(attempts)))
        _att(Attempt("householder", desc, "ok"))
        if len(attempts) > 1:
            COUNTERS.bump("recovered")
        if rec is not None:
            rec.event(tid, "resolve", outcome="ok", engine="householder",
                      escalations=len(attempts) - 1)
        cond = (_guards.diag_condition_bound(fact.alpha)
                if mode == "full" else None)
        return GuardedResult(fact, "householder", desc, tuple(attempts),
                             cond_estimate=cond, trace_id=tid)
    if last_armor is not None and not any(
            a.outcome == "breakdown" for a in attempts):
        last_armor.attempts = tuple(attempts)
        raise _refuse(rec, tid, last_armor)
    raise _refuse(rec, tid, Breakdown(
        f"householder factorization broke down on every rung "
        f"({len(attempts)} tried) — a finite input should never do "
        "this; suspect hardware or an injected fault left armed",
        engine="householder", attempts=tuple(attempts)))


__all__ = [
    "Attempt",
    "COUNTERS",
    "ENGINE_LADDER",
    "GUARD_MODES",
    "GuardedResult",
    "guarded_lstsq",
    "guarded_qr",
]
