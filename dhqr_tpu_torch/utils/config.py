"""Configuration for the PyTorch port: the same ``DHQRConfig`` fields and
defaults as ``dhqr_tpu/utils/config.py``, plus the refusals of what this
port does not run yet.

Every field of the JAX config is accepted, so a config built from the JAX
one's field values (:func:`dhqr_tpu_torch.interop.config_from_fields`)
always constructs. The entry points then refuse each knob the port has not
brought over with a :class:`NotPortedError` that names the ROADMAP item
that will bring it — never a silent fallback to a different schedule.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from dhqr_tpu_torch.precision import MXU_PASSES

# The default matmul precision: full FP32 (and FP64) matmuls, i.e.
# torch.matmul with torch.backends.cuda.matmul.allow_tf32 == False. The
# lower names run as bf16 passes (ops/gemm.py).
DEFAULT_PRECISION = "highest"


class NotPortedError(NotImplementedError):
    """A knob or path of the JAX package that this port does not run yet.

    ``roadmap`` names the ROADMAP.md item that will bring it.
    """

    def __init__(self, what: str, roadmap: str):
        self.what = what
        self.roadmap = roadmap
        super().__init__(
            f"{what} is not ported to dhqr_tpu_torch yet "
            f"(arrives with ROADMAP.md {roadmap})")


def refuse_grad(panel: torch.Tensor, engine: str) -> None:
    """The panel engines write their factors where autograd cannot follow:
    in place (the plain loop) or through a raw pointer (the Hopper kernel),
    so a panel that requires grad raises rather than return a wrong
    gradient. ``lstsq_diff`` factors with grad off and brings its own
    derivative rules."""
    if torch.is_grad_enabled() and panel.requires_grad:
        raise NotPortedError(
            f"gradients through {engine}",
            "Queue A item 19 (gradients outside the blocked lstsq)")


@dataclasses.dataclass(frozen=True)
class DHQRConfig:
    """Knobs for the factorization/solve engines (fields and defaults as in
    the JAX package's ``DHQRConfig``; see its docstring for each field).

    What the port runs: ``block_size`` (None = 128), ``blocked``,
    ``use_pallas`` (here: the hand-written Hopper panel kernel —
    "auto"/"always"/"never"), ``precision``, ``trailing_precision`` and
    ``apply_precision`` (every name of ``precision.MXU_PASSES``; see
    ``ops/gemm.py``), ``policy``, ``norm``, ``engine`` in ("householder",
    "tsqr", "cholqr2", "cholqr3", "sketch"), ``panel_impl`` in ("loop",
    "recursive", "reconstruct", "reconstruct:<chunk>"), ``refine``
    (lstsq), ``lookahead``, ``agg_panels`` and ``guards`` (None, or
    "screen" / "fallback" / "full": the entry points route through
    :mod:`dhqr_tpu_torch.numeric.ladder`). ``mesh_axis`` and ``layout``
    steer the mesh tier (``mesh=``, :mod:`dhqr_tpu_torch.parallel`) and
    are ignored on a single device, as in the JAX package, and so is
    ``comms``, the mesh's wire format (``"bf16"`` / ``"int8"`` /
    ``"dcn:bf16"`` / ``"dcn:int8"``; "f32"/"none" mean None);
    ``overlap_depth`` is mesh-only, a ``ValueError`` on a single device as
    in the JAX package. ``plan`` must stay at its default: the entry
    points refuse it (:func:`refuse_unported`).
    """

    block_size: "int | None" = None
    mesh_axis: "str | None" = None
    blocked: bool = True
    use_pallas: str = "auto"
    precision: str = "highest"
    layout: str = "block"
    engine: str = "householder"
    norm: str = "accurate"
    panel_impl: str = "loop"
    refine: int = 0
    trailing_precision: "str | None" = None
    lookahead: bool = False
    agg_panels: "int | None" = None
    overlap_depth: "int | None" = None
    apply_precision: "str | None" = None
    comms: "str | None" = None
    policy: object = None
    plan: object = None
    guards: "str | None" = None

    @staticmethod
    def from_env(**overrides) -> "DHQRConfig":
        """Build a config from the ported ``DHQR_*`` variables + overrides."""
        env = {}
        if "DHQR_BLOCK_SIZE" in os.environ:
            env["block_size"] = int(os.environ["DHQR_BLOCK_SIZE"])
        if "DHQR_BLOCKED" in os.environ:
            env["blocked"] = os.environ["DHQR_BLOCKED"].strip().lower() not in (
                "0", "false", "no", "off", "n", "",
            )
        for var, field in (("DHQR_USE_PALLAS", "use_pallas"),
                           ("DHQR_PRECISION", "precision"),
                           ("DHQR_ENGINE", "engine"),
                           ("DHQR_NORM", "norm"),
                           ("DHQR_PANEL_IMPL", "panel_impl"),
                           ("DHQR_TRAILING_PRECISION", "trailing_precision"),
                           ("DHQR_APPLY_PRECISION", "apply_precision")):
            if var in os.environ:
                env[field] = os.environ[var]
        if "DHQR_REFINE" in os.environ:
            env["refine"] = int(os.environ["DHQR_REFINE"])
        if "DHQR_POLICY" in os.environ:
            env["policy"] = os.environ["DHQR_POLICY"].strip() or None
        if "DHQR_GUARDS" in os.environ:
            raw = os.environ["DHQR_GUARDS"].strip().lower()
            env["guards"] = None if raw in (
                "", "0", "off", "none", "false", "no") else raw
        env.update(overrides)
        return DHQRConfig(**env)


def check_precision(precision: str) -> None:
    """Refuse a name that is not a matmul precision."""
    if precision not in MXU_PASSES:
        raise ValueError(f"precision must be one of {sorted(MXU_PASSES)}, "
                         f"got {precision!r}")


# (field, ROADMAP item that brings it). Each must stay at its default.
_UNPORTED_FIELDS = (
    ("plan", "Queue A item 14 (tune/)"),
)

ENGINES = ("householder", "tsqr", "cholqr2", "cholqr3", "sketch")


def check_sched_knobs(cfg: DHQRConfig, mesh=None) -> None:
    """The JAX package's ``_check_sched_knobs`` (``models/qr_model.py``),
    with its messages: the schedule knobs' values and combinations."""
    if cfg.agg_panels is not None and cfg.agg_panels < 2:
        raise ValueError(
            f"agg_panels must be >= 2 (got {cfg.agg_panels}); "
            "None means per-panel updates"
        )
    if cfg.agg_panels and cfg.lookahead and mesh is None:
        raise ValueError(
            "agg_panels and lookahead are mutually exclusive on the "
            "single-device tier (both only add flops there); on a mesh "
            "the pair is the grouped-lookahead composition — pass mesh= "
            "(see parallel/sharded_qr._blocked_shard_agg)"
        )
    if cfg.overlap_depth is not None:
        if cfg.overlap_depth < 1:
            raise ValueError(
                f"overlap_depth must be >= 1 (got {cfg.overlap_depth}); "
                "None means the default schedule"
            )
        if not cfg.lookahead:
            raise ValueError(
                "overlap_depth generalizes the lookahead order and "
                "requires lookahead=True (depth 1 IS the one-panel "
                "lookahead)"
            )
        if cfg.agg_panels:
            raise ValueError(
                "overlap_depth and agg_panels are mutually exclusive "
                "(the grouped-lookahead composition already overlaps "
                "one full group per collective)"
            )
        if mesh is None:
            raise ValueError(
                "overlap_depth is mesh-only: a deeper pipeline exists "
                "to keep panel-broadcast collectives in flight, and a "
                "single device has no collective to hide — pass mesh= "
                "(see parallel/sharded_qr._blocked_shard_pipeline)"
            )


def refuse_unported(cfg: DHQRConfig, mesh=None) -> None:
    """Raise :class:`NotPortedError` for every knob this port does not run,
    and ``ValueError`` for values the JAX package itself rejects."""
    defaults = DHQRConfig()
    for field, item in _UNPORTED_FIELDS:
        if getattr(cfg, field) != getattr(defaults, field):
            raise NotPortedError(f"{field}={getattr(cfg, field)!r}", item)
    if cfg.engine not in ENGINES:
        raise ValueError(
            f"unknown engine {cfg.engine!r}: expected one of {ENGINES}")
    for name in (cfg.precision, cfg.trailing_precision, cfg.apply_precision):
        if name is not None:
            check_precision(name)
    if cfg.panel_impl.startswith("reconstruct"):
        from dhqr_tpu_torch.ops.blocked import _reconstruct_chunk

        _reconstruct_chunk(cfg.panel_impl)  # raises on a malformed spelling
    elif cfg.panel_impl not in ("loop", "recursive"):
        raise ValueError(
            f"panel_impl must be 'loop', 'recursive', 'reconstruct' or "
            f"'reconstruct:<chunk>', got {cfg.panel_impl!r}")
    if cfg.panel_impl != "loop" and not cfg.blocked:
        raise ValueError(
            "panel_impl applies to the blocked engines only "
            f"(got panel_impl={cfg.panel_impl!r} with blocked=False)")
    if cfg.norm not in ("accurate", "fast"):
        raise ValueError(f"norm must be 'accurate' or 'fast', got {cfg.norm!r}")
    if cfg.use_pallas not in ("auto", "always", "never"):
        raise ValueError("use_pallas must be 'auto', 'always' or 'never', "
                         f"got {cfg.use_pallas!r}")
    check_sched_knobs(cfg, mesh)


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Knobs for the sketched least-squares engine
    (``dhqr_tpu_torch.solvers.sketch``): fields, defaults, checks and
    ``DHQR_SKETCH_*`` variables as the JAX package's ``SketchConfig``.

    ``seed`` (``DHQR_SKETCH_SEED``): the operator is drawn from numpy's
    PCG64 seeded with ``(seed, m, s)``, so a seed gives the bit-identical
    operator in every process and in both packages. ``operator``
    (``DHQR_SKETCH_OPERATOR``): "countsketch", "srht" or "auto" (srht when
    m is a power of two). ``factor`` (``DHQR_SKETCH_FACTOR``): multiplier
    on the ``O(n log n)`` sketch-size rule. ``refine``
    (``DHQR_SKETCH_REFINE``): baseline R-preconditioned CGLS iterations
    against the true A; a caller's ``refine`` adds to it. ``min_aspect``
    (``DHQR_SKETCH_MIN_ASPECT``): the m/n gate of the JAX package's tuner,
    carried for parity (the port has no tuner yet).
    """

    seed: int = 0
    operator: str = "auto"
    factor: float = 2.0
    refine: int = 12
    min_aspect: float = 64.0

    def __post_init__(self):
        if self.operator not in ("auto", "countsketch", "srht"):
            raise ValueError(
                f"operator must be 'auto', 'countsketch' or 'srht', "
                f"got {self.operator!r}")
        if not self.factor > 0:
            raise ValueError(f"factor must be > 0, got {self.factor}")
        if self.refine < 0:
            raise ValueError(f"refine must be >= 0, got {self.refine}")
        if not self.min_aspect >= 1:
            raise ValueError(
                f"min_aspect must be >= 1, got {self.min_aspect}")

    @staticmethod
    def from_env(**overrides) -> "SketchConfig":
        """Build a sketch config from ``DHQR_SKETCH_*`` variables +
        overrides."""
        env = {}
        if "DHQR_SKETCH_SEED" in os.environ:
            env["seed"] = int(os.environ["DHQR_SKETCH_SEED"])
        if "DHQR_SKETCH_OPERATOR" in os.environ:
            env["operator"] = os.environ["DHQR_SKETCH_OPERATOR"].strip() \
                .lower()
        if "DHQR_SKETCH_FACTOR" in os.environ:
            env["factor"] = float(os.environ["DHQR_SKETCH_FACTOR"])
        if "DHQR_SKETCH_REFINE" in os.environ:
            env["refine"] = int(os.environ["DHQR_SKETCH_REFINE"])
        if "DHQR_SKETCH_MIN_ASPECT" in os.environ:
            env["min_aspect"] = float(os.environ["DHQR_SKETCH_MIN_ASPECT"])
        env.update(overrides)
        return SketchConfig(**env)


_FALSY = ("0", "false", "no", "off", "n", "")


def _parse_fault_sites(raw: str):
    """Parse ``DHQR_FAULTS``: comma-separated ``site:prob[:count[:k]]``
    entries, e.g. ``"serve.compile:0.5,numeric.breakdown:1.0:2"`` — fire at
    ``site`` with probability ``prob`` per visit, at most ``count`` times in
    all (unbounded when omitted), and with the fourth segment ``k`` only
    from the site's k-th visit on (``"numeric.breakdown:1.0:1:3"`` fires on
    exactly the third visit). The JAX package's parser, spelling for
    spelling."""
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (2, 3, 4) or not fields[0].strip():
            raise ValueError(
                f"fault entry must be 'site:prob[:count[:k]]', got {part!r}"
            )
        site = fields[0].strip()
        prob = float(fields[1])
        count = int(fields[2]) if len(fields) >= 3 else None
        if len(fields) == 4:
            out.append((site, prob, count, int(fields[3])))
        else:
            out.append((site, prob, count))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs for the deterministic fault-injection harness
    (:mod:`dhqr_tpu_torch.faults`): fields, defaults, checks and
    ``DHQR_FAULTS*`` variables as the JAX package's ``FaultConfig``. With
    no sites the harness is inert and every injection point is one
    module-global ``None`` check.

    Attributes:
      sites: ``(site, probability, max_triggers)`` triples, or
        ``(site, probability, max_triggers, from_visit)`` quadruples
        (``DHQR_FAULTS`` as ``"site:prob[:count[:k]]"``, comma-separated).
        ``site`` names an injection point of ``faults.SITES`` (an unknown
        name is refused when the harness is built); ``probability`` in
        [0, 1] is the per-visit chance; ``max_triggers`` (None: unbounded)
        caps the firings; ``from_visit`` (None: the first) holds the site
        silent for its first ``k - 1`` visits. ``prob=1.0`` with a count is
        the exact schedule the tests use.
      seed: base seed (``DHQR_FAULTS_SEED``); each site draws from its own
        stream derived from (seed, site name).
      latency_ms: the sleep of a ``sleep``-kind site
        (``DHQR_FAULTS_LATENCY_MS``).
    """

    sites: "tuple[tuple[str, float, int | None], ...]" = ()
    seed: int = 0
    latency_ms: float = 10.0

    def __post_init__(self):
        if isinstance(self.sites, dict):
            object.__setattr__(
                self, "sites",
                tuple((k,) + tuple([float(v[0])] + list(v[1:]))
                      if isinstance(v, tuple)
                      else (k, float(v), None)
                      for k, v in sorted(self.sites.items())))
        for entry in self.sites:
            if len(entry) not in (3, 4):
                raise ValueError(
                    "fault site entry must be (site, prob, count) or "
                    f"(site, prob, count, from_visit), got {entry!r}")
            site, prob, count = entry[0], entry[1], entry[2]
            if not 0.0 <= prob <= 1.0:
                raise ValueError(
                    f"fault probability must be in [0, 1], got "
                    f"{site!r}: {prob}")
            if count is not None and count < 1:
                raise ValueError(
                    f"fault max_triggers must be >= 1 or None, got "
                    f"{site!r}: {count}")
            if len(entry) == 4 and entry[3] is not None and entry[3] < 1:
                raise ValueError(
                    f"fault from_visit (the :k segment) must be >= 1 or "
                    f"None, got {site!r}: {entry[3]}")
        if not self.latency_ms >= 0:
            raise ValueError(
                f"latency_ms must be >= 0, got {self.latency_ms}")

    @property
    def enabled(self) -> bool:
        return bool(self.sites)

    @staticmethod
    def from_env(**overrides) -> "FaultConfig":
        """Build a fault config from ``DHQR_FAULTS*`` variables +
        overrides."""
        env = {}
        if "DHQR_FAULTS" in os.environ:
            env["sites"] = _parse_fault_sites(os.environ["DHQR_FAULTS"])
        if "DHQR_FAULTS_SEED" in os.environ:
            env["seed"] = int(os.environ["DHQR_FAULTS_SEED"])
        if "DHQR_FAULTS_LATENCY_MS" in os.environ:
            env["latency_ms"] = float(os.environ["DHQR_FAULTS_LATENCY_MS"])
        env.update(overrides)
        return FaultConfig(**env)


_OBS_ITEM = "Queue A item 16 (obs/: xray)"


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Knobs for the observability seam (:mod:`dhqr_tpu_torch.obs`):
    fields, defaults, checks and ``DHQR_OBS*`` variables as the JAX
    package's ``ObsConfig``. The variables configure; only
    :func:`dhqr_tpu_torch.obs.arm` (or the ``observed`` scope) arms.

    Attributes:
      enabled: whether ``obs.arm`` installs a trace recorder (``DHQR_OBS``).
      buffer_spans: the recorder's ring capacity in spans
        (``DHQR_OBS_BUFFER``, >= 16); the oldest spans fall off.
      auto_dump: the flight recorder's ``on_error`` destination
        (``DHQR_OBS_DUMP``): None (off), ``"stderr"``, or a directory that
        receives ``flight_<pid>.jsonl``.
      pulse, pulse_reports: whether ``obs.arm`` arms the pulse collective
        profiler (:mod:`dhqr_tpu_torch.obs.pulse`; ``DHQR_OBS_PULSE``) and
        its report capacity (``DHQR_OBS_PULSE_REPORTS``).
      xray, xray_reports, profile_dir: the device introspection knobs
        (``DHQR_OBS_XRAY``, ``DHQR_OBS_XRAY_REPORTS``,
        ``DHQR_OBS_PROFILE``). They construct and parse as in the JAX
        package; ``obs.arm`` with ``xray`` set raises
        :class:`NotPortedError` until ROADMAP Queue A item 16.
    """

    enabled: bool = False
    buffer_spans: int = 4096
    auto_dump: "str | None" = None
    xray: bool = False
    xray_reports: int = 512
    pulse: bool = False
    pulse_reports: int = 256
    profile_dir: "str | None" = None

    def __post_init__(self):
        if self.buffer_spans < 16:
            raise ValueError(
                f"buffer_spans must be >= 16, got {self.buffer_spans}")
        if self.xray_reports < 1:
            raise ValueError(
                f"xray_reports must be >= 1, got {self.xray_reports}")
        if self.pulse_reports < 1:
            raise ValueError(
                f"pulse_reports must be >= 1, got {self.pulse_reports}")
        if self.auto_dump is not None and not str(self.auto_dump).strip():
            object.__setattr__(self, "auto_dump", None)
        if self.profile_dir is not None \
                and not str(self.profile_dir).strip():
            object.__setattr__(self, "profile_dir", None)

    def refuse_unported(self) -> None:
        """Raise :class:`NotPortedError` when this config would arm what
        the port does not run yet (xray)."""
        if self.xray:
            raise NotPortedError("ObsConfig(xray=True)", _OBS_ITEM)

    @staticmethod
    def from_env(**overrides) -> "ObsConfig":
        """Build an obs config from ``DHQR_OBS*`` variables + overrides."""
        env = {}
        if "DHQR_OBS" in os.environ:
            env["enabled"] = os.environ["DHQR_OBS"].strip().lower() \
                not in _FALSY
        if "DHQR_OBS_BUFFER" in os.environ:
            env["buffer_spans"] = int(os.environ["DHQR_OBS_BUFFER"])
        if "DHQR_OBS_DUMP" in os.environ:
            env["auto_dump"] = os.environ["DHQR_OBS_DUMP"].strip() or None
        if "DHQR_OBS_XRAY" in os.environ:
            env["xray"] = os.environ["DHQR_OBS_XRAY"].strip().lower() \
                not in _FALSY
        if "DHQR_OBS_XRAY_REPORTS" in os.environ:
            env["xray_reports"] = int(os.environ["DHQR_OBS_XRAY_REPORTS"])
        if "DHQR_OBS_PULSE" in os.environ:
            env["pulse"] = os.environ["DHQR_OBS_PULSE"].strip().lower() \
                not in _FALSY
        if "DHQR_OBS_PULSE_REPORTS" in os.environ:
            env["pulse_reports"] = int(
                os.environ["DHQR_OBS_PULSE_REPORTS"])
        if "DHQR_OBS_PROFILE" in os.environ:
            env["profile_dir"] = os.environ["DHQR_OBS_PROFILE"].strip() \
                or None
        env.update(overrides)
        return ObsConfig(**env)
