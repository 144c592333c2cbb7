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
    (lstsq), ``lookahead`` and ``agg_panels``. ``mesh_axis`` and ``layout``
    steer the mesh tier (``mesh=``, :mod:`dhqr_tpu_torch.parallel`) and
    are ignored on a single device, as in the JAX package. ``comms``
    parses ("f32"/"none" mean None, the one wire format ported);
    ``overlap_depth`` is mesh-only, a ``ValueError`` on a single device as
    in the JAX package, and on a mesh only depth 1 (the lookahead order)
    runs. Every other field must stay at its default: the entry points
    refuse it (:func:`refuse_unported`).
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
    ("guards", "Queue A item 10 (numeric/ladder.py)"),
    ("comms", "Queue A item 11 (the compressed wire, with the two-tier "
              "pod mesh)"),
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
