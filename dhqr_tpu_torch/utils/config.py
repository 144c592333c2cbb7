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
    "tsqr", "cholqr2", "cholqr3"), ``panel_impl`` in ("loop", "recursive")
    and ``refine`` (lstsq). ``mesh_axis`` and ``layout`` only steer the
    mesh tier and are ignored on a single device, as in the JAX package.
    ``comms`` parses ("f32"/"none" mean None). Every other field must stay
    at its default: the entry points refuse it (:func:`refuse_unported`).
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
    ("lookahead", "Queue A item 5 (lookahead/aggregated schedules)"),
    ("agg_panels", "Queue A item 5 (lookahead/aggregated schedules)"),
    ("overlap_depth", "Queue A item 11 (parallel/)"),
    ("comms", "Queue A item 11 (parallel/)"),
)

ENGINES = ("householder", "tsqr", "cholqr2", "cholqr3", "sketch")
_ENGINE_ITEMS = {"sketch": "Queue A item 12 (solvers/)"}


def refuse_unported(cfg: DHQRConfig, mesh=None) -> None:
    """Raise :class:`NotPortedError` for every knob this port does not run,
    and ``ValueError`` for values the JAX package itself rejects."""
    if mesh is not None:
        raise NotPortedError("mesh=", "Queue A item 11 (parallel/)")
    defaults = DHQRConfig()
    for field, item in _UNPORTED_FIELDS:
        if getattr(cfg, field) != getattr(defaults, field):
            raise NotPortedError(f"{field}={getattr(cfg, field)!r}", item)
    if cfg.engine not in ENGINES:
        raise ValueError(
            f"unknown engine {cfg.engine!r}: expected one of {ENGINES}")
    if cfg.engine in _ENGINE_ITEMS:
        raise NotPortedError(f"engine={cfg.engine!r}",
                             _ENGINE_ITEMS[cfg.engine])
    for name in (cfg.precision, cfg.trailing_precision, cfg.apply_precision):
        if name is not None:
            check_precision(name)
    if cfg.panel_impl.startswith("reconstruct"):
        raise NotPortedError(f"panel_impl={cfg.panel_impl!r}",
                             "Queue A item 3 (the reconstruct trio)")
    if cfg.panel_impl not in ("loop", "recursive"):
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
