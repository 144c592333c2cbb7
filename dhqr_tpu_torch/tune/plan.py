"""Execution plans — the unit the autotuner searches over and caches
(port of ``dhqr_tpu/tune/plan.py``: the same fields, checks, messages,
dict payload and ``describe`` spelling, so a plan DB file reads the same
in both packages).

A :class:`Plan` names the engine-selection knobs that dominate wall time
for one problem shape: the engine family, the compact-WY panel width
``nb``, the panel-interior algorithm, the trailing-GEMM precision split,
and (on meshes) the schedule levers ``agg_panels``/``lookahead``. It is
exactly the subset of :class:`dhqr_tpu_torch.utils.config.DHQRConfig` the
serve-tier ladder proved shape-sensitive (round 8: ``nb=32`` beat the
static ``nb=128`` by 4.5x for vmapped 384x128 problems), made
first-class so a measurement can be recorded once and replayed on every
later call.

Accuracy knobs (``precision``, ``norm``, ``refine``, policies) are NOT
plan fields: a plan must never silently change the answer's error bar —
it is keyed UNDER the caller's policy instead (see
:func:`dhqr_tpu_torch.tune.db.plan_key`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Engine families a plan may name. cholqr3 is deliberately absent: the
# shifted window exists for near-rank-deficient problems, which a timing
# search cannot detect — routing there is an accuracy decision the
# caller must make via engine=. "sketch" (round 17) is the randomized
# compressed-core engine; like the other alt engines its admissibility
# is decided by the search's accuracy gate per candidate, and the grid
# only offers it past the SketchConfig.min_aspect aspect ratio.
PLAN_ENGINES = ("householder", "tsqr", "cholqr2", "sketch")

_PANEL_IMPLS = ("loop", "recursive", "reconstruct")

_TRAILING = (None, "highest", "high", "default")


@dataclasses.dataclass(frozen=True)
class Plan:
    """One executable configuration for a (shape, dtype, mesh) problem.

    Attributes:
      engine: "householder" (the packed-reflector default; the only
        engine ``qr()`` accepts), "tsqr", "cholqr2" or "sketch"
        (lstsq-only fast paths for tall-skinny problems).
      block_size: compact-WY panel width nb; None keeps the engine's
        auto resolution (``ops.blocked.auto_block_size`` single-device).
      panel_impl: panel-interior algorithm of the blocked engine
        ("loop" / "recursive" / "reconstruct[:chunk]"; on the card the
        Hopper panel kernel takes f32 and c64 panels whatever it says,
        as the Pallas kernel does in the JAX package).
      trailing_precision: trailing-GEMM precision split (None = no
        split). Only tuned when the caller did not already fix precision
        via a policy — see ``search.candidate_plans``.
      lookahead / agg_panels: mesh schedule levers (1-device plans keep
        the defaults; the pair composes only on multi-device meshes).
      overlap_depth: depth-k pipelined panel broadcast (dhqr-pipeline,
        round 19): None/1 = the classic one-panel lookahead, k >= 2
        keeps k panel broadcasts in flight ahead of the trailing GEMM.
        Requires ``lookahead`` and excludes ``agg_panels`` (the
        aggregated schedule has its own panel grouping). Arithmetic is
        per-column identical to the lookahead schedule, so unlike
        ``comms`` it never moves the error bar — the grid offers it
        purely on the pulse-measured exposed comms floor (see
        ``search.candidate_plans``).
      comms: collective wire format on the sharded tier (dhqr-wire,
        round 18): None = uncompressed, "bf16"/"int8" route every
        sharded collective through the compression seam
        (``dhqr_tpu_torch.parallel.wire``). Like ``trailing_precision`` it
        CAN move the error bar, so the grid only offers it when the
        caller did not pin precision via a policy, and the search's
        8x-LAPACK accuracy gate decides admissibility per candidate —
        a compressed plan can only be recorded after beating the bar
        on this backend. Applies to every engine family with a mesh
        (householder panels, tsqr combine, cholqr Gram); meaningless
        (and rejected by the serve tier) where no collectives launch.
    """

    engine: str = "householder"
    block_size: Optional[int] = None
    panel_impl: str = "loop"
    trailing_precision: Optional[str] = None
    lookahead: bool = False
    agg_panels: Optional[int] = None
    overlap_depth: Optional[int] = None
    comms: Optional[str] = None

    def __post_init__(self):
        if self.engine not in PLAN_ENGINES:
            raise ValueError(
                f"Plan.engine must be one of {PLAN_ENGINES}, "
                f"got {self.engine!r}"
            )
        if self.block_size is not None and self.block_size < 1:
            raise ValueError(
                f"Plan.block_size must be >= 1 or None, got {self.block_size}"
            )
        base = self.panel_impl.split(":", 1)[0]
        if base not in _PANEL_IMPLS:
            raise ValueError(
                f"Plan.panel_impl must be one of {_PANEL_IMPLS} "
                f"(optionally 'reconstruct:<chunk>'), got {self.panel_impl!r}"
            )
        if self.trailing_precision not in _TRAILING:
            raise ValueError(
                f"Plan.trailing_precision must be one of {_TRAILING}, "
                f"got {self.trailing_precision!r}"
            )
        if self.agg_panels is not None and self.agg_panels < 2:
            raise ValueError(
                f"Plan.agg_panels must be >= 2 or None, got {self.agg_panels}"
            )
        if self.overlap_depth is not None:
            if self.overlap_depth < 2:
                raise ValueError(
                    "Plan.overlap_depth must be >= 2 or None (depth 1 IS "
                    f"the lookahead schedule), got {self.overlap_depth}"
                )
            if not self.lookahead:
                raise ValueError(
                    "Plan.overlap_depth requires lookahead=True: the "
                    "pipeline generalizes the lookahead broadcast, it "
                    "does not replace the blocking schedule"
                )
            if self.agg_panels:
                raise ValueError(
                    "Plan.overlap_depth is mutually exclusive with "
                    "agg_panels (the aggregated schedule already groups "
                    "panel broadcasts its own way)"
                )
        from dhqr_tpu_torch.precision import resolve_comms

        object.__setattr__(self, "comms", resolve_comms(self.comms))
        if self.engine != "householder":
            # The alt engines have no panel loop / trailing split /
            # schedule to steer; a plan carrying those knobs anyway would
            # be rejected downstream with a confusing per-knob error.
            # (comms IS allowed: the sharded tsqr/cholqr routes have a
            # combine gather / Gram psum to compress.)
            if (self.panel_impl != "loop" or self.trailing_precision
                    or self.lookahead or self.agg_panels
                    or self.overlap_depth):
                raise ValueError(
                    f"engine={self.engine!r} plans carry only block_size "
                    "(panel_impl/trailing_precision/lookahead/agg_panels/"
                    "overlap_depth are blocked-householder knobs)"
                )

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-ready dict (the plan-DB entry payload)."""
        out = {
            "engine": self.engine,
            "block_size": self.block_size,
            "panel_impl": self.panel_impl,
            "trailing_precision": self.trailing_precision,
            "lookahead": self.lookahead,
            "agg_panels": self.agg_panels,
        }
        # Written only when set: plan payloads without a wire format /
        # pipeline depth stay byte-identical to the pre-round-18/19
        # schema, so shipped seed DBs and older readers keep working.
        if self.overlap_depth is not None:
            out["overlap_depth"] = self.overlap_depth
        if self.comms is not None:
            out["comms"] = self.comms
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        """Inverse of :meth:`to_dict`; validates via ``__post_init__``.
        Unknown keys are rejected — a future-versioned entry must fail
        the per-entry schema check (and be skipped by the DB loader),
        not half-load."""
        if not isinstance(d, dict):
            raise ValueError(f"plan payload must be a dict, got {type(d)}")
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown plan fields {sorted(extra)}")
        kwargs = dict(d)
        for int_field in ("block_size", "agg_panels", "overlap_depth"):
            if kwargs.get(int_field) is not None:
                kwargs[int_field] = int(kwargs[int_field])
        if "lookahead" in kwargs:
            kwargs["lookahead"] = bool(kwargs["lookahead"])
        return cls(**kwargs)

    def describe(self) -> str:
        """Compact human-readable spelling for logs/JSONL rows."""
        parts = [self.engine]
        if self.block_size is not None:
            parts.append(f"nb{self.block_size}")
        if self.panel_impl != "loop":
            parts.append(self.panel_impl)
        if self.trailing_precision:
            parts.append(f"tp-{self.trailing_precision}")
        if self.lookahead:
            parts.append(
                f"la{self.overlap_depth}" if self.overlap_depth else "la"
            )
        if self.agg_panels:
            parts.append(f"agg{self.agg_panels}")
        if self.comms:
            parts.append(f"w{self.comms}")
        return "+".join(parts)


#: The static default every tier runs without a plan — spelled out so
#: benchmarks and the DB can record "the baseline" as a real Plan.
DEFAULT_PLAN = Plan()
