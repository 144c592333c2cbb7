"""Configuration for the PyTorch port: the same ``DHQRConfig`` fields and
defaults as ``dhqr_tpu/utils/config.py``, the same knob dataclasses
(``SketchConfig``, ``ServeConfig``, ``SchedulerConfig``, ``FleetConfig``,
``FaultConfig``, ``ObsConfig``, ``TuneConfig``, ``ArmorConfig``) with their
``DHQR_*`` variables, and :class:`NotPortedError` for the paths the port
refuses, each naming its ROADMAP item — never a silent fallback to a
different schedule.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.autograd.forward_ad as fwAD

from dhqr_tpu_torch.precision import MXU_PASSES, resolve_comms

# The default matmul precision: full FP32 (and FP64) matmuls, i.e.
# torch.matmul with torch.backends.cuda.matmul.allow_tf32 == False. The
# lower names run as bf16 passes (ops/gemm.py).
DEFAULT_PRECISION = "highest"


class NotPortedError(NotImplementedError):
    """A knob or path of the JAX package that this port does not run yet.

    ``roadmap`` names the ROADMAP.md item that will bring it. With
    ``reason``, the path has no counterpart in the port by design, and the
    message says why instead (ROADMAP.md records it under ``roadmap``).
    """

    def __init__(self, what: str, roadmap: str, reason: "str | None" = None):
        self.what = what
        self.roadmap = roadmap
        self.reason = reason
        if reason is not None:
            super().__init__(f"{what} has no counterpart in dhqr_tpu_torch: "
                             f"{reason} (ROADMAP.md {roadmap})")
            return
        super().__init__(
            f"{what} is not ported to dhqr_tpu_torch yet "
            f"(arrives with ROADMAP.md {roadmap})")


# The ROADMAP item that brought gradients through the mesh: the mesh
# routes where the JAX package's jax.grad fails refuse by design, citing it.
GRAD_MESH_ITEM = ("Not ported by design (Queue A item 29, gradients "
                  "through the mesh)")
# What the JAX package's jax.grad raises on each mesh route the port
# refuses to differentiate (the reasons of :func:`refuse_mesh_grad`).
JAX_MESH_GRAD_FAILURES = {
    "refine": ("ValueError: Received incompatible devices for jitted "
               "computation (the refinement's residual mixes the mesh's "
               "sharded x with a replicated A)"),
    "armor": ("ConcretizationTypeError: Abstract tracer value encountered "
              "where concrete value is expected (the armor checksum's "
              "verdict is read on the host)"),
    "probe": ("TracerArrayConversionError: The numpy.ndarray conversion "
              "method __array__() was called on traced array (the "
              "residual probe solves on the host)"),
    "cond": ("ConcretizationTypeError: Abstract tracer value encountered "
             "where concrete value is expected (the condition bound is "
             "read on the host)"),
}
# Why a panel engine refuses a matrix that records gradients when it is
# called directly: the differentiable route goes around it.
GRAD_BY_DESIGN = ("it writes its factors in place, where autograd cannot "
                  "follow; every public factorization differentiates "
                  "through ops.differentiable.householder_factor instead")


def records_grad(*tensors) -> bool:
    """Whether autograd follows any of ``tensors``: reverse mode (grad
    enabled and ``requires_grad``) or forward mode (a dual tensor, as
    ``torch.func.jvp`` and forward-AD ``gradcheck`` make). None entries
    are skipped."""
    grad_on = torch.is_grad_enabled()
    for t in tensors:
        if t is None:
            continue
        if grad_on and t.requires_grad:
            return True
        if fwAD.unpack_dual(t).tangent is not None:
            return True
    return False


def refuse_grad(tensor: torch.Tensor, engine: str,
                roadmap: str = "Not ported by design",
                reason: "str | None" = GRAD_BY_DESIGN) -> None:
    """Raise :class:`NotPortedError` when autograd follows ``tensor`` into
    ``engine``, rather than return a wrong gradient. The panel engines
    (plain loop, reconstruct, the kernel's wrapper) and the batched engine
    refuse by design."""
    if records_grad(tensor):
        raise NotPortedError(f"gradients through {engine}", roadmap, reason)


def refuse_mesh_grad(route: str, failure: str, *tensors) -> None:
    """Raise :class:`NotPortedError` when autograd follows any of
    ``tensors`` into a mesh ``route`` where the JAX package's ``jax.grad``
    fails too: ``failure`` keys :data:`JAX_MESH_GRAD_FAILURES`, whose
    error the reason quotes."""
    if records_grad(*tensors):
        raise NotPortedError(
            f"gradients through {route}", GRAD_MESH_ITEM,
            "the JAX package's jax.grad fails on the same call with "
            + JAX_MESH_GRAD_FAILURES[failure])


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
    :mod:`dhqr_tpu_torch.numeric.ladder`) and ``plan`` (None, "auto",
    "default" or a :class:`dhqr_tpu_torch.tune.Plan`: the tuned
    engine-selection knobs, ``models.qr_model._resolve_plan_cfg``;
    ``DHQR_TUNE_PLAN``). ``mesh_axis`` and ``layout``
    steer the mesh tier (``mesh=``, :mod:`dhqr_tpu_torch.parallel`) and
    are ignored on a single device, as in the JAX package, and so is
    ``comms``, the mesh's wire format (``"bf16"`` / ``"int8"`` /
    ``"dcn:bf16"`` / ``"dcn:int8"``; "f32"/"none" mean None);
    ``overlap_depth`` is mesh-only, a ``ValueError`` on a single device as
    in the JAX package.
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
        """Build a config from the ``DHQR_*`` variables + overrides, each
        parsed as in the JAX package."""
        env = {}
        if "DHQR_BLOCK_SIZE" in os.environ:
            env["block_size"] = int(os.environ["DHQR_BLOCK_SIZE"])
        if "DHQR_MESH_AXIS" in os.environ:
            env["mesh_axis"] = os.environ["DHQR_MESH_AXIS"]
        if "DHQR_BLOCKED" in os.environ:
            env["blocked"] = os.environ["DHQR_BLOCKED"].strip().lower() not in (
                "0", "false", "no", "off", "n", "",
            )
        for var, field in (("DHQR_USE_PALLAS", "use_pallas"),
                           ("DHQR_PRECISION", "precision"),
                           ("DHQR_LAYOUT", "layout"),
                           ("DHQR_ENGINE", "engine"),
                           ("DHQR_NORM", "norm"),
                           ("DHQR_PANEL_IMPL", "panel_impl"),
                           ("DHQR_TRAILING_PRECISION", "trailing_precision"),
                           ("DHQR_APPLY_PRECISION", "apply_precision")):
            if var in os.environ:
                env[field] = os.environ[var]
        if "DHQR_REFINE" in os.environ:
            env["refine"] = int(os.environ["DHQR_REFINE"])
        if "DHQR_LOOKAHEAD" in os.environ:
            env["lookahead"] = os.environ["DHQR_LOOKAHEAD"].strip().lower() \
                not in ("0", "false", "no", "off", "n", "")
        for var, field in (("DHQR_AGG_PANELS", "agg_panels"),
                           ("DHQR_OVERLAP_DEPTH", "overlap_depth")):
            if var in os.environ:  # "0" or empty: off
                raw = os.environ[var].strip()
                env[field] = int(raw) if raw and raw != "0" else None
        if "DHQR_COMMS" in os.environ:
            raw = os.environ["DHQR_COMMS"].strip().lower()
            # normalized here, as in the JAX package: "f32"/"none" are
            # None and a typo refuses at config build
            env["comms"] = resolve_comms(raw) if raw else None
        if "DHQR_POLICY" in os.environ:
            env["policy"] = os.environ["DHQR_POLICY"].strip() or None
        if "DHQR_GUARDS" in os.environ:
            raw = os.environ["DHQR_GUARDS"].strip().lower()
            env["guards"] = None if raw in (
                "", "0", "off", "none", "false", "no") else raw
        if "DHQR_TUNE_PLAN" in os.environ:
            raw = os.environ["DHQR_TUNE_PLAN"].strip().lower()
            if raw not in ("", "auto", "default"):
                raise ValueError(
                    f"DHQR_TUNE_PLAN must be 'auto' or 'default', got {raw!r}"
                )
            env["plan"] = raw or None
        env.update(overrides)
        return DHQRConfig(**env)


def check_precision(precision: str) -> None:
    """Refuse a name that is not a matmul precision."""
    if precision not in MXU_PASSES:
        raise ValueError(f"precision must be one of {sorted(MXU_PASSES)}, "
                         f"got {precision!r}")


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
    """Raise ``ValueError`` for the knob values the JAX package itself
    rejects (every knob of the JAX config runs in the port)."""
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
    (``DHQR_SKETCH_MIN_ASPECT``): the m/n gate of the tuner's sketch
    candidate (``tune.search.candidate_plans``, rule 5).
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


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs for the batched serving tier (:mod:`dhqr_tpu_torch.serve`):
    fields, defaults, checks and ``DHQR_SERVE_*`` variables as the JAX
    package's ``ServeConfig``, so both packages plan the same bucket
    lattice and mint the same cache keys.

    Attributes:
      ratio: geometric growth factor of the bucket lattice (> 1); the
        default ``sqrt(2)`` gives the half-octave ladder 64, 96, 128,
        192, 256, ... (``serve.buckets.bucket_dim``).
      min_dim: smallest lattice dimension (>= 8).
      max_batch: largest stacked batch per dispatch; bigger groups are
        chunked, and batch sizes are bucketed to powers of two up to it.
      cache_size: LRU bound on resident bucket programs
        (``serve.cache.ExecutableCache``); on the card an eviction frees
        the captured CUDA graph and its memory pool.
      quarantine_s: cooldown in seconds after a failed compile (a failed
        capture on the card) during which the key raises ``Quarantined``
        (``DHQR_SERVE_QUARANTINE_S``).
    """

    ratio: float = math.sqrt(2.0)
    min_dim: int = 16
    max_batch: int = 256
    cache_size: int = 64
    quarantine_s: float = 30.0

    def __post_init__(self):
        if not self.ratio > 1.0:
            raise ValueError(f"ratio must be > 1, got {self.ratio}")
        if self.min_dim < 8:
            raise ValueError(f"min_dim must be >= 8, got {self.min_dim}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, got {self.cache_size}")
        if not self.quarantine_s > 0:
            raise ValueError(
                f"quarantine_s must be > 0, got {self.quarantine_s}")

    @staticmethod
    def from_env(**overrides) -> "ServeConfig":
        """Build a serve config from ``DHQR_SERVE_*`` variables + overrides."""
        env = {}
        if "DHQR_SERVE_RATIO" in os.environ:
            env["ratio"] = float(os.environ["DHQR_SERVE_RATIO"])
        if "DHQR_SERVE_MIN_DIM" in os.environ:
            env["min_dim"] = int(os.environ["DHQR_SERVE_MIN_DIM"])
        if "DHQR_SERVE_MAX_BATCH" in os.environ:
            env["max_batch"] = int(os.environ["DHQR_SERVE_MAX_BATCH"])
        if "DHQR_SERVE_CACHE_SIZE" in os.environ:
            env["cache_size"] = int(os.environ["DHQR_SERVE_CACHE_SIZE"])
        if "DHQR_SERVE_QUARANTINE_S" in os.environ:
            env["quarantine_s"] = float(
                os.environ["DHQR_SERVE_QUARANTINE_S"])
        env.update(overrides)
        return ServeConfig(**env)


def _parse_tenant_weights(raw: str) -> "tuple[tuple[str, float], ...]":
    """Parse ``DHQR_SERVE_TENANT_WEIGHTS``: ``"tenantA:3,tenantB:1"``."""
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, weight = part.partition(":")
        if not sep or not name.strip():
            raise ValueError(
                f"tenant weight entry must be 'name:weight', got {part!r}"
            )
        out.append((name.strip(), float(weight)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs for the async serving scheduler
    (:mod:`dhqr_tpu_torch.serve.scheduler`): fields, defaults, checks and
    ``DHQR_SERVE_*`` variables as the JAX package's ``SchedulerConfig``.
    They shape admission and flush policy, not the bucket lattice
    (:class:`ServeConfig`) or the numerics (:class:`DHQRConfig`).

    Attributes:
      slo_ms: default latency budget (ms) of a request submitted without
        a ``deadline`` (``DHQR_SERVE_SLO_MS``).
      queue_depth: admission high-water mark over all buckets, past which
        ``submit`` raises ``BackpressureError`` (``DHQR_SERVE_QUEUE_DEPTH``).
      flush_interval_ms: longest coalescing wait (ms) of a bucket's oldest
        request (``DHQR_SERVE_FLUSH_INTERVAL_MS``).
      tenant_weights: weighted round-robin shares as ``(tenant, weight)``
        pairs, unnamed tenants weigh 1; ``DHQR_SERVE_TENANT_WEIGHTS`` as
        ``"tenantA:3,tenantB:1"``; a dict is normalized to a sorted tuple.
      max_retries: re-queues of a failed flush before escalation to
        bisection (``DHQR_SERVE_MAX_RETRIES``; 0 escalates at once).
      retry_base_ms: first backoff (ms); attempt k waits
        ``retry_base_ms * 2**(k-1)``, inside the deadline only
        (``DHQR_SERVE_RETRY_BASE_MS``).
    """

    slo_ms: float = 100.0
    queue_depth: int = 1024
    flush_interval_ms: float = 20.0
    tenant_weights: "tuple[tuple[str, float], ...]" = ()
    max_retries: int = 2
    retry_base_ms: float = 10.0

    def __post_init__(self):
        if isinstance(self.tenant_weights, dict):
            object.__setattr__(
                self, "tenant_weights",
                tuple(sorted(self.tenant_weights.items())))
        if not self.slo_ms > 0:
            raise ValueError(f"slo_ms must be > 0, got {self.slo_ms}")
        if self.queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {self.queue_depth}")
        if not self.flush_interval_ms > 0:
            raise ValueError(
                f"flush_interval_ms must be > 0, got {self.flush_interval_ms}")
        for name, weight in self.tenant_weights:
            if not weight > 0:
                raise ValueError(
                    f"tenant weight must be > 0, got {name!r}: {weight}"
                )
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if not self.retry_base_ms > 0:
            raise ValueError(
                f"retry_base_ms must be > 0, got {self.retry_base_ms}")

    def weight_for(self, tenant: str) -> float:
        for name, weight in self.tenant_weights:
            if name == tenant:
                return weight
        return 1.0

    @staticmethod
    def from_env(**overrides) -> "SchedulerConfig":
        """Build a scheduler config from ``DHQR_SERVE_*`` variables +
        overrides."""
        env = {}
        if "DHQR_SERVE_SLO_MS" in os.environ:
            env["slo_ms"] = float(os.environ["DHQR_SERVE_SLO_MS"])
        if "DHQR_SERVE_QUEUE_DEPTH" in os.environ:
            env["queue_depth"] = int(os.environ["DHQR_SERVE_QUEUE_DEPTH"])
        if "DHQR_SERVE_FLUSH_INTERVAL_MS" in os.environ:
            env["flush_interval_ms"] = float(
                os.environ["DHQR_SERVE_FLUSH_INTERVAL_MS"])
        if "DHQR_SERVE_TENANT_WEIGHTS" in os.environ:
            env["tenant_weights"] = _parse_tenant_weights(
                os.environ["DHQR_SERVE_TENANT_WEIGHTS"])
        if "DHQR_SERVE_MAX_RETRIES" in os.environ:
            env["max_retries"] = int(os.environ["DHQR_SERVE_MAX_RETRIES"])
        if "DHQR_SERVE_RETRY_BASE_MS" in os.environ:
            env["retry_base_ms"] = float(
                os.environ["DHQR_SERVE_RETRY_BASE_MS"])
        env.update(overrides)
        return SchedulerConfig(**env)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs for the fleet tier (:mod:`dhqr_tpu_torch.serve.store`,
    :mod:`dhqr_tpu_torch.serve.router`): fields, defaults, checks and
    ``DHQR_FLEET_*`` variables as the JAX package's ``FleetConfig``.

    Attributes:
      store_dir: directory of the key store (``DHQR_FLEET_STORE``; unset:
        none). On the card it records each captured key, not a program:
        a CUDA graph does not outlive its process, so a new replica
        recaptures (``serve.store``).
      state_path: JSON file the serving verdicts (compile quarantines)
        are shared through, merged last-write-wins (``DHQR_FLEET_STATE``).
      replicas: scheduler replicas a ``Router()`` builds when not handed
        any (``DHQR_FLEET_REPLICAS``).
      failovers: re-routes of one accepted request after its replica died
        under it, before ``ReplicaLost`` (``DHQR_FLEET_FAILOVERS``).
    """

    store_dir: "str | None" = None
    state_path: "str | None" = None
    replicas: int = 2
    failovers: int = 1

    def __post_init__(self):
        if self.store_dir is not None:
            object.__setattr__(self, "store_dir",
                               os.path.expanduser(self.store_dir))
        if self.state_path is not None:
            object.__setattr__(self, "state_path",
                               os.path.expanduser(self.state_path))
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.failovers < 0:
            raise ValueError(
                f"failovers must be >= 0, got {self.failovers}")

    @staticmethod
    def from_env(**overrides) -> "FleetConfig":
        """Build a fleet config from ``DHQR_FLEET_*`` variables +
        overrides."""
        env = {}
        if "DHQR_FLEET_STORE" in os.environ:
            env["store_dir"] = os.environ["DHQR_FLEET_STORE"] or None
        if "DHQR_FLEET_STATE" in os.environ:
            env["state_path"] = os.environ["DHQR_FLEET_STATE"] or None
        if "DHQR_FLEET_REPLICAS" in os.environ:
            env["replicas"] = int(os.environ["DHQR_FLEET_REPLICAS"])
        if "DHQR_FLEET_FAILOVERS" in os.environ:
            env["failovers"] = int(os.environ["DHQR_FLEET_FAILOVERS"])
        env.update(overrides)
        return FleetConfig(**env)


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


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """Knobs for the autotuner (:mod:`dhqr_tpu_torch.tune`): fields,
    defaults, checks and ``DHQR_TUNE_*`` variables as the JAX package's
    ``TuneConfig``. They shape the search and the persistence, never the
    numerics (a plan names only engine-selection knobs).

    Attributes:
      db_path: the writable plan database (``DHQR_TUNE_DB``), loaded
        tolerantly and written merge-atomically. The default is the
        port's own file beside the JAX package's (the keys' platform
        segments differ too: ``torch-cuda`` / ``torch-cpu``).
      use_seeds: layer the packaged ``tune/default_plans.json`` under the
        local DB (``DHQR_TUNE_SEEDS``, default on; the port's file ships
        no entries).
      budget: most candidates one ``tune()`` times (``DHQR_TUNE_BUDGET``);
        the pruned grid is truncated from its end, never sampled.
      repeats: timed runs per candidate after the warm-up
        (``DHQR_TUNE_REPEATS``); the minimum is kept.
      on_miss: what ``plan="auto"`` does on a DB miss: "tune" (measure,
        record, persist) or "default" (the static plan, no measurement;
        ``DHQR_TUNE_ON_MISS``).
    """

    db_path: str = os.path.join("~", ".cache", "dhqr_tpu_torch",
                                "plans.json")
    use_seeds: bool = True
    budget: int = 16
    repeats: int = 3
    on_miss: str = "tune"

    def __post_init__(self):
        object.__setattr__(self, "db_path",
                           os.path.expanduser(self.db_path))
        if self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {self.budget}")
        if self.repeats < 1:
            raise ValueError(f"repeats must be >= 1, got {self.repeats}")
        if self.on_miss not in ("tune", "default"):
            raise ValueError(
                f"on_miss must be 'tune' or 'default', got {self.on_miss!r}"
            )

    @staticmethod
    def from_env(**overrides) -> "TuneConfig":
        """Build a tune config from ``DHQR_TUNE_*`` variables + overrides."""
        env = {}
        if "DHQR_TUNE_DB" in os.environ:
            env["db_path"] = os.environ["DHQR_TUNE_DB"]
        if "DHQR_TUNE_SEEDS" in os.environ:
            env["use_seeds"] = os.environ["DHQR_TUNE_SEEDS"].strip().lower() \
                not in _FALSY
        if "DHQR_TUNE_BUDGET" in os.environ:
            env["budget"] = int(os.environ["DHQR_TUNE_BUDGET"])
        if "DHQR_TUNE_REPEATS" in os.environ:
            env["repeats"] = int(os.environ["DHQR_TUNE_REPEATS"])
        if "DHQR_TUNE_ON_MISS" in os.environ:
            env["on_miss"] = os.environ["DHQR_TUNE_ON_MISS"].strip().lower()
        env.update(overrides)
        return TuneConfig(**env)


@dataclasses.dataclass(frozen=True)
class ArmorConfig:
    """Knobs for the verification seam of the sharded tier
    (:mod:`dhqr_tpu_torch.armor`): fields, defaults, checks and
    ``DHQR_ARMOR*`` variables as the JAX package's ``ArmorConfig``. The
    variables configure; only :func:`dhqr_tpu_torch.armor.arm` (or the
    ``armored`` scope) arms.

    Attributes:
      enabled: whether ``armor.arm`` with this config installs the seam
        (``DHQR_ARMOR``).
      rtol: relative tolerance of the checksum invariants on the
        uncompressed wire (``DHQR_ARMOR_RTOL``); a compressed dispatch
        verifies against ``max(rtol, armor.WIRE_RTOL)``.
      redispatch: re-dispatches after a detection before the wire is
        degraded or the call refused typed (``DHQR_ARMOR_REDISPATCH``).
      wire_tags: the integrity tags on compressed collectives
        (``parallel/wire.py``; ``DHQR_ARMOR_TAGS``, on by default): a
        payload whose checksum disagrees with its sender's tag arrives
        all NaN.
    """

    enabled: bool = False
    rtol: float = 1e-4
    redispatch: int = 1
    wire_tags: bool = True

    def __post_init__(self):
        if not self.rtol > 0:
            raise ValueError(f"rtol must be > 0, got {self.rtol}")
        if self.redispatch < 0:
            raise ValueError(
                f"redispatch must be >= 0, got {self.redispatch}")

    @staticmethod
    def from_env(**overrides) -> "ArmorConfig":
        """Build an armor config from ``DHQR_ARMOR*`` variables +
        overrides."""
        env = {}
        if "DHQR_ARMOR" in os.environ:
            env["enabled"] = os.environ["DHQR_ARMOR"].strip().lower() \
                not in _FALSY
        if "DHQR_ARMOR_RTOL" in os.environ:
            env["rtol"] = float(os.environ["DHQR_ARMOR_RTOL"])
        if "DHQR_ARMOR_REDISPATCH" in os.environ:
            env["redispatch"] = int(os.environ["DHQR_ARMOR_REDISPATCH"])
        if "DHQR_ARMOR_TAGS" in os.environ:
            env["wire_tags"] = os.environ["DHQR_ARMOR_TAGS"].strip() \
                .lower() not in _FALSY
        env.update(overrides)
        return ArmorConfig(**env)


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
      xray, xray_reports: whether ``obs.arm`` arms the xray capture of
        the serve cache's compiles (:mod:`dhqr_tpu_torch.obs.xray`;
        ``DHQR_OBS_XRAY``) and its report capacity
        (``DHQR_OBS_XRAY_REPORTS``).
      profile_dir: ``DHQR_OBS_PROFILE``, parsed as in the JAX package:
        the directory :func:`dhqr_tpu_torch.utils.profiling.trace` writes
        to when it is given none.
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
