"""The declarative route registry — port of ``dhqr_tpu/tune/registry.py``.

One :class:`Route` record per execution route the port runs (engine
family x panel interior x wire format x mesh schedule x dispatch mode),
with declarative reachability (``min_devices``, ``presets``); the tune
grid's axes (:data:`GRID_ALT_ENGINES`, :data:`GRID_MESH_LEVERS`,
:data:`GRID_WIRE_PLANS`, ...), which :func:`tune.search.candidate_plans
<dhqr_tpu_torch.tune.search.candidate_plans>` iterates, and
:func:`grid_route_for`, the map from a grid candidate to its route; and
the benchmark stage catalogue (:data:`BENCH_STAGES`). Route names, grid
axes and stages are the JAX package's.

The JAX registry also carries each route's analysis hooks (its jaxpr
trace specs, comms-audit spec and contract, serve-key probe cells and
donation entry) for its lint passes. Those passes are not ported: the
hook fields are absent here, and the queries over them
(:func:`jaxpr_routes`, :func:`comms_routes`, :func:`contract_names`,
:func:`serve_routes`, :func:`donated_routes`) raise
:class:`~dhqr_tpu_torch.utils.config.NotPortedError` naming ROADMAP
Queue A item 18b (the graph passes; the source passes of item 18a read
no route).

Not route-distinguishing by design: ``block_size`` (a ladder knob — the
same program schedule at every rung), ``trailing_precision`` (rule 4
pairs it with nothing else), and the serve batch.
"""

from __future__ import annotations

import dataclasses

from dhqr_tpu_torch.precision import COMMS_MODES
from dhqr_tpu_torch.tune.plan import PLAN_ENGINES, Plan
from dhqr_tpu_torch.utils.config import NotPortedError

#: The tune-DB kinds: the serve kinds never route engines, they batch the
#: blocked householder engine / the sketched program.
TUNE_KINDS = ("qr", "lstsq", "serve_qr", "serve_lstsq", "serve_sketch")

#: The serve bucket-program families (the ``kind`` of a serve cache key).
SERVE_PROGRAM_KINDS = ("lstsq", "qr", "sketch")

#: Rule-5 alt-engine offer order (lstsq-only, policy-free, aspect-gated;
#: the gates are thresholds and live with the grid in tune/search.py).
GRID_ALT_ENGINES = ("cholqr2", "tsqr", "sketch")

#: Rule-6 mesh schedule levers, in offer order (applied to the widest
#: ladder rung by candidate_plans).
GRID_MESH_LEVERS = (
    {"lookahead": True},
    {"agg_panels": 2},
    {"agg_panels": 4},
    {"agg_panels": 2, "lookahead": True},
)

#: Rule-6d depth-k pipelined panel-broadcast rungs, in offer order (depth
#: 1 is the plain lookahead lever above), offered only where the
#: pulse-measured exposed comms floor is positive.
GRID_OVERLAP_PLANS = (
    {"lookahead": True, "overlap_depth": 2},
    {"lookahead": True, "overlap_depth": 4},
)

#: Rule-6b flat compressed-collective rungs of the householder mesh path.
GRID_WIRE_PLANS = (
    {"comms": "bf16"},
    {"agg_panels": 2, "comms": "bf16"},
    {"comms": "int8"},
)

#: Rule-6b alt-engine wire rungs: (engine, comms) in offer order.
GRID_ALT_WIRE = (("cholqr2", "bf16"), ("tsqr", "bf16"))

#: Rule-6c topology-tiered rungs (two-tier pod meshes only).
GRID_DCN_PLANS = ({"comms": "dcn:bf16"}, {"comms": "dcn:int8"})

#: Rule-6c alt-engine tiered rungs.
GRID_ALT_DCN = (("tsqr", "dcn:bf16"),)

_HOOKS_ITEM = "Queue A item 18b (the registry's analysis hooks)"


@dataclasses.dataclass(frozen=True, eq=False)
class Route:
    """One execution route, by its identity: engine ``family``, ``kind``,
    ``schedule``, ``panel_impl``, ``comms`` rung, the schedule levers
    (``layout``, ``lookahead``, ``agg_panels``, ``overlap_depth``), the
    dispatch mode (``donated``, ``batched``) and its reachability
    (``min_devices``, ``presets``)."""

    name: str
    family: str                       # one of PLAN_ENGINES + internals
    kind: str                         # "qr" | "lstsq" | "solve" | "update"
    schedule: str                     # "single"|"column"|"row"|"batched"|"pod"
    panel_impl: str = "loop"
    comms: "str | None" = None
    layout: str = "block"
    lookahead: bool = False
    agg_panels: int = 0
    overlap_depth: int = 0
    donated: bool = False
    batched: bool = False
    min_devices: int = 1
    presets: str = "all"              # "all" | "accurate"


_FAMILIES = tuple(PLAN_ENGINES) + ("update", "solve")
_SCHEDULES = ("single", "column", "row", "batched", "pod")

ROUTES: "tuple[Route, ...]" = (
    # -- single-device API tier --------------------------------------------
    Route("householder_single", "householder", "qr", "single"),
    Route("householder_recursive", "householder", "lstsq", "single",
          panel_impl="recursive"),
    Route("householder_reconstruct", "householder", "lstsq", "single",
          panel_impl="reconstruct", presets="accurate"),
    Route("lstsq_auto_engine", "householder", "lstsq", "single",
          presets="accurate"),
    Route("tsqr_plan", "tsqr", "lstsq", "single", presets="accurate"),
    Route("cholqr2_plan", "cholqr2", "lstsq", "single", presets="accurate"),
    Route("tsqr_r_single", "tsqr", "qr", "single"),
    Route("cholesky_qr2_single", "cholqr2", "qr", "single"),
    Route("sketched_lstsq", "sketch", "lstsq", "single"),
    Route("update_solve", "update", "solve", "single"),
    Route("update_rank1", "update", "update", "single"),
    Route("blocked_qr_donate", "householder", "qr", "single", donated=True),
    # -- serving tier (batched bucket programs) ----------------------------
    Route("batched_lstsq", "householder", "lstsq", "batched", batched=True),
    Route("batched_lstsq_recursive", "householder", "lstsq", "batched",
          panel_impl="recursive", batched=True),
    Route("batched_lstsq_wire_bf16", "householder", "lstsq", "batched",
          comms="bf16", batched=True),
    Route("batched_qr", "householder", "qr", "batched", donated=True,
          batched=True),
    Route("batched_qr_recursive", "householder", "qr", "batched",
          panel_impl="recursive", donated=True, batched=True),
    Route("async_lstsq", "householder", "lstsq", "batched", batched=True),
    Route("batched_sketch", "sketch", "lstsq", "batched", batched=True),
    # -- sharded column tier -----------------------------------------------
    Route("unblocked_qr", "householder", "qr", "column", min_devices=2),
    Route("blocked_qr", "householder", "qr", "column", min_devices=2),
    Route("blocked_qr_cyclic", "householder", "qr", "column",
          layout="cyclic", min_devices=2),
    Route("blocked_qr_lookahead", "householder", "qr", "column",
          lookahead=True, min_devices=2),
    Route("blocked_qr_pipeline2", "householder", "qr", "column",
          lookahead=True, overlap_depth=2, min_devices=2),
    Route("blocked_qr_pipeline4", "householder", "qr", "column",
          lookahead=True, overlap_depth=4, min_devices=2),
    Route("blocked_qr_agg", "householder", "qr", "column", agg_panels=2,
          min_devices=2),
    Route("blocked_qr_agg_lookahead", "householder", "qr", "column",
          agg_panels=2, lookahead=True, min_devices=2),
    Route("lstsq_mesh", "householder", "lstsq", "column", min_devices=2),
    Route("sharded_solve", "solve", "solve", "column", min_devices=2),
    Route("tsqr_lstsq", "tsqr", "lstsq", "row", min_devices=2),
    Route("cholqr_lstsq", "cholqr2", "lstsq", "row", min_devices=2),
    # -- compressed wire rungs ---------------------------------------------
    Route("blocked_qr_wire_bf16", "householder", "qr", "column",
          comms="bf16", min_devices=2),
    Route("blocked_qr_wire_int8", "householder", "qr", "column",
          comms="int8", min_devices=2),
    Route("blocked_qr_agg_wire_bf16", "householder", "qr", "column",
          agg_panels=2, comms="bf16", min_devices=2),
    Route("blocked_qr_pipeline2_wire_bf16", "householder", "qr", "column",
          comms="bf16", lookahead=True, overlap_depth=2, min_devices=2),
    Route("unblocked_qr_wire_bf16", "householder", "qr", "column",
          comms="bf16", min_devices=2),
    Route("sharded_solve_wire_bf16", "solve", "solve", "column",
          comms="bf16", min_devices=2),
    Route("tsqr_lstsq_wire_bf16", "tsqr", "lstsq", "row", comms="bf16",
          min_devices=2),
    Route("tsqr_lstsq_wire_int8", "tsqr", "lstsq", "row", comms="int8",
          min_devices=2),
    Route("cholqr_lstsq_wire_bf16", "cholqr2", "lstsq", "row",
          comms="bf16", min_devices=2),
    # -- two-tier pod tier -------------------------------------------------
    Route("unblocked_qr_pod", "householder", "qr", "pod", min_devices=4),
    Route("blocked_qr_pod", "householder", "qr", "pod", min_devices=4,
          presets="accurate"),
    Route("sharded_solve_pod", "solve", "solve", "pod", min_devices=4),
    Route("tsqr_lstsq_pod", "tsqr", "lstsq", "pod", min_devices=4),
    Route("cholqr_lstsq_pod", "cholqr2", "lstsq", "pod", min_devices=4),
    Route("sharded_solve_pod_dcn_bf16", "solve", "solve", "pod",
          comms="dcn:bf16", min_devices=4),
    Route("tsqr_lstsq_pod_dcn_bf16", "tsqr", "lstsq", "pod",
          comms="dcn:bf16", min_devices=4),
    Route("lstsq_pod_dcn_bf16", "householder", "lstsq", "pod",
          comms="dcn:bf16", min_devices=4, presets="accurate"),
    Route("lstsq_pod_dcn_int8", "householder", "lstsq", "pod",
          comms="dcn:int8", min_devices=4, presets="accurate"),
)


# ---------------------------------------------------------------------------
# Queries


def routes() -> "tuple[Route, ...]":
    return ROUTES


def route(name: str) -> Route:
    for r in ROUTES:
        if r.name == name:
            return r
    raise KeyError(f"no registered route {name!r}")


def route_names() -> "set[str]":
    return {r.name for r in ROUTES}


def reachable(r: Route, devices: int = 1, preset: str = "accurate") -> bool:
    """Evaluate a route's reachability predicate for one context."""
    if devices < r.min_devices:
        return False
    if r.presets == "accurate" and preset != "accurate":
        return False
    return True


def jaxpr_routes(preset: str, devices: int = 1):
    """The JAX package's jaxpr-pass route query: not ported."""
    raise NotPortedError("tune.registry.jaxpr_routes", _HOOKS_ITEM)


def comms_routes(P: int, sweep: bool):
    """The JAX package's comms-audit route query: not ported."""
    raise NotPortedError("tune.registry.comms_routes", _HOOKS_ITEM)


def contract_names():
    """The JAX package's comms-contract names: not ported."""
    raise NotPortedError("tune.registry.contract_names", _HOOKS_ITEM)


def serve_routes():
    """The JAX package's serve-key probe routes: not ported."""
    raise NotPortedError("tune.registry.serve_routes", _HOOKS_ITEM)


def donated_routes():
    """The JAX package's donation-audit routes: not ported."""
    raise NotPortedError("tune.registry.donated_routes", _HOOKS_ITEM)


def grid_route_for(kind: str, plan: Plan, nproc: int = 1) -> "str | None":
    """Map one tune-grid candidate onto its registered route name, or None
    when the registry cannot express it. ``block_size`` /
    ``trailing_precision`` are not route-distinguishing (module
    docstring), so the map folds them. The JAX package's map."""
    serve = kind.startswith("serve_")
    if kind == "serve_sketch":
        # The sketched serving kind is its own program family: its one
        # grid candidate is the default plan, whose ENGINE does not route.
        return "batched_sketch"
    if plan.engine == "sketch":
        return "batched_sketch" if serve else "sketched_lstsq"
    if plan.engine == "tsqr":
        if plan.comms == "bf16":
            return "tsqr_lstsq_wire_bf16"
        if plan.comms == "dcn:bf16":
            return "tsqr_lstsq_pod_dcn_bf16"
        if plan.comms == "int8":
            return "tsqr_lstsq_wire_int8"
        if plan.comms is not None:
            return None
        return "tsqr_lstsq" if nproc > 1 else "tsqr_plan"
    if plan.engine == "cholqr2":
        if plan.comms == "bf16":
            return "cholqr_lstsq_wire_bf16"
        if plan.comms is not None:
            return None
        return "cholqr_lstsq" if nproc > 1 else "cholqr2_plan"
    if plan.engine != "householder":
        return None
    if serve:
        return "batched_qr" if kind == "serve_qr" else "batched_lstsq"
    if nproc > 1:
        if plan.comms == "dcn:bf16":
            return "lstsq_pod_dcn_bf16"
        if plan.comms == "dcn:int8":
            return "lstsq_pod_dcn_int8"
        if plan.comms == "bf16":
            if plan.overlap_depth:
                return ("blocked_qr_pipeline2_wire_bf16"
                        if plan.overlap_depth == 2 else None)
            return "blocked_qr_agg_wire_bf16" if plan.agg_panels \
                else "blocked_qr_wire_bf16"
        if plan.comms == "int8":
            return "blocked_qr_wire_int8"
        if plan.comms is not None:
            return None
        if plan.overlap_depth:
            return {2: "blocked_qr_pipeline2",
                    4: "blocked_qr_pipeline4"}.get(plan.overlap_depth)
        if plan.agg_panels and plan.lookahead:
            return "blocked_qr_agg_lookahead"
        if plan.agg_panels:
            return "blocked_qr_agg"
        if plan.lookahead:
            return "blocked_qr_lookahead"
        return "blocked_qr"
    if plan.comms is not None:
        return None
    if plan.panel_impl == "recursive":
        return "householder_recursive"
    if plan.panel_impl.startswith("reconstruct"):
        return "householder_reconstruct"
    return "householder_single"


# ---------------------------------------------------------------------------
# Bench stage catalogue (the BASELINE.md configurations)


@dataclasses.dataclass(frozen=True, eq=False)
class BenchStage:
    """One benchmark stage: the BASELINE.md config number, the metric name
    stem, the registered route the stage exercises, and the nominal
    problem shape."""

    config: int
    metric: str
    route: str
    m: int
    n: int
    kind: str                  # "qr" | "lstsq"
    engine: "str | None" = None
    layout: str = "block"


BENCH_STAGES: "tuple[BenchStage, ...]" = (
    BenchStage(1, "dense_qr", "householder_single", 1024, 1024, "qr"),
    BenchStage(2, "tall_skinny_lstsq", "tsqr_lstsq", 65536, 256, "lstsq",
               engine="tsqr"),
    BenchStage(3, "square_qr_f32", "blocked_qr_cyclic", 16384, 16384,
               "qr", layout="cyclic"),
    BenchStage(4, "blocked_wy_qr_f32", "householder_single", 32768, 4096,
               "qr"),
    BenchStage(5, "overdetermined_lstsq_f32", "lstsq_mesh", 131072, 512,
               "lstsq", engine="householder"),
)


def bench_stages() -> "tuple[BenchStage, ...]":
    return BENCH_STAGES


# ---------------------------------------------------------------------------
# Structural self-check


def self_check() -> "list[str]":
    """Registry-internal invariants (the JAX package's, less those of the
    analysis hooks): human-readable problem strings, empty when healthy."""
    problems = []
    names = [r.name for r in ROUTES]
    for name in sorted({n for n in names if names.count(n) > 1}):
        problems.append(f"duplicate route name {name!r}")
    known = set(names)
    for r in ROUTES:
        where = f"route {r.name!r}"
        if r.family not in _FAMILIES:
            problems.append(f"{where}: unknown family {r.family!r}")
        if r.schedule not in _SCHEDULES:
            problems.append(f"{where}: unknown schedule {r.schedule!r}")
        if r.comms is not None and r.comms not in COMMS_MODES:
            problems.append(f"{where}: unknown comms rung {r.comms!r}")
        if r.presets not in ("all", "accurate"):
            problems.append(f"{where}: unknown preset gate {r.presets!r}")
        if r.schedule == "pod" and r.min_devices < 4:
            problems.append(
                f"{where}: pod schedules need min_devices >= 4 "
                "(a 2x2 DCN x ICI factorization)")
        if r.schedule in ("column", "row", "pod") and r.min_devices < 2:
            problems.append(
                f"{where}: sharded schedules need min_devices >= 2")
        if r.overlap_depth:
            if r.overlap_depth < 2:
                problems.append(
                    f"{where}: overlap_depth must be >= 2 (depth 1 IS "
                    "the lookahead route) or 0")
            if not r.lookahead:
                problems.append(
                    f"{where}: pipeline routes require lookahead — the "
                    "ring generalizes the lookahead broadcast")
            if r.agg_panels:
                problems.append(
                    f"{where}: overlap_depth is mutually exclusive with "
                    "agg_panels (the aggregated schedule groups panels "
                    "its own way)")
    configs = [s.config for s in BENCH_STAGES]
    for c in sorted({c for c in configs if configs.count(c) > 1}):
        problems.append(f"duplicate bench stage config {c}")
    for s in BENCH_STAGES:
        if s.route not in known:
            problems.append(
                f"bench stage {s.config} names unregistered route "
                f"{s.route!r}")
        if s.m < s.n or s.n < 1:
            problems.append(f"bench stage {s.config}: bad shape "
                            f"{s.m}x{s.n}")
        if s.kind not in ("qr", "lstsq"):
            problems.append(f"bench stage {s.config}: unknown kind "
                            f"{s.kind!r}")
    return problems
