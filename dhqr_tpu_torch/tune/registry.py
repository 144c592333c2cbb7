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

Each route also carries its analysis hooks (all declarative, as in the
JAX registry): ``jaxpr`` trace specs (the builders of
``analysis/jaxpr_pass``, which runs them under the op log), a
``comms_trace`` spec and the ``contract`` row of
``analysis/comms_contracts.json`` its collective census is priced
against, ``serve`` cache-key probe cells (DHQR503) and the ``donation``
probe of ``analysis/comms_pass._donation_entries`` (DHQR304 / DHQR504).
:func:`jaxpr_routes`, :func:`comms_routes`, :func:`contract_names`,
:func:`serve_routes` and :func:`donated_routes` are the passes' queries.

Not route-distinguishing by design: ``block_size`` (a ladder knob — the
same program schedule at every rung), ``trailing_precision`` (rule 4
pairs it with nothing else), and the serve batch.
"""

from __future__ import annotations

import dataclasses

from dhqr_tpu_torch.precision import COMMS_MODES, PrecisionPolicy
from dhqr_tpu_torch.tune.plan import PLAN_ENGINES, Plan

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


@dataclasses.dataclass(frozen=True, eq=False)
class Route:
    """One execution route. Identity per the atlas contract: (engine
    ``family``, ``panel_impl``, ``comms`` rung, ``schedule`` +
    ``layout``/``lookahead``/``agg_panels`` schedule levers,
    ``donated``/``batched`` dispatch mode).

    Per-subsystem hooks (all optional, all declarative):

    * ``jaxpr`` — tuple of run specs ``{"label": ..., "builder": ...,
      "axes": (...), **kwargs}`` the jaxpr pass runs under the op log.
    * ``contract`` + ``comms_trace`` — the comms-audit engine spec;
      ``contract`` names the ``comms_contracts.json`` row the logged
      census is priced against (DHQR502 keeps the two bijective).
    * ``serve`` — cache-key probe cells ``{"kind": ..., "cells":
      (overrides, ...)}`` DHQR503 mints CacheKeys for; any two cells
      (across all routes) colliding on one key must run identical
      programs. The nb-pinned twin cells exist so dropping a key field
      (the classic recompile-hazard edit) produces a collision whose
      programs genuinely differ at the probe bucket.
    * ``donation`` — the ``analysis/comms_pass._donation_entries`` label
      of the probe that runs this route's donated dispatch (DHQR304,
      DHQR504).
    """

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
    contract: "str | None" = None
    jaxpr: "tuple[dict, ...]" = ()
    comms_trace: "dict | None" = None
    serve: "dict | None" = None
    donation: "str | None" = None


_FAMILIES = tuple(PLAN_ENGINES) + ("update", "solve")
_SCHEDULES = ("single", "column", "row", "batched", "pod")


def _j(label, builder, axes=(), **kw):
    """One jaxpr trace spec (see Route.jaxpr)."""
    return dict(label=label, builder=builder, axes=tuple(axes), **kw)


ROUTES: "tuple[Route, ...]" = (
    # -- single-device API tier --------------------------------------------
    Route("householder_single", "householder", "qr", "single",
          jaxpr=(_j("qr[{preset}]", "api_qr"),
                 _j("lstsq[{preset}]", "api_lstsq"))),
    Route("householder_recursive", "householder", "lstsq", "single",
          panel_impl="recursive",
          jaxpr=(_j("lstsq_plan[{preset}]", "api_lstsq_plan",
                    plan=Plan(block_size=4, panel_impl="recursive")),)),
    # Round 21: the reconstruct panel interior gets its own trace — it
    # was a grid candidate (rule 3) with no jaxpr coverage before the
    # registry forced the question.
    Route("householder_reconstruct", "householder", "lstsq", "single",
          panel_impl="reconstruct", presets="accurate",
          jaxpr=(_j("lstsq_plan_reconstruct", "api_lstsq_plan",
                    plan=Plan(block_size=4, panel_impl="reconstruct")),)),
    Route("lstsq_auto_engine", "householder", "lstsq", "single",
          presets="accurate",
          jaxpr=(_j("lstsq_tall", "api_lstsq", tall=True),)),
    Route("tsqr_plan", "tsqr", "lstsq", "single", presets="accurate",
          jaxpr=(_j("lstsq_plan_tsqr", "api_lstsq_plan",
                    plan=Plan(engine="tsqr"), tall=True),)),
    Route("cholqr2_plan", "cholqr2", "lstsq", "single", presets="accurate",
          jaxpr=(_j("lstsq_plan_cholqr2", "api_lstsq_plan",
                    plan=Plan(engine="cholqr2"), tall=True),)),
    Route("tsqr_r_single", "tsqr", "qr", "single",
          jaxpr=(_j("tsqr_r[{preset}]", "tsqr_r"),)),
    Route("cholesky_qr2_single", "cholqr2", "qr", "single",
          jaxpr=(_j("cholesky_qr2[{preset}]", "cholesky_qr2"),)),
    Route("sketched_lstsq", "sketch", "lstsq", "single",
          jaxpr=(_j("sketched_lstsq[{preset}]", "sketched"),)),
    Route("update_solve", "update", "solve", "single",
          jaxpr=(_j("update_solve[{preset}]", "update_solve"),)),
    Route("update_rank1", "update", "update", "single",
          jaxpr=(_j("update_rank1[{preset}]", "update_rank1"),)),
    Route("blocked_qr_donate", "householder", "qr", "single", donated=True,
          donation="ops/blocked.blocked_householder_qr[donate]"),
    # -- serving tier (batched bucket programs) ----------------------------
    Route("batched_lstsq", "householder", "lstsq", "batched", batched=True,
          contract="batched_lstsq",
          jaxpr=(_j("batched_lstsq[{preset}]", "bucket", kind="lstsq"),),
          comms_trace=dict(builder="bucket_sharded", shape="batch",
                           sweep=True),
          serve=dict(kind="lstsq", cells=({}, {"block_size": 64}))),
    Route("batched_lstsq_recursive", "householder", "lstsq", "batched",
          panel_impl="recursive", batched=True,
          serve=dict(kind="lstsq",
                     cells=({"panel_impl": "recursive",
                             "block_size": 64},))),
    Route("batched_lstsq_wire_bf16", "householder", "lstsq", "batched",
          comms="bf16", batched=True, contract="batched_lstsq",
          comms_trace=dict(builder="bucket_sharded", shape="batch",
                           label="batched_lstsq_wire_bf16",
                           policy=PrecisionPolicy(comms="bf16")),
          # cfg.comms is deliberately NOT a serve key field (the bucket
          # programs launch zero collectives) — this cell must collide
          # with batched_lstsq's key AND trace to the identical program.
          serve=dict(kind="lstsq",
                     cells=({"policy": PrecisionPolicy(comms="bf16")},))),
    Route("batched_qr", "householder", "qr", "batched", donated=True,
          batched=True, donation="ops/blocked._batched_qr_impl",
          jaxpr=(_j("batched_qr[{preset}]", "bucket", kind="qr"),),
          serve=dict(kind="qr", cells=({}, {"block_size": 64}))),
    Route("batched_qr_recursive", "householder", "qr", "batched",
          panel_impl="recursive", donated=True, batched=True,
          serve=dict(kind="qr",
                     cells=({"panel_impl": "recursive",
                             "block_size": 64},))),
    Route("async_lstsq", "householder", "lstsq", "batched", batched=True,
          jaxpr=(_j("async_lstsq[{preset}]", "async_bucket"),)),
    Route("batched_sketch", "sketch", "lstsq", "batched", batched=True,
          jaxpr=(_j("batched_sketch[{preset}]", "bucket", kind="sketch"),),
          serve=dict(kind="sketch", cells=({},))),
    # -- sharded column tier -----------------------------------------------
    Route("unblocked_qr", "householder", "qr", "column", min_devices=2,
          contract="unblocked_qr",
          jaxpr=(_j("sharded_householder_qr[{preset}]", "sharded_unblocked",
                    axes=("cols",)),),
          comms_trace=dict(builder="unblocked", shape="col")),
    Route("blocked_qr", "householder", "qr", "column", min_devices=2,
          contract="blocked_qr",
          jaxpr=(_j("sharded_blocked_qr[{preset}]", "sharded_blocked",
                    axes=("cols",)),),
          comms_trace=dict(builder="blocked", shape="col", sweep=True)),
    Route("blocked_qr_cyclic", "householder", "qr", "column",
          layout="cyclic", min_devices=2, contract="blocked_qr_cyclic",
          comms_trace=dict(builder="blocked", shape="col", sweep=True,
                           layout="cyclic")),
    Route("blocked_qr_lookahead", "householder", "qr", "column",
          lookahead=True, min_devices=2, contract="blocked_qr_lookahead",
          comms_trace=dict(builder="blocked", shape="col", sweep=True,
                           lookahead=True)),
    # Round 23 (dhqr-pipeline): the depth-k double-buffered panel
    # broadcast — identical per-column arithmetic and launch count to
    # the lookahead schedule, with k panel broadcasts in flight ahead of
    # the trailing GEMM (the pf psum frames are up to depth*nb rows of R
    # taller; the blocked_qr slack absorbs that like it absorbs
    # lookahead's one-panel-taller frame).
    Route("blocked_qr_pipeline2", "householder", "qr", "column",
          lookahead=True, overlap_depth=2, min_devices=2,
          contract="blocked_qr_pipeline2",
          comms_trace=dict(builder="blocked", shape="col", sweep=True,
                           lookahead=True, overlap_depth=2)),
    Route("blocked_qr_pipeline4", "householder", "qr", "column",
          lookahead=True, overlap_depth=4, min_devices=2,
          contract="blocked_qr_pipeline4",
          comms_trace=dict(builder="blocked", shape="col", sweep=True,
                           lookahead=True, overlap_depth=4)),
    Route("blocked_qr_agg", "householder", "qr", "column", agg_panels=2,
          min_devices=2, contract="blocked_qr_agg",
          comms_trace=dict(builder="blocked", shape="col", sweep=True,
                           agg_panels=2)),
    Route("blocked_qr_agg_lookahead", "householder", "qr", "column",
          agg_panels=2, lookahead=True, min_devices=2,
          contract="blocked_qr_agg_lookahead",
          comms_trace=dict(builder="blocked", shape="col", sweep=True,
                           agg_panels=2, lookahead=True)),
    Route("lstsq_mesh", "householder", "lstsq", "column", min_devices=2,
          jaxpr=(_j("lstsq_mesh[{preset}]", "lstsq_mesh",
                    axes=("cols",)),)),
    Route("sharded_solve", "solve", "solve", "column", min_devices=2,
          contract="sharded_solve",
          comms_trace=dict(builder="solve", shape="col")),
    Route("tsqr_lstsq", "tsqr", "lstsq", "row", min_devices=2,
          contract="tsqr_lstsq",
          jaxpr=(_j("sharded_tsqr_lstsq[{preset}]", "sharded_tsqr",
                    axes=("rows",)),),
          comms_trace=dict(builder="tsqr", shape="row")),
    Route("cholqr_lstsq", "cholqr2", "lstsq", "row", min_devices=2,
          contract="cholqr_lstsq",
          jaxpr=(_j("sharded_cholqr_lstsq[{preset}]", "sharded_cholqr",
                    axes=("rows",)),),
          comms_trace=dict(builder="cholqr", shape="row")),
    # -- compressed wire rungs (dhqr-wire, round 18) -----------------------
    Route("blocked_qr_wire_bf16", "householder", "qr", "column",
          comms="bf16", min_devices=2, contract="blocked_qr_wire_bf16",
          comms_trace=dict(builder="blocked", shape="col", comms="bf16")),
    Route("blocked_qr_wire_int8", "householder", "qr", "column",
          comms="int8", min_devices=2, contract="blocked_qr_wire_int8",
          comms_trace=dict(builder="blocked", shape="col", comms="int8")),
    Route("blocked_qr_agg_wire_bf16", "householder", "qr", "column",
          agg_panels=2, comms="bf16", min_devices=2,
          contract="blocked_qr_agg_wire_bf16",
          comms_trace=dict(builder="blocked", shape="col", agg_panels=2,
                           comms="bf16")),
    # Round 23: the pipeline ring runs THROUGH the round-18 wire seam —
    # one traced rung proves compressed broadcasts pipeline too (the
    # contract's slack is widened to absorb the ring's taller psum
    # frames on top of the bf16 wire budget; see comms_contracts.json).
    Route("blocked_qr_pipeline2_wire_bf16", "householder", "qr", "column",
          comms="bf16", lookahead=True, overlap_depth=2, min_devices=2,
          contract="blocked_qr_pipeline2_wire_bf16",
          comms_trace=dict(builder="blocked", shape="col", comms="bf16",
                           lookahead=True, overlap_depth=2)),
    Route("unblocked_qr_wire_bf16", "householder", "qr", "column",
          comms="bf16", min_devices=2, contract="unblocked_qr_wire_bf16",
          comms_trace=dict(builder="unblocked", shape="col", comms="bf16")),
    Route("sharded_solve_wire_bf16", "solve", "solve", "column",
          comms="bf16", min_devices=2, contract="sharded_solve_wire_bf16",
          comms_trace=dict(builder="solve", shape="col", comms="bf16")),
    Route("tsqr_lstsq_wire_bf16", "tsqr", "lstsq", "row", comms="bf16",
          min_devices=2, contract="tsqr_lstsq_wire_bf16",
          comms_trace=dict(builder="tsqr", shape="row", comms="bf16")),
    Route("tsqr_lstsq_wire_int8", "tsqr", "lstsq", "row", comms="int8",
          min_devices=2, contract="tsqr_lstsq_wire_int8",
          comms_trace=dict(builder="tsqr", shape="row", comms="int8")),
    Route("cholqr_lstsq_wire_bf16", "cholqr2", "lstsq", "row",
          comms="bf16", min_devices=2, contract="cholqr_lstsq_wire_bf16",
          comms_trace=dict(builder="cholqr", shape="row", comms="bf16")),
    # -- two-tier pod tier (dhqr-pod, round 20) ----------------------------
    Route("unblocked_qr_pod", "householder", "qr", "pod", min_devices=4,
          contract="unblocked_qr_pod",
          comms_trace=dict(builder="unblocked", shape="col", pod=True)),
    Route("blocked_qr_pod", "householder", "qr", "pod", min_devices=4,
          presets="accurate", contract="blocked_qr_pod",
          jaxpr=(_j("sharded_blocked_qr_pod", "sharded_blocked",
                    axes=("dcn", "ici"), pod=True),),
          comms_trace=dict(builder="blocked", shape="col", pod=True)),
    Route("sharded_solve_pod", "solve", "solve", "pod", min_devices=4,
          contract="sharded_solve_pod",
          comms_trace=dict(builder="solve", shape="col", pod=True)),
    Route("tsqr_lstsq_pod", "tsqr", "lstsq", "pod", min_devices=4,
          contract="tsqr_lstsq_pod",
          comms_trace=dict(builder="tsqr", shape="row", pod=True)),
    Route("cholqr_lstsq_pod", "cholqr2", "lstsq", "pod", min_devices=4,
          contract="cholqr_lstsq_pod",
          comms_trace=dict(builder="cholqr", shape="row", pod=True)),
    Route("sharded_solve_pod_dcn_bf16", "solve", "solve", "pod",
          comms="dcn:bf16", min_devices=4,
          contract="sharded_solve_pod_dcn_bf16",
          comms_trace=dict(builder="solve", shape="col", pod=True,
                           comms="dcn:bf16")),
    Route("tsqr_lstsq_pod_dcn_bf16", "tsqr", "lstsq", "pod",
          comms="dcn:bf16", min_devices=4,
          contract="tsqr_lstsq_pod_dcn_bf16",
          comms_trace=dict(builder="tsqr", shape="row", pod=True,
                           comms="dcn:bf16")),
    Route("lstsq_pod_dcn_bf16", "householder", "lstsq", "pod",
          comms="dcn:bf16", min_devices=4, presets="accurate",
          jaxpr=(_j("lstsq_pod[dcn:bf16]", "lstsq_pod",
                    axes=("dcn", "ici"), mode="dcn:bf16"),)),
    Route("lstsq_pod_dcn_int8", "householder", "lstsq", "pod",
          comms="dcn:int8", min_devices=4, presets="accurate",
          jaxpr=(_j("lstsq_pod[dcn:int8]", "lstsq_pod",
                    axes=("dcn", "ici"), mode="dcn:int8"),)),
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


def jaxpr_routes(preset: str, devices: int = 1) -> "list[Route]":
    """Routes the jaxpr pass runs under ``preset`` with ``devices`` ranks.
    The mesh engines run on a 1-rank mesh there (that blind spot is the
    comms pass's reason to exist), so only the pod routes — which need a
    real 2x2 factorization — carry a device floor for this pass."""
    out = []
    for r in ROUTES:
        if not r.jaxpr:
            continue
        if r.presets == "accurate" and preset != "accurate":
            continue
        if r.schedule == "pod" and devices < r.min_devices:
            continue
        out.append(r)
    return out


def comms_routes(P: int, sweep: bool) -> "list[Route]":
    """Routes the comms audit runs at mesh size ``P``; ``sweep`` selects
    the preset-parameterized half of the matrix (see the comms pass's
    module docstring)."""
    out = []
    for r in ROUTES:
        spec = r.comms_trace
        if spec is None or bool(spec.get("sweep")) != sweep:
            continue
        if P < r.min_devices:
            continue
        out.append(r)
    return out


def contract_names() -> "set[str]":
    """Every comms_contracts.json row some registered route prices its
    census against — DHQR502 requires this to equal the committed file's
    row set exactly."""
    return {r.contract for r in ROUTES if r.contract}


def serve_routes() -> "list[Route]":
    return [r for r in ROUTES if r.serve is not None]


def donated_routes() -> "list[Route]":
    return [r for r in ROUTES if r.donated]


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
    """Registry-internal invariants (the JAX package's): human-readable
    problem strings, empty when healthy. The atlas pass turns them into
    DHQR501 findings and the dry run's atlas stage asserts on them."""
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
        if r.comms_trace is not None and not r.contract:
            problems.append(
                f"{where}: comms-traced routes must name a contract")
        if r.contract and r.comms_trace is None:
            problems.append(
                f"{where}: names contract {r.contract!r} but carries no "
                "comms_trace spec to price it with")
        for spec in r.jaxpr:
            if "label" not in spec or "builder" not in spec:
                problems.append(
                    f"{where}: jaxpr spec needs 'label' and 'builder'")
        if r.serve is not None:
            if r.serve.get("kind") not in SERVE_PROGRAM_KINDS:
                problems.append(
                    f"{where}: serve cell kind must be one of "
                    f"{SERVE_PROGRAM_KINDS}")
            if not r.serve.get("cells"):
                problems.append(
                    f"{where}: serve spec needs at least one probe cell")
        if r.donated and not (r.donation or r.serve):
            problems.append(
                f"{where}: donated routes must name their donation entry")
        # Every route must be auditable by SOMETHING — a record no pass
        # consumes is exactly the unaudited-route drift the atlas exists
        # to prevent (DHQR501 reports these through the lint gate too).
        if not (r.jaxpr or r.comms_trace or r.serve or r.donation):
            problems.append(
                f"{where}: no audit surface (jaxpr, comms_trace, serve "
                "or donation)")
    labels = [spec["label"] for r in ROUTES for spec in r.jaxpr]
    for lab in sorted({l for l in labels if labels.count(l) > 1}):
        problems.append(f"duplicate jaxpr trace label {lab!r}")
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
