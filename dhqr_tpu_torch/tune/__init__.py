"""The autotuner of the port — ``dhqr_tpu.tune`` on the card's programs.

* :class:`Plan` — one executable configuration (``tune/plan.py``);
* :class:`PlanDB` — the persistent, versioned, corrupt-tolerant JSON plan
  database with last-write-wins merging, layered over the shipped
  ``default_plans.json`` (``tune/db.py``; the port's file ships no
  entries);
* :func:`tune` / :func:`resolve_plan` / :func:`candidate_plans` — the
  pruned timing search on the device and the ``plan="auto"`` lookup the
  public API threads through (``tune/search.py``);
* :mod:`dhqr_tpu_torch.tune.registry` — the route registry the grid maps
  onto, and the benchmark stages.

Entry points: ``qr(A, plan="auto")``, ``lstsq(A, b, plan="auto")``,
``serve.prewarm(..., plan="auto")``, the ``DHQR_TUNE_*`` variables
(:class:`dhqr_tpu_torch.utils.config.TuneConfig`). Keys name the program
measured: ``torch-cuda:...`` on the card, ``torch-cpu:...`` on the CPU.
"""

from dhqr_tpu_torch.tune.db import (
    PlanDB,
    SEED_PATH,
    default_db,
    plan_key,
    policy_tag,
    reset_default_db,
)
from dhqr_tpu_torch.tune.plan import DEFAULT_PLAN, PLAN_ENGINES, Plan
from dhqr_tpu_torch.tune.registry import (
    BenchStage,
    Route,
    SERVE_PROGRAM_KINDS,
    TUNE_KINDS,
    bench_stages,
    grid_route_for,
    route,
    route_names,
    routes,
)
from dhqr_tpu_torch.tune.search import (
    Measurement,
    PLAN_DEMOTE_AFTER,
    TuneResult,
    apply_plan_to_config,
    candidate_plans,
    note_gate_failure,
    plan_gate_stats,
    reset_gate_failures,
    resolve_plan,
    tune,
)

__all__ = [
    "Plan",
    "DEFAULT_PLAN",
    "PLAN_ENGINES",
    "PlanDB",
    "SEED_PATH",
    "default_db",
    "reset_default_db",
    "plan_key",
    "policy_tag",
    "candidate_plans",
    "apply_plan_to_config",
    "tune",
    "resolve_plan",
    "Measurement",
    "TuneResult",
    "PLAN_DEMOTE_AFTER",
    "note_gate_failure",
    "plan_gate_stats",
    "reset_gate_failures",
    "Route",
    "BenchStage",
    "routes",
    "route",
    "route_names",
    "bench_stages",
    "grid_route_for",
    "TUNE_KINDS",
    "SERVE_PROGRAM_KINDS",
]
