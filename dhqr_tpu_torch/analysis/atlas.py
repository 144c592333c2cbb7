"""Pass 6 (dhqr-atlas) — the DHQR5xx cross-subsystem drift audit: the twin
of ``dhqr_tpu/analysis/atlas.py``.

The route registry (``tune/registry.py``) is the ONE enumeration of the
route space; the jaxpr pass, the comms audit, the tune grid, the serve
cache keys and the bench stages all iterate it. This pass proves the
consumers have not drifted from it:

* DHQR501 — route coverage: every registered route reachable by the
  audit ladder, every run spec resolvable against a pass's builder map,
  every logged label registered (two-way, via ``traced_labels``).
* DHQR502 — contract pricing: registry ``contract`` fields and
  ``comms_contracts.json`` rows are bijective; every row names a known
  cost model, known c10d families, and a wire rung some claiming route
  runs.
* DHQR503 — under-keyed caches: mint the serve CacheKey for every
  registered probe cell; any two cells colliding on one key must run the
  IDENTICAL program — compared on their op logs (on the card, the logs
  of their CUDA graph captures); the plan-DB twin (distinct grid
  candidates must not share a ``describe()`` tag) and the fleet twin (the
  canonical key spelling, ``serve.cache.canonical_key``, stays injective).
* DHQR504 — donation audit: ``donated`` routes and the DHQR304 probes
  (``comms_pass._donation_entries``) are bijective.
* DHQR505 — grid drift: every ``candidate_plans`` emission at a probe
  grid maps onto a registered route (``registry.grid_route_for``), and
  every bench stage names a registered route of the right kind.

Every check takes its enumerations as injectable arguments (tests seed
drifts without touching the committed registry) and returns plain
:class:`Finding` records. The committed tree holds ZERO findings.
"""

from __future__ import annotations

from dhqr_tpu_torch.analysis.findings import Finding
from dhqr_tpu_torch.tune import registry

RULES = (
    ("DHQR501",
     "registered route invisible to an analysis pass, or a logged "
     "label with no registered route", "atlas"),
    ("DHQR502",
     "comms contract row and registry route sets are not bijective, "
     "or a contract row is unpriceable", "atlas"),
    ("DHQR503",
     "under-keyed cache: distinct route cells collide on one cache "
     "key with different programs", "atlas"),
    ("DHQR504",
     "donated routes and DHQR304 donation probes have drifted apart",
     "atlas"),
    ("DHQR505",
     "tune-grid candidate or bench stage escapes the route registry",
     "atlas"),
)

#: (kind, m, n, nproc, topology, platform) probe grids DHQR503/505 run
#: ``candidate_plans`` over — the JAX package's shapes, its ``"tpu"`` grid
#: the port's ``"torch-cuda"`` one and its ``"cpu"`` grid ``"torch-cpu"``.
GRID_PROBES = (
    ("lstsq", 4096, 64, 1, None, "torch-cuda"),
    ("lstsq", 2048, 64, 4, None, "torch-cpu"),
    ("lstsq", 8192, 64, 4, (2, 2), "torch-cuda"),
    ("qr", 256, 128, 1, None, "torch-cuda"),
    ("qr", 512, 128, 4, None, "torch-cpu"),
    ("serve_lstsq", 64, 16, 1, None, "torch-cpu"),
    ("serve_qr", 64, 16, 1, None, "torch-cpu"),
    ("serve_sketch", 512, 8, 1, None, "torch-cpu"),
)

#: Request shapes DHQR503 mints serve keys at, per program kind: large
#: enough that the loop and recursive panel interiors run different
#: programs at the bucketed shape, so a dropped ``panel_impl`` key field
#: produces a collision this pass can convict.
SERVE_PROBE_SHAPES = {"lstsq": (256, 128), "qr": (256, 128),
                      "sketch": (512, 8)}


def _f(rule, path, message, snippet):
    return Finding(rule, path, 0, message, snippet=snippet)


# ---------------------------------------------------------------------------
# DHQR501 — registry structure + route coverage


def registry_findings() -> "list[Finding]":
    """The registry's own structural invariants, as gate findings."""
    return [_f("DHQR501", "atlas::registry", problem, snippet=problem)
            for problem in registry.self_check()]


def expected_jaxpr_labels(routes=None,
                          devices: int = 8) -> "set[str]":
    """Every run label the jaxpr pass owes the registry across the full
    preset sweep, at the audit ladder's widest mesh."""
    from dhqr_tpu_torch.precision import PRECISION_POLICIES

    out = set()
    for r in (registry.routes() if routes is None else routes):
        for spec in r.jaxpr:
            for preset in PRECISION_POLICIES:
                if r.presets == "accurate" and preset != "accurate":
                    continue
                if r.schedule == "pod" and devices < r.min_devices:
                    continue
                out.add(spec["label"].format(preset=preset))
    return out


def check_route_coverage(routes=None, jaxpr_builders=None,
                         comms_builders=None,
                         traced_labels=None) -> "list[Finding]":
    """DHQR501. Static coverage: every jaxpr/comms spec must name a
    builder its pass can resolve, and every route must sit inside the
    audit ladder's reach. ``traced_labels`` (when given: the labels the
    jaxpr pass actually logged, on a 1-rank mesh) is checked two-way
    against :func:`expected_jaxpr_labels` at one device."""
    findings = []
    routes = registry.routes() if routes is None else routes
    if jaxpr_builders is None or comms_builders is None:
        from dhqr_tpu_torch.analysis import comms_pass, jaxpr_pass
        from dhqr_tpu_torch.precision import PRECISION_POLICIES

        pol = PRECISION_POLICIES["accurate"]
        if jaxpr_builders is None:
            jaxpr_builders = set(jaxpr_pass._builders("accurate", pol))
        if comms_builders is None:
            comms_builders = set(
                comms_pass._comms_builders(2, "accurate", pol)[0])
    from dhqr_tpu_torch.analysis.comms_pass import DEFAULT_DEVICE_COUNTS

    ladder_max = max(DEFAULT_DEVICE_COUNTS)
    for r in routes:
        for spec in r.jaxpr:
            if spec["builder"] not in jaxpr_builders:
                findings.append(_f(
                    "DHQR501", "atlas::coverage",
                    f"route {r.name!r} jaxpr spec names builder "
                    f"{spec['builder']!r} the jaxpr pass has no "
                    "mechanism for — it would run as an "
                    "unexpressible-route DHQR104, so register the "
                    "builder or drop the spec",
                    snippet=f"{r.name}:jaxpr:{spec['builder']}"))
        if r.comms_trace is not None \
                and r.comms_trace["builder"] not in comms_builders:
            findings.append(_f(
                "DHQR501", "atlas::coverage",
                f"route {r.name!r} comms_trace names builder "
                f"{r.comms_trace['builder']!r} the comms audit has no "
                "mechanism for",
                snippet=f"{r.name}:comms:{r.comms_trace['builder']}"))
        if r.min_devices > ladder_max:
            findings.append(_f(
                "DHQR501", "atlas::coverage",
                f"route {r.name!r} needs {r.min_devices} ranks but "
                f"the audit ladder tops out at {ladder_max} "
                f"(comms_pass.DEFAULT_DEVICE_COUNTS) — the route would "
                "never run under any pass",
                snippet=f"{r.name}:min_devices"))
    if traced_labels is not None:
        traced = set(traced_labels)
        expected = expected_jaxpr_labels(routes, devices=1)
        for lab in sorted(traced - expected):
            findings.append(_f(
                "DHQR501", "atlas::coverage",
                f"jaxpr pass logged label {lab!r} that no registered "
                "route declares — a hand-enumerated route outside the "
                "registry; register it (tune/registry.py) so the grid, "
                "the serve keys and the contracts see it too",
                snippet=f"unregistered:{lab}"))
        for lab in sorted(expected - traced):
            findings.append(_f(
                "DHQR501", "atlas::coverage",
                f"registered label {lab!r} was never produced by the "
                "jaxpr pass — the route is registered but unaudited",
                snippet=f"untraced:{lab}"))
    return findings


# ---------------------------------------------------------------------------
# DHQR502 — contract pricing bijection


def check_contract_pricing(routes=None,
                           contracts=None) -> "list[Finding]":
    """DHQR502. A registry route naming a missing row ships unpriced
    collectives; a row no route claims is a dead contract. Rows must also
    be self-consistent: a known cost model, known c10d families, and a
    wire rung matching some claiming route."""
    from dhqr_tpu_torch.analysis.comms_pass import (COMMS_COLLECTIVES,
                                                    load_contracts)
    from dhqr_tpu_torch.analysis.cost_model import MODELS
    from dhqr_tpu_torch.precision import COMMS_MODES

    findings = []
    routes = registry.routes() if routes is None else routes
    contracts = load_contracts() if contracts is None else contracts
    claims = {}
    for r in routes:
        if not r.contract:
            continue
        claims.setdefault(r.contract, []).append(r)
        if r.contract not in contracts:
            findings.append(_f(
                "DHQR502", "atlas::contracts",
                f"route {r.name!r} prices its census against contract "
                f"{r.contract!r}, which is not a row of "
                "comms_contracts.json — the route's collectives ship "
                "unpriced",
                snippet=f"missing-row:{r.contract}"))
    for key, row in sorted(contracts.items()):
        if key not in claims:
            findings.append(_f(
                "DHQR502", "atlas::contracts",
                f"contract row {key!r} is claimed by no registered "
                "route — a dead budget; delete the row or register the "
                "route that should be held to it",
                snippet=f"dead-row:{key}"))
            continue
        model = row.get("model")
        if model not in MODELS:
            findings.append(_f(
                "DHQR502", "atlas::contracts",
                f"contract row {key!r} names unknown cost model "
                f"{model!r} (have {sorted(MODELS)})",
                snippet=f"model:{key}"))
        unknown = sorted(set(row.get("collectives", ()))
                         - set(COMMS_COLLECTIVES))
        if unknown:
            findings.append(_f(
                "DHQR502", "atlas::contracts",
                f"contract row {key!r} allows unknown collective "
                f"families {unknown} — the census would never match "
                "them, so the allowance is dead",
                snippet=f"collectives:{key}"))
        rung = row.get("comms")
        if rung is not None:
            if rung not in COMMS_MODES:
                findings.append(_f(
                    "DHQR502", "atlas::contracts",
                    f"contract row {key!r} names unknown wire rung "
                    f"{rung!r} (have {COMMS_MODES})",
                    snippet=f"rung:{key}"))
            elif not any(r.comms == rung for r in claims[key]):
                findings.append(_f(
                    "DHQR502", "atlas::contracts",
                    f"contract row {key!r} prices wire rung {rung!r} "
                    "but no claiming route runs that rung — the "
                    "compressed budget binds nothing",
                    snippet=f"rung-unclaimed:{key}"))
    return findings


# ---------------------------------------------------------------------------
# DHQR503 — under-keyed caches / recapture hazard


def _program_log(kind: str, overrides: dict, key, device):
    """The op log of one cell's bucket program at ``key``'s bucket: on
    the card the body of its CUDA graph capture (a
    ``serve.cache.LoweredProgram`` compiled under the log), on the CPU one
    eager run."""
    import torch

    from dhqr_tpu_torch.analysis import oplog
    from dhqr_tpu_torch.serve.cache import LoweredProgram
    from dhqr_tpu_torch.serve.engine import bucket_program

    fn = bucket_program(kind, **dict(overrides))

    def make_inputs():
        eye = torch.eye(key.m, key.n, dtype=torch.float32, device=device)
        A = eye.expand(key.batch, key.m, key.n).clone()
        if kind == "qr":
            return (A,)
        return A, torch.ones((key.batch, key.m), dtype=torch.float32,
                             device=device)

    with oplog.record(f"serve::{kind}") as log:
        if device.type == "cuda":
            LoweredProgram(fn, make_inputs, device).compile()
        else:
            fn(*make_inputs())
    if device.type == "cuda":
        captures = [s for s in oplog.iter_jaxprs(log) if s.name == "capture"]
        if len(captures) != 1:
            raise RuntimeError(f"{len(captures)} capture bodies in the log "
                               "of one compile")
        return captures[0]
    return log.root


def check_cache_keys(routes=None, key_fn=None, trace: bool = True,
                     device=None, stats: "dict | None" = None
                     ) -> "list[Finding]":
    """DHQR503. Serve side: mint the CacheKey of every registered probe
    cell through the ONE key mint (``serve.engine._plan_key``, or the
    injected ``key_fn`` twin a test plants); cells that collide on a key
    are run (``trace=True``) on ``device`` (None: the card) and convicted only if their
    op logs differ. Fleet side: ``canonical_key`` stays injective. Tune
    side: grid candidates keyed identically in the plan DB
    (``describe()``) must BE identical. ``stats`` receives the counts
    (cells, collided groups, events compared)."""
    from dhqr_tpu_torch.serve.engine import _plan_key, _resolve_serve_cfg
    from dhqr_tpu_torch.utils.config import ServeConfig
    from dhqr_tpu_torch.utils.device import resolve_device

    findings = []
    key_fn = _plan_key if key_fn is None else key_fn
    scfg = ServeConfig()
    cells = []
    route_list = (registry.serve_routes() if routes is None
                  else [r for r in routes if r.serve is not None])
    for r in route_list:
        kind = r.serve["kind"]
        m, n = SERVE_PROBE_SHAPES.get(kind, (256, 128))
        for overrides in r.serve["cells"]:
            try:
                cfg, _pol = _resolve_serve_cfg(None, dict(overrides))
                key, _bucket = key_fn(kind, 2, m, n, "float32", cfg,
                                      scfg)
            # dhqr: ignore[DHQR006] a cell that cannot mint its key IS the finding
            except Exception as e:
                findings.append(_f(
                    "DHQR503", "atlas::serve-keys",
                    f"route {r.name!r} serve cell {overrides!r} failed "
                    f"to mint a cache key: {type(e).__name__}: {e}",
                    snippet=f"mint:{r.name}"))
                continue
            cells.append((r.name, kind, overrides, key))
    groups = {}
    for name, kind, overrides, key in cells:
        groups.setdefault(key, []).append((name, kind, overrides))
    traced = events = 0
    for key, members in sorted(groups.items(),
                               key=lambda kv: repr(kv[0])):
        if len(members) < 2 or not trace:
            continue
        dev = resolve_device(device)
        programs = {}
        for name, kind, overrides in members:
            scope = _program_log(kind, overrides, key, dev)
            programs[name] = tuple(e.signature() for e in scope.events())
            events += len(programs[name])
        traced += 1
        if len(set(programs.values())) > 1:
            names = sorted(n for n, _, _ in members)
            findings.append(_f(
                "DHQR503", "atlas::serve-keys",
                f"cache key collision with distinct programs: route "
                f"cells {names} share one serve CacheKey but run "
                f"{len(set(programs.values()))} different op sequences "
                f"at bucket ({key.batch}, {key.m}, {key.n}) — the serve "
                "cache would recapture on every alternation; add the "
                "distinguishing config field to CacheKey/_plan_key",
                snippet="servekey:" + ",".join(names)))
    if stats is not None:
        stats.update(cells=len(cells), keys=len(groups),
                     collided_groups_run=traced, events_compared=events)
    # Fleet side: the key store addresses records by the CANONICAL
    # spelling of the CacheKey, which must stay injective.
    from dhqr_tpu_torch.serve.cache import canonical_key

    canon: dict = {}
    for name, kind, overrides, key in cells:
        try:
            spelled = canonical_key(key)
        # dhqr: ignore[DHQR006] a key that cannot be spelled IS the finding
        except Exception as e:
            findings.append(_f(
                "DHQR503", "atlas::fleet-keys",
                f"route {name!r} serve key {key!r} failed the canonical "
                f"spelling: {type(e).__name__}: {e} — the key store "
                "cannot address this cell",
                snippet=f"canon-mint:{name}"))
            continue
        prior = canon.setdefault(spelled, (name, key))
        if prior[1] != key:
            findings.append(_f(
                "DHQR503", "atlas::fleet-keys",
                f"canonical key collision: distinct CacheKeys for "
                f"route cells {sorted([prior[0], name])} both spell "
                f"{spelled!r} — a warm start would load the wrong "
                "record; add the distinguishing field to "
                "serve.cache.canonical_key",
                snippet=f"canon:{spelled}"))
    # Tune side: the plan DB keys measurements on Plan.describe().
    from dhqr_tpu_torch.tune.search import candidate_plans

    for kind, m, n, nproc, topology, platform in GRID_PROBES:
        seen = {}
        for plan in candidate_plans(kind, m, n, "float32", nproc=nproc,
                                    platform=platform, budget=10_000,
                                    topology=topology):
            tag = plan.describe()
            if tag in seen and seen[tag] != plan:
                findings.append(_f(
                    "DHQR503", "atlas::plan-keys",
                    f"two distinct grid candidates share describe() "
                    f"tag {tag!r} at kind={kind} ({m}x{n}, "
                    f"nproc={nproc}) — the plan DB would conflate "
                    "their measurements under one key",
                    snippet=f"plan:{kind}:{tag}"))
            seen.setdefault(tag, plan)
    return findings


# ---------------------------------------------------------------------------
# DHQR504 — donation audit


def check_donation_routes(routes=None,
                          entries=None) -> "list[Finding]":
    """DHQR504. Routes flagged ``donated`` carry the
    ``comms_pass._donation_entries`` label of their probe; the two sets
    must be bijective."""
    findings = []
    routes = registry.routes() if routes is None else routes
    declared = {r.donation: r.name for r in routes if r.donation}
    if entries is None:
        from dhqr_tpu_torch.analysis.comms_pass import _donation_entries

        probed = {label for label, _fn, _args in _donation_entries("cpu")}
    else:
        probed = set(entries)
    for label in sorted(set(declared) - probed):
        findings.append(_f(
            "DHQR504", "atlas::donation",
            f"route {declared[label]!r} declares donation entry "
            f"{label!r} but comms_pass._donation_entries has no such "
            "probe — the donated dispatch ships without its DHQR304 "
            "in-place audit",
            snippet=f"unprobed:{label}"))
    for label in sorted(probed - set(declared)):
        findings.append(_f(
            "DHQR504", "atlas::donation",
            f"donation probe {label!r} matches no registered route's "
            "donation field — DHQR304 audits an entry the registry "
            "does not know exists",
            snippet=f"unregistered:{label}"))
    return findings


# ---------------------------------------------------------------------------
# DHQR505 — grid / bench drift


def check_grid_drift(routes=None, probes=None,
                     stages=None) -> "list[Finding]":
    """DHQR505. Every ``candidate_plans`` emission over the probe grids
    must map onto a registered route via ``registry.grid_route_for``, and
    every bench stage must name a registered route of the right kind."""
    from dhqr_tpu_torch.tune.search import candidate_plans

    findings = []
    routes = registry.routes() if routes is None else routes
    known = {r.name: r for r in routes}
    for kind, m, n, nproc, topology, platform in (
            GRID_PROBES if probes is None else probes):
        for plan in candidate_plans(kind, m, n, "float32", nproc=nproc,
                                    platform=platform, budget=10_000,
                                    topology=topology):
            name = registry.grid_route_for(kind, plan, nproc=nproc)
            if name is None or name not in known:
                findings.append(_f(
                    "DHQR505", "atlas::grid",
                    f"grid candidate {plan.describe()!r} at kind="
                    f"{kind} ({m}x{n}, nproc={nproc}) maps to "
                    f"{'no route' if name is None else name!r} in the "
                    "registry — the tuner would measure an unaudited "
                    "route; register it or prune the emission",
                    snippet=f"grid:{kind}:{plan.describe()}"))
    for s in (registry.bench_stages() if stages is None else stages):
        r = known.get(s.route)
        if r is None:
            findings.append(_f(
                "DHQR505", "atlas::grid",
                f"bench stage {s.config} ({s.metric}) names "
                f"unregistered route {s.route!r}",
                snippet=f"stage:{s.config}:{s.route}"))
            continue
        if r.kind != s.kind:
            findings.append(_f(
                "DHQR505", "atlas::grid",
                f"bench stage {s.config} ({s.metric}) is a {s.kind} "
                f"benchmark but route {s.route!r} is registered as "
                f"kind {r.kind!r}",
                snippet=f"stage-kind:{s.config}:{s.route}"))
    return findings


# ---------------------------------------------------------------------------
# Orchestrator


def run_atlas_pass(trace: bool = True, device=None,
                   stats: "dict | None" = None) -> "list[Finding]":
    """All DHQR5xx checks with the committed enumerations; the collided
    serve cells run on ``device`` (None: the card, which compares their
    CUDA graph captures). ``trace=False`` skips those runs."""
    findings = registry_findings()
    findings.extend(check_route_coverage())
    findings.extend(check_contract_pricing())
    findings.extend(check_cache_keys(trace=trace, device=device,
                                     stats=stats))
    findings.extend(check_donation_routes())
    findings.extend(check_grid_drift())
    return findings
