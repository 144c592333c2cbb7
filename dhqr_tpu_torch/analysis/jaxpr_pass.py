"""Pass 2 — the op-log sanitizer over the public entry points: the twin of
``dhqr_tpu/analysis/jaxpr_pass.py``.

The JAX pass traces every public entry point abstractly and walks the
closed jaxpr. The port runs eagerly, so this pass RUNS every entry point
the route registry names (``tune/registry.jaxpr_routes``) once per policy
preset at the JAX pass's tiny shapes, on seeded f32 inputs, under the op
log (:mod:`dhqr_tpu_torch.analysis.oplog`), and walks what it dispatched:

* **DHQR101** — no float64/complex128 op output from float32/complex64
  inputs: a promotion doubles memory traffic and on the card runs the
  slow FP64 path.
* **DHQR102** — no host sync (``.item()``'s ``_local_scalar_dense``, a
  syncing op such as ``nonzero``, a copy from the card to the CPU) in a
  route the JAX package traces as one program. The eager engines make
  some by design (a Python-level branch on a device value); each such
  site is suppressed in the port's ``analysis/lint_baseline.json``
  (``graph_suppressions``) with its reason.
* **DHQR103** — every collective runs on a process group of the mesh the
  entry point was given (the default WORLD group included: the pass's
  meshes sit on subgroups of their own), and a mesh-free route runs none.
* **DHQR104** — an entry point that raises under a preset.

The mesh routes run on 1-rank meshes (a process group of one rank in
this process: gloo on the CPU, NCCL on the card) — the JAX pass's
1-device mesh, and the same blind spot: the comms pass exists for it.
The pod routes need 4 ranks and are left to the comms pass, as the JAX
registry gates them on the device count.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

from dhqr_tpu_torch.analysis import oplog
from dhqr_tpu_torch.analysis.findings import Finding, apply_graph_suppressions
from dhqr_tpu_torch.analysis.oplog import iter_jaxprs, sub_jaxprs
from dhqr_tpu_torch.analysis._pending import by_design

#: This pass's rule-catalogue rows (rule IDs the JAX package's).
RULES = (
    ("DHQR101", "f64/c128 op output logged from f32/c64 inputs", "jaxpr"),
    ("DHQR102", "host sync inside a route the JAX package traces as one "
     "program", "jaxpr"),
    ("DHQR103", "collective on a process group outside the entry point's "
     "mesh", "jaxpr"),
    ("DHQR104", "entry point failed to run under a policy preset",
     "jaxpr"),
)

# The JAX pass's shapes: small enough to run in milliseconds, large enough
# to take the blocked/panelled paths (two 4-wide panels per 8 columns),
# and one tall-skinny case (m/n = 8) past the tuner's cholqr2/tsqr gates.
_M, _N, _NB = 16, 8, 4
_M_TALL, _N_TALL = 64, 8

#: JAX's process-wide CPU pin before a trace; the port picks its device
#: per call (ROADMAP "Not ported by design").
_ensure_cpu_backend = by_design(
    "jaxpr_pass", "_ensure_cpu_backend",
    "it pins JAX's process-wide platform to the CPU before a trace; "
    "the port picks its device per call")


def check_jaxpr(log, label: str, mesh_axes=()) -> "list[Finding]":
    """Sanitize one op log (an :class:`~oplog.OpLog` or a scope);
    ``label`` names the entry point in the findings (their path)."""
    findings = []
    mesh_axes = set(mesh_axes)
    seen = set()
    for scope in iter_jaxprs(log):
        for ev in scope.eqns:
            prim = ev.primitive
            promoted = [d for d in ev.out_dtypes if d in oplog.F64_DTYPES]
            if ev.kind == "op" and promoted and not any(
                    d in oplog.F64_DTYPES for d in ev.in_dtypes):
                snippet = f"{prim}->{promoted[0]}@{ev.where}"
                if snippet not in seen:
                    seen.add(snippet)
                    findings.append(Finding(
                        "DHQR101", label, 0,
                        f"{promoted[0]} output from f32 inputs (op "
                        f"'{ev.name}' in {ev.where}): double precision "
                        "doubles the traffic and takes the card's slow "
                        "FP64 path — find and remove the promotion",
                        snippet=snippet))
            if ev.sync:
                snippet = f"{ev.sync}@{ev.where}"
                if snippet not in seen:
                    seen.add(snippet)
                    findings.append(Finding(
                        "DHQR102", label, 0,
                        f"host sync '{ev.sync}' (op '{ev.name}') in "
                        f"{ev.where}: one round trip to the host per call "
                        "in a route the JAX package runs as one program, "
                        "and no CUDA graph can hold it",
                        snippet=snippet))
            if ev.kind == "collective":
                axes = set(ev.axes)
                if not axes or not axes <= mesh_axes:
                    snippet = f"{ev.family}[{ev.group}]"
                    if snippet not in seen:
                        seen.add(snippet)
                        findings.append(Finding(
                            "DHQR103", label, 0,
                            f"collective '{ev.family}' on process group "
                            f"{ev.group!r} (axes {sorted(axes) or 'none'})"
                            f" outside the mesh (mesh axes: "
                            f"{sorted(mesh_axes) or 'none'})",
                            snippet=snippet))
    return findings


@contextlib.contextmanager
def solo_meshes(device):
    """``(meshes, groups)`` for the mesh routes on one rank: a process
    group of this one process (gloo on the CPU, NCCL on the card) unless
    one of a single rank is up already, and a column and a row mesh, each
    on a subgroup of its own so that a collective on WORLD is foreign.
    ``groups`` maps each subgroup to its axis for the op log."""
    import torch.distributed as dist

    from dhqr_tpu_torch.parallel.mesh import column_mesh, row_mesh

    made = None
    if not dist.is_initialized():
        made = tempfile.mkdtemp(prefix="dhqr_oplog_")
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(made, "store"), 1),
            rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(
            "the jaxpr pass runs its mesh routes on one rank; this "
            f"process is one of {dist.get_world_size()} ranks")
    try:
        cg, rg = dist.new_group([0]), dist.new_group([0])
        yield ({"cols": column_mesh(cg, device), "rows": row_mesh(rg, device)},
               {cg: ("cols",), rg: ("rows",)})
    finally:
        if made is not None:
            dist.destroy_process_group()
            shutil.rmtree(made, ignore_errors=True)


def _inputs(device):
    """Fresh seeded f32 operands of the pass's shapes (a factor-only
    program factors its input in place, so every run gets its own)."""
    import numpy as np
    import torch

    from dhqr_tpu_torch.numeric.guards import checked_cholesky
    from dhqr_tpu_torch.ops import gemm

    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=device)

    At = t(_M_TALL, _N_TALL)
    G = gemm.matmul(At.mT, At, "highest")
    return {"A": t(_M, _N), "b": t(_M), "At": At, "bt": t(_M_TALL),
            "As": t(2, _M, _N), "bs": t(2, _M), "Ask": t(2, _M_TALL, _N_TALL),
            "bsk": t(2, _M_TALL), "G": G,
            "R": checked_cholesky(G).mT.contiguous(),
            "u": t(_M_TALL), "v": t(_N_TALL)}


def _builders(preset: str, pol, device=None, meshes=None):
    """The run mechanisms, keyed by the builder names the route registry's
    jaxpr specs cite (``tune/registry.py`` owns WHICH routes exist; this
    map owns only HOW to run each one). A builder returns a callable that
    runs the route once on the operands of :func:`_inputs` (made on
    ``device``, outside the op log); ``meshes`` holds the 1-rank meshes of
    :func:`solo_meshes` (a mesh builder without them raises, which the
    pass reports as DHQR104)."""
    import dhqr_tpu_torch as dt

    meshes = meshes or {}

    def mesh(axis):
        if axis not in meshes:
            raise RuntimeError(f"no {axis!r} mesh: the {axis} routes need "
                               "one (pod: 4 ranks, run by the comms pass)")
        return meshes[axis]

    def api_qr():
        return (lambda x: dt.qr(x["A"], policy=preset, device=device))

    def api_lstsq(tall=False):
        if tall:  # engine auto-selection on a tall problem, policy-free
            return (lambda x: dt.lstsq(x["At"], x["bt"], device=device))
        return (lambda x: dt.lstsq(x["A"], x["b"], policy=preset,
                                     device=device))

    def api_lstsq_plan(plan, tall=False):
        # alt-engine plans are policy-free (pruning rule 5); householder
        # plans sweep the preset like the rest of the tier
        kw = {"policy": preset} if plan.engine == "householder" else {}
        a, b = ("At", "bt") if tall else ("A", "b")
        return (lambda x: dt.lstsq(x[a], x[b], plan=plan, device=device,
                                     **kw))

    def tsqr_r():
        return (lambda x: dt.tsqr_r(x["A"], n_blocks=2, policy=preset,
                                      device=device))

    def cholesky_qr2():
        return (lambda x: dt.cholesky_qr2(x["A"], policy=preset,
                                            device=device))

    def bucket(kind):
        from dhqr_tpu_torch.serve.engine import bucket_program

        if kind == "sketch":
            return (lambda x: bucket_program("sketch", policy=preset)(
                x["Ask"], x["bsk"]))
        if kind == "qr":
            return (lambda x: bucket_program(
                "qr", block_size=_NB, policy=preset)(x["As"]))
        return (lambda x: bucket_program(
            "lstsq", block_size=_NB, policy=preset)(x["As"], x["bs"]))

    def async_bucket():
        # The async scheduler must dispatch the engine's own bucket
        # program: a scheduler that grew its own key or dispatch loop
        # fails here (DHQR104) before it costs steady-state recaptures.
        from dhqr_tpu_torch.serve import engine as _serve_engine
        from dhqr_tpu_torch.serve import scheduler as _serve_sched

        def run(x):
            shadowed = {"_plan_key", "_dispatch_groups", "bucket_program"} \
                & set(vars(_serve_sched))
            assert _serve_sched._engine is _serve_engine and not shadowed, (
                "async scheduler dispatch path diverged from serve.engine "
                f"(shadowed: {sorted(shadowed)}): one _plan_key and one "
                "_dispatch_groups are the zero-recapture contract")
            return _serve_sched.dispatch_program(
                "lstsq", block_size=_NB, policy=preset)(x["As"], x["bs"])

        return run

    def sketched():
        from dhqr_tpu_torch.solvers.sketch import sketched_lstsq

        return (lambda x: sketched_lstsq(x["At"], x["bt"], policy=preset,
                                           device=device))

    def upd_solve():
        from dhqr_tpu_torch.solvers.update import solve_program

        return (lambda x: solve_program(refine=max(1, pol.refine),
                                          precision=pol.panel)(
            x["At"], x["R"], x["bt"]))

    def upd_rank1():
        from dhqr_tpu_torch.solvers.update import update_program

        return (lambda x: update_program()(x["At"], x["G"], x["R"],
                                             x["u"], x["v"], 1.0))

    def sharded_blocked(pod=False):
        from dhqr_tpu_torch.parallel import sharded_blocked_qr

        if pod:  # preset-independent, traced once (registry-gated)
            return (lambda x: sharded_blocked_qr(x["A"], mesh("pod"),
                                                   block_size=_NB))
        return (lambda x: sharded_blocked_qr(
            x["A"], mesh("cols"), block_size=_NB, policy=preset))

    def sharded_unblocked():
        from dhqr_tpu_torch.parallel import sharded_householder_qr

        # the classic mesh engines take precision knobs, not a policy
        return (lambda x: sharded_householder_qr(
            x["A"], mesh("cols"), precision=pol.panel))

    def lstsq_mesh():
        return (lambda x: dt.lstsq(x["A"], x["b"], mesh=mesh("cols"),
                                     block_size=_NB, policy=preset))

    def lstsq_pod(mode):
        return (lambda x: dt.lstsq(x["A"], x["b"], mesh=mesh("pod"),
                                     block_size=_NB, comms=mode))

    def sharded_tsqr():
        from dhqr_tpu_torch.parallel import sharded_tsqr_lstsq

        return (lambda x: sharded_tsqr_lstsq(
            x["A"], x["b"], mesh("rows"), block_size=_NB,
            precision=pol.panel))

    def sharded_cholqr():
        from dhqr_tpu_torch.parallel import sharded_cholqr_lstsq

        return (lambda x: sharded_cholqr_lstsq(
            x["A"], x["b"], mesh("rows"), precision=pol.panel))

    return {
        "api_qr": api_qr,
        "api_lstsq": api_lstsq,
        "api_lstsq_plan": api_lstsq_plan,
        "tsqr_r": tsqr_r,
        "cholesky_qr2": cholesky_qr2,
        "bucket": bucket,
        "async_bucket": async_bucket,
        "sketched": sketched,
        "update_solve": upd_solve,
        "update_rank1": upd_rank1,
        "sharded_blocked": sharded_blocked,
        "sharded_unblocked": sharded_unblocked,
        "lstsq_mesh": lstsq_mesh,
        "lstsq_pod": lstsq_pod,
        "sharded_tsqr": sharded_tsqr,
        "sharded_cholqr": sharded_cholqr,
    }


def _unexpressible(route_name: str, builder: str):
    """A callable for a registry spec citing a builder this pass does not
    implement: it raises, so the drift is a DHQR104 finding, not a silent
    drop."""
    def run(_inputs):
        raise RuntimeError(
            f"route {route_name!r} cites jaxpr builder {builder!r} which "
            "analysis/jaxpr_pass implements no mechanism for: implement "
            "the builder or fix the registry spec (tune/registry.py)")
    return run


def _entry_points(preset: str, pol, device=None, meshes=None,
                  devices: int = 1):
    """``(label, run, mesh_axes)`` per registered jaxpr spec of ``preset``
    (``tune/registry.jaxpr_routes``)."""
    from dhqr_tpu_torch.tune.registry import jaxpr_routes

    builders = _builders(preset, pol, device, meshes)
    for route in jaxpr_routes(preset, devices=devices):
        for spec in route.jaxpr:
            spec = dict(spec)
            label = spec.pop("label").format(preset=preset)
            axes = spec.pop("axes", ())
            name = spec.pop("builder")
            build = builders.get(name)
            if build is None:
                yield (label, _unexpressible(route.name, name), axes)
                continue
            yield (label, build(**spec), axes)


def run_routes(presets=None, device=None):
    """Run every registered jaxpr route under every preset in
    ``presets`` (default: all) once under the op log on ``device`` (None:
    the card). Returns ``[(label, log or the exception, mesh_axes)]``."""
    from dhqr_tpu_torch.precision import PRECISION_POLICIES
    from dhqr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    names = list(presets) if presets is not None \
        else list(PRECISION_POLICIES)
    out = []
    with solo_meshes(dev) as (meshes, groups):
        for preset in names:
            pol = PRECISION_POLICIES[preset]
            for label, run, mesh_axes in _entry_points(preset, pol, dev,
                                                       meshes):
                x = _inputs(dev)
                try:
                    with oplog.record(label, groups=groups) as log:
                        run(x)
                # dhqr: ignore[DHQR006] an entry point that raises IS the finding (DHQR104): the caller reports it
                except Exception as e:
                    out.append((label, e, mesh_axes))
                    continue
                out.append((label, log, mesh_axes))
    return out


def run_jaxpr_pass(presets=None, device=None, runs=None) -> "list[Finding]":
    """Run and sanitize every entry point for every policy preset on
    ``device`` (None: the card; ``"cpu"`` runs the plain paths). ``runs``
    reuses :func:`run_routes`' result. Findings the eager engines make by
    design come back suppressed (``graph_suppressions``)."""
    findings = []
    for label, log, mesh_axes in (run_routes(presets, device)
                                  if runs is None else runs):
        if isinstance(log, Exception):
            findings.append(Finding(
                "DHQR104", label, 0,
                f"entry point failed to run: {type(log).__name__}: {log}"))
            continue
        findings.extend(check_jaxpr(log, label, mesh_axes))
    return apply_graph_suppressions(findings)
