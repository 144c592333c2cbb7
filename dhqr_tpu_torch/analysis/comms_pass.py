"""Pass 3 (dhqr-audit) — the multi-rank communication-contract analyzer:
the twin of ``dhqr_tpu/analysis/comms_pass.py``.

The jaxpr pass runs the mesh engines on a 1-rank mesh, which is exactly
where a collective-shaped regression is invisible: an accidental gather
of the trailing matrix, a collective on the wrong process group, a
donation that silently stopped writing in place. This pass runs every
mesh route of the registry (``tune/registry.comms_routes``) on P ranks
(P in {2, 4, 8} by default: :func:`~dhqr_tpu_torch.parallel._ranks.
run_ranks`, one spawn per P that runs every route inside the ranks),
records each rank's op log (:mod:`~dhqr_tpu_torch.analysis.oplog`) and
takes its collective census: per c10d collective its family, its payload
bytes (the bytes of its tensors; of the gathered result for a gather —
the JAX census's output-aval convention) and its axes (the tier of the
process group it ran on). Per-engine **comms contracts**
(``comms_contracts.json``, committed; its families in the port's c10d
names through its ``family_map``) pin what decides distributed
dense-linear-algebra performance — collective choice and volume
(arXiv:2112.09017, arXiv:2112.01075):

* **DHQR301** — a collective family the engine's contract does not allow.
* **DHQR302** — logged collective volume exceeds the analytic budget
  (:mod:`dhqr_tpu_torch.analysis.cost_model`) by more than the
  contract's slack (with a per-tier cross-DCN column on the pod
  contracts), on the busiest rank.
* **DHQR303** — an op output inside a shard body (the scope the mesh
  engines' ``observed_dispatch`` seam opens) larger than the contract's
  multiple of the per-shard input working set (the route's inputs over
  P): a replicated/gathered blow-up the mesh exists to avoid.
* **DHQR304** — a donated route whose output does not share its input's
  storage, or whose log allocates a fresh tensor of the input's size
  (:func:`input_output_aliases` reads the storage pointers).
* **DHQR305** — two runs of one cache key (shape, dtype, P, policy)
  whose op logs differ: the eager twin of a recompile per request.

A collective outside the mesh's process groups is DHQR103 here too (each
rank's meshes sit on subgroups of their own, so WORLD is foreign). The
engines' output relayout (``wire_all_gather(relayout=True)``, the JAX
package's output sharding, which its program does not contain) is filed
apart by the op log and left out of the census. The preset sweep runs at
the smallest P (presets change precision attributes, not the comms
structure).
"""

from __future__ import annotations

import dataclasses
import json
import os

from dhqr_tpu_torch.analysis import oplog
from dhqr_tpu_torch.analysis.cost_model import budget_bytes, tiered_budget_bytes
from dhqr_tpu_torch.analysis.findings import Finding, apply_graph_suppressions
from dhqr_tpu_torch.analysis.oplog import iter_jaxprs

#: The mesh axis name of the slow tier of a two-tier pod mesh
#: (``parallel/topology.DCN_AXIS``): a collective on a group of that tier
#: crosses hosts.
DCN_AXIS = "dcn"

DEFAULT_DEVICE_COUNTS = (2, 4, 8)

#: Data-moving c10d collectives, by family (the c10d op's name). A barrier
#: moves no words and is not in the census.
COMMS_COLLECTIVES = (
    "allreduce_", "allreduce_coalesced_", "broadcast_", "allgather_",
    "_allgather_base_", "allgather_into_tensor_coalesced_",
    "allgather_coalesced_", "reduce_", "reduce_scatter_",
    "_reduce_scatter_base_", "reduce_scatter_tensor_coalesced_",
    "alltoall_", "alltoall_base_", "gather_", "scatter_", "send", "recv_",
)

CONTRACTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "comms_contracts.json")

#: This pass's rule-catalogue rows (rule IDs the JAX package's).
RULES = (
    ("DHQR301", "collective family outside the engine's comms contract",
     "comms"),
    ("DHQR302", "logged collective volume exceeds the analytic budget "
     "(per-tier cross-DCN column on *_pod contracts)", "comms"),
    ("DHQR303", "shard-body op output exceeds the per-shard working set",
     "comms"),
    ("DHQR304", "donated route does not write in place", "comms"),
    ("DHQR305", "op log differs across two runs of one cache key",
     "comms"),
)

#: Ops whose output's last dimension is a GEMM's width (issue_order).
_DOTS = ("mm", "bmm", "addmm", "addmm_", "baddbmm", "baddbmm_")


# ---------------------------------------------------------------------------
# Collective census over an op log


@dataclasses.dataclass(frozen=True)
class CollectiveUse:
    """One collective: ``prim`` its family, ``launches`` its launch count,
    ``payload_bytes`` the bytes of ONE launch, ``axes`` the tier names of
    its process group. (An eager program has no loop of unknown trip
    count, so the JAX record's ``bounded`` flag has no counterpart.)"""

    prim: str
    launches: int
    payload_bytes: int
    axes: "tuple[str, ...]" = ()

    @property
    def volume_bytes(self) -> int:
        return self.launches * self.payload_bytes

    @property
    def crosses_dcn(self) -> bool:
        return DCN_AXIS in self.axes


@dataclasses.dataclass
class BodyStats:
    """One shard body: the per-shard input bytes vs the largest op output
    inside it."""

    input_bytes: int
    max_aval_bytes: int
    max_aval_desc: str


@dataclasses.dataclass
class CommsStats:
    """Census of one logged entry point (on one rank)."""

    uses: "list[CollectiveUse]" = dataclasses.field(default_factory=list)
    bodies: "list[BodyStats]" = dataclasses.field(default_factory=list)

    def launches(self) -> "dict[str, int]":
        out: "dict[str, int]" = {}
        for u in self.uses:
            out[u.prim] = out.get(u.prim, 0) + u.launches
        return out

    def volume(self) -> "dict[str, int]":
        out: "dict[str, int]" = {}
        for u in self.uses:
            out[u.prim] = out.get(u.prim, 0) + u.volume_bytes
        return out

    def total_volume_bytes(self) -> int:
        return sum(u.volume_bytes for u in self.uses)

    def dcn_volume_bytes(self) -> int:
        """Logged bytes that cross the DCN tier: the volume of every
        collective on a group of that tier (zero on a 1-D mesh)."""
        return sum(u.volume_bytes for u in self.uses if u.crosses_dcn)

    def families(self) -> "set[str]":
        return {u.prim for u in self.uses}


def merge_ranks(per_rank: "list[CommsStats]") -> CommsStats:
    """One census for a route run on several ranks: the families of all
    of them, the collectives of the busiest rank (the most bytes; an SPMD
    program's every device in the JAX census), every rank's bodies."""
    busiest = max(per_rank, key=lambda s: s.total_volume_bytes())
    out = CommsStats(uses=list(busiest.uses))
    seen = busiest.families()
    for s in per_rank:
        out.uses += [dataclasses.replace(u, launches=0)
                     for u in s.uses if u.prim not in seen]
        seen |= s.families()
        out.bodies += s.bodies
    return out


def collect_comms(log) -> CommsStats:
    """Walk an op log (and its scopes) collecting the collective census.
    The relayout scope's collectives are left out; a shard body (a scope
    named ``shard:...``) records its input bytes and its largest op output
    (DHQR303 material)."""
    stats = CommsStats()

    def walk(scope, body, relayout):
        for e in scope.entries:
            if isinstance(e, oplog.Scope):
                if e.name.startswith("shard:"):
                    nb = BodyStats(e.input_bytes, 0, "")
                    stats.bodies.append(nb)
                    walk(e, nb, relayout)
                else:
                    walk(e, body, relayout or e.name == "relayout")
                continue
            if body is not None and e.out_bytes > body.max_aval_bytes:
                body.max_aval_bytes = e.out_bytes
                body.max_aval_desc = (f"{e.primitive} -> "
                                      f"{list(e.out_shapes)} {e.out_dtypes}")
            if e.kind == "collective" and e.family in COMMS_COLLECTIVES \
                    and not relayout:
                stats.uses.append(CollectiveUse(e.family, 1, e.payload_bytes,
                                                axes=tuple(e.axes)))

    for root in oplog.sub_jaxprs(log):
        walk(root, None, False)
    return stats


def issue_order(log, nb: int) -> "list[str]":
    """Issue-order event stream of one logged engine: ``"broadcast"`` per
    broadcast, ``"psum"`` per sum, the family for other collectives,
    ``"panel"`` per panel-kernel launch and ``"wide_dot"`` per GEMM whose
    output is wider than the panel width ``nb`` (the trailing updates;
    panel-interior and narrow lookahead-apply GEMMs are at most ``nb``
    wide). Scopes are inlined where they were issued; the relayout is
    left out. An asynchronous broadcast is logged when it is issued, so
    the stream is the order the engine hands work to the card."""
    events: "list[str]" = []
    for scope in oplog.sub_jaxprs(log):
        for e in _events_outside_relayout(scope):
            if e.kind == "collective":
                events.append({"broadcast_": "broadcast",
                               "allreduce_": "psum"}.get(e.family, e.family))
            elif e.kind == "kernel":
                events.append("panel")
            elif e.primitive in _DOTS and e.out_shapes \
                    and e.out_shapes[0] and int(e.out_shapes[0][-1]) > nb:
                events.append("wide_dot")
    return events


def _events_outside_relayout(scope):
    for e in scope.entries:
        if isinstance(e, oplog.Scope):
            if e.name != "relayout":
                yield from _events_outside_relayout(e)
        else:
            yield e


def overlap_distance(log, nb: int) -> "int | None":
    """Measured broadcast-ahead distance of a logged blocked-QR schedule:
    for the j-th trailing-update GEMM, count the panel broadcasts already
    issued before it (ONE per panel here — the port packs the panel and
    its alpha into one broadcast, where the JAX engine launches a pair of
    one-hot psums); the panel being trailed is panel j, so ``broadcasts -
    (j + 1)`` is how many panels past it were already on the wire. The
    minimum over the trailing GEMMs is the schedule's overlap depth: 0
    for the classic schedule, 1 for the lookahead, k for the depth-k
    pipeline. None when the log holds no GEMM wider than ``nb``. ``log``
    may also be an issue-order stream already taken (a list)."""
    events = log if isinstance(log, list) else issue_order(log, nb)
    bcasts, dist, j, in_group = 0, None, 0, False
    for ev in events:
        if ev == "broadcast":
            bcasts += 1
            in_group = False
        elif ev == "wide_dot":
            # one trailing update is several consecutive wide GEMMs (W^H C,
            # T @ _, W @ _): date the group by its first one
            if not in_group:
                d = bcasts - (j + 1)
                dist = d if dist is None else min(dist, d)
                j += 1
            in_group = True
    return dist


# ---------------------------------------------------------------------------
# Contracts


def load_contracts(path: "str | None" = None) -> dict:
    """The committed per-engine comms contracts
    (``analysis/comms_contracts.json`` by default)."""
    with open(path or CONTRACTS_PATH, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return data["engines"]


def family_map(path: "str | None" = None) -> "dict[str, list[str]]":
    """The JAX collective primitive -> the port's c10d families it became
    (the contracts file's ``family_map``)."""
    with open(path or CONTRACTS_PATH, "r", encoding="utf-8") as fh:
        return json.load(fh)["family_map"]


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """The engine-shape key the analytic budget is evaluated at;
    ``topology`` is ``(dcn_size, ici_size)`` of a pod mesh (per-tier
    budgets) or None for a 1-D mesh."""

    m: int
    n: int
    nb: int
    P: int
    itemsize: int = 4
    nrhs: int = 1
    topology: "tuple[int, int] | None" = None


def check_comms(log, label: str, contract: dict,
                params: EngineParams) -> "list[Finding]":
    """DHQR301/302/303 for one logged engine (an op log, or its
    :class:`CommsStats`) against its contract."""
    stats = log if isinstance(log, CommsStats) else collect_comms(log)
    findings = []
    allowed = set(contract.get("collectives", ()))
    for prim in sorted(stats.families() - allowed):
        findings.append(Finding(
            "DHQR301", label, 0,
            f"collective family '{prim}' is not in the engine's comms "
            f"contract (allowed: {sorted(allowed) or 'none'}): a new "
            "collective in a pinned-communication engine is a scaling "
            "regression until the contract is re-derived",
            snippet=prim,
        ))
    comms = contract.get("comms")
    slack = float(contract.get("slack", 1.5))
    if params.topology is not None:
        tiered = tiered_budget_bytes(
            contract["model"], params.m, params.n, params.nb, params.P,
            params.itemsize, nrhs=params.nrhs, comms=comms,
            topology=params.topology,
            hierarchical=bool(contract.get("hierarchical", True)))
        budget = tiered["total"]
    else:
        tiered = None
        budget = budget_bytes(contract["model"], params.m, params.n,
                              params.nb, params.P, params.itemsize,
                              nrhs=params.nrhs, comms=comms)
    traced = stats.total_volume_bytes()
    if traced > budget * slack:
        wire = f", wire={comms}" if comms else ""
        findings.append(Finding(
            "DHQR302", label, 0,
            f"logged collective volume {traced} B exceeds the analytic "
            f"budget {budget} B (model '{contract['model']}' at m="
            f"{params.m}, n={params.n}, nb={params.nb}, P={params.P}"
            f"{wire}) x slack {slack}: the engine moves more "
            + ("bytes than its compressed wire format is contracted to "
               "— the claimed volume reduction regressed"
               if comms else
               "words than its communication pattern is contracted to"),
            snippet="volume",
        ))
    if tiered is not None:
        dcn_slack = float(contract.get("dcn_slack", slack))
        dcn_traced = stats.dcn_volume_bytes()
        if dcn_traced > tiered["dcn"] * dcn_slack:
            findings.append(Finding(
                "DHQR302", label, 0,
                f"logged cross-DCN volume {dcn_traced} B exceeds the "
                f"tier budget {tiered['dcn']} B (model "
                f"'{contract['model']}', topology "
                f"{params.topology[0]}x{params.topology[1]}"
                + (f", wire={comms}" if comms else "")
                + f") x slack {dcn_slack}: the hierarchical schedule "
                "stopped isolating the slow tier",
                snippet="dcn-volume",
            ))
    factor = float(contract.get("replicated_factor", 1.75))
    for body in stats.bodies:
        if body.input_bytes and body.max_aval_bytes > factor * body.input_bytes:
            findings.append(Finding(
                "DHQR303", label, 0,
                f"op output of {body.max_aval_bytes} B inside a shard body "
                f"({body.max_aval_desc}) exceeds {factor}x the per-shard "
                f"input working set ({body.input_bytes} B): a "
                "replicated/gathered blow-up — the memory the mesh exists "
                "to shard",
                snippet=f"aval:{body.max_aval_desc.split(' -> ')[0]}",
            ))
    return findings


# ---------------------------------------------------------------------------
# DHQR304 — donation: the output is the input's storage


def input_output_aliases(out, args) -> "list[tuple[int, str]]":
    """``(argument index, "must-alias")`` for every tensor argument whose
    storage an output tensor of ``out`` shares (the donation contract: a
    donated route writes its result in its input's storage)."""
    outs = {t.untyped_storage().data_ptr() for t in oplog._flat(out, [])}
    return [(i, "must-alias") for i, a in enumerate(args)
            if hasattr(a, "untyped_storage")
            and a.untyped_storage().data_ptr() in outs]


def _donation_entries(device=None):
    """The port's donated dispatch units on fresh seeded inputs of the
    JAX probes' shapes: ``(label, fn, args)``, the output of each being
    its argument 0 by construction."""
    import numpy as np
    import torch

    from dhqr_tpu_torch.ops.blocked import (
        _batched_qr_impl,
        blocked_householder_qr,
    )
    from dhqr_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=device)

    yield ("ops/blocked.blocked_householder_qr[donate]",
           lambda A, nb: blocked_householder_qr(A, nb, donate=True,
                                                device=A.device),
           (t(16, 8), 4))
    yield ("ops/blocked._batched_qr_impl", _batched_qr_impl,
           (t(2, 16, 8), 4))


def check_donation(entries=None, device=None) -> "list[Finding]":
    """DHQR304: run each donated entry point under the op log; its output
    must share argument 0's storage and its log must allocate no fresh
    tensor of argument 0's size. ``entries`` overrides the package list
    (tests plant a cloning twin); the package's probes run on ``device``
    (None: the card)."""
    findings = []
    for label, fn, args in (entries if entries is not None
                            else _donation_entries(device)):
        size = args[0].numel()
        try:
            with oplog.record(label) as log:
                out = fn(*args)
        # dhqr: ignore[DHQR006] a donated entry point that raises IS the finding
        except Exception as e:
            findings.append(Finding(
                "DHQR304", label, 0,
                f"donated entry point failed to run: "
                f"{type(e).__name__}: {e}", snippet=label))
            continue
        problems = []
        if not input_output_aliases(out, args):
            problems.append("its output does not share its input's storage")
        fresh = sorted({e.primitive for e in log.events()
                        if e.kind == "op" and any(
                            _numel(s) >= size for s in e.out_shapes)})
        if fresh:
            problems.append(f"it allocates a fresh input-sized tensor "
                            f"({', '.join(fresh)})")
        if problems:
            findings.append(Finding(
                "DHQR304", label, 0,
                "donated entry point does not write in place: "
                + "; ".join(problems) + " — every dispatch pays a full "
                "extra matrix of device memory", snippet=label))
    return findings


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


# ---------------------------------------------------------------------------
# The engine matrix


def _column_shape(P: int) -> "tuple[int, int, int]":
    """(m, n, nb) for the column-sharded engines at mesh size P: 4 panels
    at P <= 4, n scaled so the panel width still divides the local block
    at P = 8 (nb | n/P)."""
    n = 16 if P <= 4 else 4 * P
    return 2 * n, n, 4


_ROW_M, _ROW_N, _ROW_NB = 256, 8, 8
_BATCH_B, _BATCH_M, _BATCH_N, _BATCH_NB = 8, 16, 8, 4


def _inputs(P: int, device):
    """Seeded f32 operands of the matrix's shapes (the same on every rank:
    each rank takes the global problem, as the port's mesh engines do),
    with a single-device factorization of A for the solve routes."""
    import numpy as np
    import torch

    from dhqr_tpu_torch.ops.blocked import blocked_householder_qr

    m, n, nb = _column_shape(P)
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=device)

    x = {"A": t(m, n), "b": t(m), "At": t(_ROW_M, _ROW_N), "bt": t(_ROW_M),
         "As": t(_BATCH_B, _BATCH_M, _BATCH_N), "bs": t(_BATCH_B, _BATCH_M)}
    x["H"], x["alpha"] = blocked_householder_qr(x["A"], nb, device=device)
    return x


def _comms_builders(P: int, preset: str, pol, meshes=None):
    """The run mechanisms, keyed by the builder names the route registry's
    ``comms_trace`` specs cite (``tune/registry.py`` owns WHICH engines
    exist). Each builder returns ``(run, inputs)``: ``run(x)`` runs the
    route on this rank's mesh (``meshes``: ``"cols"``, ``"rows"``, and
    ``"pod"`` = ``(pod mesh, TierAxes)``; a missing one raises, a DHQR104)
    and ``inputs`` names the operands of :func:`_inputs` it shards
    (DHQR303's working set is their bytes over P).

    The conventions of the JAX builders hold: the preset-swept engines
    fold ``policy=preset``; the classic mesh engines take precision knobs
    (``pol.panel`` / ``pol.resolved_apply()``); the wire rungs run with
    only ``comms`` set; the pod engines run on a (2, P/2) pod mesh with
    its tier axes."""
    m, n, nb = _column_shape(P)
    meshes = meshes or {}

    def mesh(axis):
        if axis not in meshes:
            raise RuntimeError(f"no {axis!r} mesh on this rank")
        return meshes[axis]

    def blocked(layout=None, lookahead=False, agg_panels=None,
                comms=None, pod_mesh=False, overlap_depth=None):
        from dhqr_tpu_torch.parallel import sharded_blocked_qr

        kw = {}
        if layout:
            kw["layout"] = layout
        if lookahead:
            kw["lookahead"] = True
        if agg_panels:
            kw["agg_panels"] = agg_panels
        if overlap_depth:
            # the engine clamps the depth to the panels after the first:
            # the pipeline4 route runs the deepest ring the shape admits
            kw["overlap_depth"] = overlap_depth
        if pod_mesh:
            def run(x):
                pmesh, taxes = mesh("pod")
                return sharded_blocked_qr(x["A"], pmesh, block_size=nb,
                                          axis_name=taxes, **kw)
        elif comms:
            def run(x):
                return sharded_blocked_qr(x["A"], mesh("cols"),
                                          block_size=nb, comms=comms, **kw)
        else:
            def run(x):
                return sharded_blocked_qr(x["A"], mesh("cols"),
                                          block_size=nb, policy=preset, **kw)
        return run, ("A",)

    def unblocked(comms=None, pod_mesh=False):
        from dhqr_tpu_torch.parallel import sharded_householder_qr

        def run(x):
            if pod_mesh:
                pmesh, taxes = mesh("pod")
                return sharded_householder_qr(x["A"], pmesh, axis_name=taxes)
            if comms:
                return sharded_householder_qr(x["A"], mesh("cols"),
                                              comms=comms)
            return sharded_householder_qr(x["A"], mesh("cols"),
                                          precision=pol.panel)
        return run, ("A",)

    def solve(comms=None, pod_mesh=False):
        from dhqr_tpu_torch.parallel import sharded_solve

        def run(x):
            args = (x["H"], x["alpha"], x["b"])
            if pod_mesh:
                pmesh, taxes = mesh("pod")
                kw = {"comms": comms} if comms else {}
                return sharded_solve(*args, pmesh, block_size=nb,
                                     axis_name=taxes, **kw)
            if comms:
                return sharded_solve(*args, mesh("cols"), block_size=nb,
                                     comms=comms)
            return sharded_solve(*args, mesh("cols"), block_size=nb,
                                 precision=pol.resolved_apply())
        return run, ("H", "alpha", "b")

    def tsqr(comms=None, pod_mesh=False):
        from dhqr_tpu_torch.parallel import sharded_tsqr_lstsq

        def run(x):
            if pod_mesh:
                pmesh, taxes = mesh("pod")
                kw = {"comms": comms} if comms else {}
                return sharded_tsqr_lstsq(x["At"], x["bt"], pmesh,
                                          block_size=_ROW_NB,
                                          axis_name=taxes, **kw)
            if comms:
                return sharded_tsqr_lstsq(x["At"], x["bt"], mesh("rows"),
                                          block_size=_ROW_NB, comms=comms)
            return sharded_tsqr_lstsq(x["At"], x["bt"], mesh("rows"),
                                      block_size=_ROW_NB,
                                      precision=pol.panel)
        return run, ("At", "bt")

    def cholqr(comms=None, pod_mesh=False):
        from dhqr_tpu_torch.parallel import sharded_cholqr_lstsq

        def run(x):
            if pod_mesh:
                pmesh, taxes = mesh("pod")
                return sharded_cholqr_lstsq(x["At"], x["bt"], pmesh,
                                            axis_name=taxes)
            if comms:
                return sharded_cholqr_lstsq(x["At"], x["bt"], mesh("rows"),
                                            comms=comms)
            return sharded_cholqr_lstsq(x["At"], x["bt"], mesh("rows"),
                                        precision=pol.panel)
        return run, ("At", "bt")

    def bucket_sharded(policy=None):
        # The serving dispatch with its batch split over the ranks: the
        # contract is ZERO collectives — requests stay independent (and a
        # wire policy must never introduce one).
        from dhqr_tpu_torch.serve.engine import bucket_program

        fn = bucket_program("lstsq", block_size=_BATCH_NB,
                            policy=policy if policy is not None else preset)

        def run(x):
            rank, size = mesh("cols").rank, mesh("cols").size
            per = _BATCH_B // size
            sl = slice(rank * per, (rank + 1) * per)
            with oplog.scope("shard:bucket",
                             input_bytes=(x["As"][sl].nbytes
                                          + x["bs"][sl].nbytes)):
                return fn(x["As"][sl], x["bs"][sl])
        return run, ()

    builders = {
        "blocked": blocked,
        "unblocked": unblocked,
        "solve": solve,
        "tsqr": tsqr,
        "cholqr": cholqr,
        "bucket_sharded": bucket_sharded,
    }

    def params_for(shape: str, pod_topology: bool) -> EngineParams:
        topo = (2, P // 2) if pod_topology else None
        if shape == "row":
            return EngineParams(_ROW_M, _ROW_N, _ROW_NB, P, topology=topo)
        if shape == "batch":
            return EngineParams(_BATCH_M, _BATCH_N, _BATCH_NB, P)
        return EngineParams(m, n, nb, P, topology=topo)

    return builders, params_for


def _unexpressible_comms(route_name: str, builder: str):
    """A run for a registry comms spec citing a builder this pass has no
    mechanism for: it raises (-> DHQR104), so the drift is a finding."""
    def run(_x):
        raise RuntimeError(
            f"route {route_name!r} cites comms builder {builder!r} which "
            "analysis/comms_pass implements no mechanism for: implement "
            "the builder or fix the registry spec (tune/registry.py)")
    return run, ()


def _engine_specs(P: int, preset: str, pol, sweep_presets: bool,
                  meshes=None):
    """``(engine, label, (run, inputs), params)`` per mesh route at mesh
    size P — ``engine`` is the contract row the census is priced against;
    ``sweep_presets`` selects the preset-parameterized half of the matrix
    (``tune/registry.comms_routes``)."""
    from dhqr_tpu_torch.tune.registry import comms_routes

    builders, params_for = _comms_builders(P, preset, pol, meshes)
    tag = f"[P={P},{preset}]" if sweep_presets else f"[P={P}]"
    for route in comms_routes(P, sweep=sweep_presets):
        spec = dict(route.comms_trace)
        spec.pop("sweep", None)
        label = f"comms::{spec.pop('label', route.name)}{tag}"
        shape = spec.pop("shape", "col")
        pod_topology = bool(spec.pop("pod", False))
        name = spec.pop("builder")
        build = builders.get(name)
        if build is None:
            yield (route.contract, label,
                   _unexpressible_comms(route.name, name),
                   params_for(shape, pod_topology))
            continue
        if pod_topology:
            spec["pod_mesh"] = True
        yield (route.contract, label, build(**spec),
               params_for(shape, pod_topology))


def _rank_meshes(P: int, device):
    """This rank's meshes for the matrix, each on a subgroup of its own
    (so a collective on WORLD is foreign), and the op log's group map."""
    import torch.distributed as dist

    from dhqr_tpu_torch.parallel.mesh import column_mesh, pod_mesh, row_mesh

    ranks = list(range(P))
    cg, rg = dist.new_group(ranks), dist.new_group(ranks)
    meshes = {"cols": column_mesh(cg, device), "rows": row_mesh(rg, device)}
    groups = {cg: ("cols",), rg: ("rows",)}
    if P >= 4 and P % 2 == 0:
        pg = dist.new_group(ranks)
        pmesh, taxes = pod_mesh(topo=(2, P // 2), group=pg, device=device)
        meshes["pod"] = (pmesh, taxes)
        groups.update({pg: (DCN_AXIS, "ici"),
                       pmesh.ici_mesh.group: ("ici",),
                       pmesh.dcn_mesh.group: (DCN_AXIS,)})
    return meshes, groups


def stamp_shard_inputs(log, nbytes: int) -> None:
    """Give every shard body of ``log`` that has none the per-shard input
    working set ``nbytes`` (DHQR303's yardstick: the route's inputs over
    the rank count)."""
    for s in iter_jaxprs(log):
        if s.name.startswith("shard:") and not s.input_bytes:
            s.input_bytes = int(nbytes)


def _census_worker(device, P, plan):
    """One rank of a census run: every route of ``plan`` (``(preset,
    sweep, stability)`` triples) on this rank's meshes under the op log.
    Returns per route ``{engine, label, params, stats, foreign, stable,
    order, error}`` (``order``: the issue-order stream, for the order
    audits)."""
    import torch

    from dhqr_tpu_torch.precision import PRECISION_POLICIES

    dev = torch.device(device)
    meshes, groups = _rank_meshes(P, dev)
    out = []
    for preset, sweep, stability in plan:
        pol = PRECISION_POLICIES[preset]
        for engine, label, (run, keys), params in _engine_specs(
                P, preset, pol, sweep, meshes):
            row = {"engine": engine, "label": label, "params": params,
                   "stats": None, "foreign": [], "stable": None,
                   "order": None, "error": None}
            out.append(row)
            logs = []
            for _ in range(2 if stability else 1):
                x = _inputs(P, dev)
                shard = sum(x[k].nbytes for k in keys) // P
                try:
                    with oplog.record(label, groups=groups) as log:
                        run(x)
                # dhqr: ignore[DHQR006] a route that raises IS the finding (DHQR104): the parent reports it
                except Exception as e:
                    row["error"] = f"{type(e).__name__}: {e}"
                    break
                stamp_shard_inputs(log, shard)
                logs.append(log)
            if row["error"] is not None:
                continue
            row["stats"] = collect_comms(logs[0])
            row["order"] = issue_order(logs[0], params.nb)
            row["foreign"] = sorted({
                f"{e.family}[{e.group}]" for e in logs[0].collectives()
                if not e.axes})
            if stability:
                row["stable"] = logs[0].signature() == logs[1].signature()
    return out


def census(P: int, presets=("accurate",), device=None, stability=False,
           sweep=(True, False), timeout_s: float = 600.0):
    """Run the matrix at mesh size P in ONE spawn of P ranks: every preset
    of ``presets`` over the halves of ``sweep``. Returns the per-rank rows
    of :func:`_census_worker` (``[rank][route]``). The ranks share
    ``device`` (None: the card) as the port's rank runs do (gloo, or NCCL
    with a card per rank)."""
    from dhqr_tpu_torch.parallel._ranks import rank_backend, run_ranks
    from dhqr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    backend, per_card = rank_backend(dev, P)
    plan = [(p, s, stability) for s in sweep for p in presets]
    return run_ranks(_census_worker, P, backend=backend,
                     device="cuda:0" if dev.type == "cuda" else "cpu",
                     timeout_s=timeout_s, P=P, plan=plan)


def trace_engine(engine: str, P: int, preset: str = "accurate",
                 device=None):
    """Run one engine of the matrix on P ranks and return its merged
    ``(CommsStats, EngineParams)`` — the golden-assertion surface."""
    ranks = census(P, presets=(preset,), device=device)
    for i, row in enumerate(ranks[0]):
        if row["engine"] == engine:
            if row["error"]:
                raise RuntimeError(f"{row['label']}: {row['error']}")
            return (merge_ranks([r[i]["stats"] for r in ranks]),
                    row["params"])
    raise KeyError(f"unknown comms engine {engine!r}")


def run_comms_pass(presets=None, device_counts=DEFAULT_DEVICE_COUNTS,
                   contracts_path=None, stability: bool = True,
                   donation: bool = True, device=None) -> "list[Finding]":
    """The full comms audit: the engine matrix at every mesh size in
    ``device_counts`` (one spawn each; the preset sweep at the smallest),
    the DHQR304 donation probes, and the DHQR305 double run at the
    smallest P. ``device`` is where the ranks run (None: the card)."""
    from dhqr_tpu_torch.precision import PRECISION_POLICIES
    from dhqr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    device_counts = tuple(sorted(set(int(p) for p in device_counts)))
    if not device_counts:
        raise ValueError("device_counts must name at least one mesh size")
    names = list(presets) if presets is not None \
        else list(PRECISION_POLICIES)
    contracts = load_contracts(contracts_path)
    findings: "list[Finding]" = []
    if donation:
        findings.extend(check_donation(device=dev))
    for P in device_counts:
        first = P == device_counts[0]
        plan = [(p, True, stability and first and p == names[0])
                for p in (names if first else names[:1])]
        plan.append((names[0], False, stability and first))
        from dhqr_tpu_torch.parallel._ranks import rank_backend, run_ranks

        backend, _ = rank_backend(dev, P)
        ranks = run_ranks(_census_worker, P, backend=backend,
                          device="cuda:0" if dev.type == "cuda" else "cpu",
                          timeout_s=600.0, P=P, plan=plan)
        findings.extend(check_census(ranks, contracts))
    return apply_graph_suppressions(findings)


def check_census(ranks, contracts) -> "list[Finding]":
    """The findings of one census run (:func:`census`'s rows of every
    rank) against ``contracts``."""
    findings = []
    for i, row in enumerate(ranks[0]):
        engine, label = row["engine"], row["label"]
        contract = contracts.get(engine)
        if contract is None:
            findings.append(Finding(
                "DHQR301", label, 0,
                f"engine '{engine}' has no committed comms contract "
                "(analysis/comms_contracts.json): every mesh engine must "
                "pin its communication pattern", snippet=engine))
            continue
        errors = [r[i]["error"] for r in ranks if r[i]["error"]]
        if errors:
            findings.append(Finding(
                "DHQR104", label, 0,
                f"mesh entry point failed to run: {errors[0]}"))
            continue
        for snippet in sorted({f for r in ranks for f in r[i]["foreign"]}):
            findings.append(Finding(
                "DHQR103", label, 0,
                f"collective {snippet} on a process group outside the "
                "mesh's (the default WORLD group included)",
                snippet=snippet))
        stats = merge_ranks([r[i]["stats"] for r in ranks])
        findings.extend(check_comms(stats, label, contract, row["params"]))
        if any(r[i]["stable"] is False for r in ranks):
            findings.append(_instability(label))
    return findings


def _instability(label: str) -> Finding:
    return Finding(
        "DHQR305", label, 0,
        "two runs of the same (shape, dtype, P, policy) key logged "
        "different op sequences: cache-key instability — in serving this "
        "is a recapture per request",
        snippet="oplog-instability",
    )


def run_comms_pass_auto(presets=None, device_counts=DEFAULT_DEVICE_COUNTS,
                        contracts_path=None, device=None) -> "list[Finding]":
    """:func:`run_comms_pass` (the JAX package's in-process-or-subprocess
    entry; here the ranks are processes of their own at any P)."""
    return run_comms_pass(presets=presets, device_counts=device_counts,
                          contracts_path=contracts_path, device=device)
