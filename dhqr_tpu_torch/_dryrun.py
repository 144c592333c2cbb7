"""Multi-rank dry run of the port — runnable as
``python -m dhqr_tpu_torch._dryrun N [--device cpu]``; the twin of
``dhqr_tpu/_dryrun.py``.

Exercises every distributed path the port ships on N ranks (column-block
and column-cyclic compact-WY QR with its schedules, the depth-k pipeline,
padding, refinement and the "fast" policy on the mesh, pulse, the
compressed wire, armor, the two-tier pod mesh, row-sharded TSQR and
CholeskyQR, and the realistic panel widths against LAPACK), then the
single-process tiers (serving, async scheduling, faults, the fleet's key
store, the numeric ladder, tracing, xray, the tuner, the sketch and the
updatable QR, and the lock discipline), each with the JAX dry run's
sizes, assertions and ``dryrun: ... ok`` lines. It ends with ``dryrun:
all paths ok``.

The ranks are spawned once per :func:`run`: one ``run_ranks`` call whose
worker runs every mesh stage in order (NCCL when every rank has a card of
its own, else gloo: the CPU, or ranks sharing the card); rank 0 prints.
The single-process stages run in the calling process. A stage that needs
more ranks than it got prints ``SKIPPED`` with the reason; no stage
catches its own failure, so any assertion ends the run non-zero.

Differences from the JAX dry run, each by design: the port's engines run
eagerly, so "warm repeat 0 recompiles" reads "0 captures" on the serve
tier (the bucket cache's misses) and "bit-identical repeat" on the eager
engines; the fleet stage's child leaves key records, not programs (a CUDA
graph does not outlive its process), so the parent's first call is a
counted ``NOT_A_PROGRAM`` miss and one recapture; the checks that read
the graph passes of ``analysis/`` (the pipeline's order audit, the pod
contract, the comms audit and the atlas) read op logs
(``analysis/oplog.py``) where the JAX dry run reads jaxprs, and the comms
and atlas stages spawn the comms audit's own ranks; and the serve stage prints the batched ``policy="fast"`` ratio instead of
holding it to 8x, because the port runs its bf16 passes on the CPU as on
the card while the JAX package's CPU matmul ignores the precision. The
lock-discipline stage (``concurrency``) runs its witness burst on the run's
device, so on the card it also witnesses the lanes' graph captures.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

MESH_STAGES = ("layouts", "pipeline", "awkward", "refine", "policy",
               "pulse", "wire", "armor", "pod", "rows", "realistic")
LOCAL_STAGES = ("serve", "async", "faults", "fleet", "numeric", "obs",
                "xray", "tune", "sketch", "comms", "atlas", "concurrency")
STAGES = MESH_STAGES + LOCAL_STAGES

#: The mesh stages' time limit (the spawn and every stage).
RANKS_TIMEOUT_S = 1800.0

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _say(msg: str) -> None:
    print(msg, flush=True)


def _ratio(A, x, b) -> float:
    """The normal-equations residual of x over the LAPACK oracle's."""
    from dhqr_tpu_torch.interop import to_numpy
    from dhqr_tpu_torch.utils.testing import (
        normal_equations_residual,
        oracle_residual,
    )

    A, b = (to_numpy(v) if hasattr(v, "detach") else v for v in (A, b))
    x = to_numpy(x) if hasattr(x, "detach") else x
    return normal_equations_residual(A, x, b) / oracle_residual(A, b)


def _finite(x, what: str, shape) -> None:
    import torch

    assert tuple(x.shape) == tuple(shape), (what, tuple(x.shape), shape)
    assert bool(torch.isfinite(x).all()), f"non-finite x ({what})"


class _Mesh:
    """One rank's view of the mesh stages: its meshes, the toy problem of
    the JAX dry run (8 local columns per rank, m = 2n, nb = 4), and a
    ``say`` that only rank 0 speaks through."""

    def __init__(self, device):
        import numpy as np
        import torch.distributed as dist

        from dhqr_tpu_torch import parallel

        self.device = device
        self.P = dist.get_world_size()
        self.rank = dist.get_rank()
        self.cmesh = parallel.column_mesh(device=device)
        self.rmesh = parallel.row_mesh(device=device)
        self.nb = 4
        self.n = 8 * self.P
        self.m = 2 * self.n
        rng = np.random.default_rng(0)
        self.A = rng.random((self.m, self.n)).astype(np.float32)
        self.b = rng.random(self.m).astype(np.float32)

    def say(self, msg: str) -> None:
        if self.rank == 0:
            _say(msg)

    def skip(self, stage: str, need: int, why: str) -> bool:
        if self.P >= need:
            return False
        self.say(f"dryrun: {stage} SKIPPED (needs >= {need} ranks: {why} "
                 f"— rerun with python -m dhqr_tpu_torch._dryrun {need} or "
                 "more)")
        return True


def _census(fn):
    """``(value, entries)`` of one call under the wire census."""
    from dhqr_tpu_torch.parallel import wire

    with wire.census() as seen:
        value = fn()
    return value, seen.entries


def _launches(entries) -> dict:
    out: "dict[str, int]" = {}
    for e in entries:
        out[e["family"]] = out.get(e["family"], 0) + e["launches"]
    return out


# ------------------------------------------------------------ mesh stages


def _stage_layouts(c: _Mesh) -> None:
    from dhqr_tpu_torch.parallel import sharded_lstsq

    for layout in ("block", "cyclic"):
        x = sharded_lstsq(c.A, c.b, c.cmesh, block_size=c.nb, layout=layout)
        _finite(x, layout, (c.n,))
        c.say(f"dryrun: sharded_lstsq layout={layout} ok")
    x = sharded_lstsq(c.A, c.b, c.cmesh, block_size=c.nb, layout="cyclic",
                      lookahead=True)
    _finite(x, "lookahead", (c.n,))
    c.say("dryrun: sharded_lstsq lookahead ok")
    x = sharded_lstsq(c.A, c.b, c.cmesh, block_size=c.nb, layout="cyclic",
                      agg_panels=2)
    _finite(x, "agg_panels", (c.n,))
    c.say("dryrun: sharded_lstsq agg_panels=2 ok")
    x = sharded_lstsq(c.A, c.b, c.cmesh, block_size=c.nb, layout="cyclic",
                      agg_panels=2, lookahead=True)
    _finite(x, "agg+lookahead", (c.n,))
    c.say("dryrun: sharded_lstsq agg_panels=2 lookahead ok")


def _stage_pipeline(c: _Mesh) -> None:
    """The depth-2 ring runs the whole solve, launches the lookahead's
    collective census, and returns its factors bit for bit."""
    import torch

    from dhqr_tpu_torch.parallel import sharded_blocked_qr, sharded_lstsq

    if c.skip("pipeline", 2, "overlap_depth is mesh-only and one rank has "
              "no broadcast latency to hide"):
        return
    x = sharded_lstsq(c.A, c.b, c.cmesh, block_size=c.nb, layout="cyclic",
                      lookahead=True, overlap_depth=2)
    _finite(x, "pipeline", (c.n,))
    (Hl, al), la = _census(lambda: sharded_blocked_qr(
        c.A, c.cmesh, block_size=c.nb, lookahead=True))
    (Hp, ap), p2 = _census(lambda: sharded_blocked_qr(
        c.A, c.cmesh, block_size=c.nb, lookahead=True, overlap_depth=2))
    assert _launches(la) == _launches(p2), (
        "depth-2 ring changed the collective census", _launches(la),
        _launches(p2))
    assert torch.equal(Hl, Hp) and torch.equal(al, ap), \
        "depth-2 pipeline is not bit-identical to lookahead"
    Hp2, _ = sharded_blocked_qr(c.A, c.cmesh, block_size=c.nb,
                                lookahead=True, overlap_depth=2)
    assert torch.equal(Hp2, Hp), "depth-2 repeat diverged"
    # Order audit on a 6-panel shape over a 2-rank sub-mesh (every rank
    # makes the group; ranks 0 and 1 run it): every logged wide trailing
    # GEMM of panel q must come after panel q+2's broadcast was issued (a
    # rank whose columns all take the narrow updates logs none).
    import numpy as np
    import torch.distributed as dist

    from dhqr_tpu_torch.analysis import oplog
    from dhqr_tpu_torch.analysis.comms_pass import overlap_distance
    from dhqr_tpu_torch.parallel import column_mesh

    g2 = dist.new_group([0, 1])
    depth = None
    if c.rank < 2:
        A_aud = np.random.default_rng(6).random((48, 24)).astype(np.float32)
        with oplog.record("pipeline-audit", groups={g2: ("cols",)}) as log:
            sharded_blocked_qr(A_aud, column_mesh(g2, device=c.device),
                               block_size=c.nb, lookahead=True,
                               overlap_depth=2)
        depths = [None, None]
        dist.all_gather_object(depths, overlap_distance(log, c.nb),
                               group=g2)
        seen = [d for d in depths if d is not None]
        depth = min(seen) if seen else None
        assert depth is not None and depth >= 2, (
            "logged issue order does not hide >= 2 panels", depths)
    c.say(f"dryrun: pipeline ok (census identical to lookahead: "
          f"{_launches(p2)}, bit-identical factors, bit-identical repeat, "
          f"logged order hides {depth} panels)")


def _stage_awkward(c: _Mesh) -> None:
    from dhqr_tpu_torch.parallel import sharded_lstsq

    n_awk = c.n - 3
    x = sharded_lstsq(c.A[:, :n_awk], c.b, c.cmesh, block_size=c.nb)
    _finite(x, "awkward n", (n_awk,))
    c.say(f"dryrun: sharded_lstsq awkward n={n_awk} ok")


def _stage_refine(c: _Mesh) -> None:
    import dhqr_tpu_torch as dt

    x = dt.lstsq(c.A, c.b, mesh=c.cmesh, block_size=c.nb, refine=1)
    _finite(x, "refine on mesh", (c.n,))
    c.say("dryrun: sharded lstsq refine=1 ok")


def _stage_policy(c: _Mesh) -> None:
    import dhqr_tpu_torch as dt

    x = dt.lstsq(c.A, c.b, mesh=c.cmesh, block_size=c.nb, policy="fast")
    _finite(x, "policy on mesh", (c.n,))
    c.say("dryrun: sharded lstsq policy=fast ok")


def _stage_pulse(c: _Mesh) -> None:
    """An armed mesh dispatch yields a measured census that agrees with
    the wire's, a per-shard skew, a green DHQR306 (a reasoned skip on
    gloo), the comms.* names, and a warm repeat that measures nothing."""
    import torch.distributed as dist

    from dhqr_tpu_torch import obs
    from dhqr_tpu_torch.obs import pulse
    from dhqr_tpu_torch.parallel import sharded_blocked_qr

    if c.skip("pulse", 2, "a measured collective census needs "
              "collectives"):
        return
    with pulse.pulsed() as pstore:
        sharded_blocked_qr(c.A, c.cmesh, block_size=c.nb)
        preps = pstore.reports()
        assert preps, "armed pulse capture recorded no reports"
        prep = preps[0]
        assert prep.measured is not None, (
            "no measured collective census on the dry run's mesh",
            prep.measured_unavailable)
        assert "broadcast" in prep.measured, prep.measured
        assert prep.analytic and prep.analytic.get("broadcast"), (
            "analytic census lost the blocked engine's broadcasts",
            prep.analytic)
        assert prep.measured["broadcast"]["launches"] == \
            prep.analytic["broadcast"]["launches"], (
                "measured and census broadcast launch counts disagree",
                prep.measured, prep.analytic)
        # The per-shard skew: each rank measures its own process, so the
        # spread across shards is the ranks' measured walls side by side
        # (the report's own skew block covers this rank's lanes, and says
        # why when it has fewer than two).
        assert prep.skew is not None or prep.skew_unavailable, prep
        walls = [None] * c.P
        dist.all_gather_object(walls, prep.wall_s, group=c.cmesh.group)
        skew = max(walls) / sorted(walls)[len(walls) // 2]
        assert len(walls) == c.P >= 2 and skew >= 1.0, walls
        assert prep.dhqr306_pass, ("DHQR306 red on the dry run",
                                   prep.dhqr306)
        captures = pstore.stats()["captures"]
        sharded_blocked_qr(c.A, c.cmesh, block_size=c.nb)
        assert pstore.stats()["captures"] == captures, (
            "warm armed repeat re-measured", pstore.stats())
        snap = obs.registry().snapshot()
        for dotted in ("comms.captures", "comms.reports",
                       "comms.dhqr306_failures"):
            assert dotted in snap, (dotted, sorted(snap))
    c.say(f"dryrun: pulse ok (measured "
          f"{prep.measured['broadcast']['launches']} broadcast launches x "
          f"{prep.measured['broadcast']['time_s'] * 1e3:.2f} ms/rank vs "
          f"{prep.analytic['broadcast']['launches']} in the census, shard "
          f"skew {skew:.2f}x over {c.P} ranks, DHQR306 "
          f"{prep.dhqr306['status']}, warm repeat 0 re-measures)")


def _stage_wire(c: _Mesh) -> None:
    """bf16 cuts the panel broadcasts' census bytes >= 1.8x, a compressed
    lstsq holds 8x, comms=None puts no bf16 word on the wire, and the
    accurate preset is bit-identical to the plain spelling."""
    import numpy as np
    import torch

    import dhqr_tpu_torch as dt
    from dhqr_tpu_torch.parallel import sharded_blocked_qr, \
        sharded_tsqr_lstsq

    if c.skip("wire", 2, "one rank launches no collectives, so there is "
              "no wire volume to compress"):
        return
    (H0, a0), plain = _census(lambda: sharded_blocked_qr(
        c.A, c.cmesh, block_size=c.nb, comms=None))
    _, bf16 = _census(lambda: sharded_blocked_qr(
        c.A, c.cmesh, block_size=c.nb, comms="bf16"))
    vol_f32, vol_bf16 = (sum(e["bytes"] for e in entries
                             if e["family"] == "broadcast")
                         for entries in (plain, bf16))
    ratio = vol_f32 / max(vol_bf16, 1)
    assert ratio >= 1.8, ("bf16 wire volume reduction regressed", vol_f32,
                          vol_bf16)
    assert not any("bfloat16" in str(e["wire"]) for e in plain), \
        "comms=None put a bf16 word on the wire — the passthrough broke"
    assert any("bfloat16" in str(e["wire"]) for e in bf16), \
        "the bf16 twin compressed nothing"
    H1, a1 = sharded_blocked_qr(c.A, c.cmesh, block_size=c.nb,
                                policy="accurate")
    assert torch.equal(H0, H1) and torch.equal(a0, a1), \
        "the accurate preset is not bit-identical to the plain spelling"
    rng = np.random.default_rng(18)
    bw = rng.random(c.m).astype(np.float32)
    xw = dt.lstsq(c.A, bw, mesh=c.cmesh, block_size=c.nb, comms="bf16")
    r_w = _ratio(c.A, xw, bw) if c.rank == 0 else 0.0
    assert r_w < 8, ("wire bf16 lstsq", r_w)
    At = rng.random((64 * c.P, 8)).astype(np.float32)
    bt = rng.random(64 * c.P).astype(np.float32)
    xt = sharded_tsqr_lstsq(At, bt, c.rmesh, block_size=8, comms="bf16")
    r_t = _ratio(At, xt, bt) if c.rank == 0 else 0.0
    assert r_t < 8, ("wire bf16 tsqr", r_t)
    H2, _ = sharded_blocked_qr(c.A, c.cmesh, block_size=c.nb, comms="bf16")
    H3, _ = sharded_blocked_qr(c.A, c.cmesh, block_size=c.nb, comms="bf16")
    assert torch.equal(H2, H3), "compressed repeat diverged"
    c.say(f"dryrun: wire ok (census panel-broadcast volume {vol_f32} B -> "
          f"{vol_bf16} B = {ratio:.2f}x under bf16, compressed lstsq "
          f"within 8x ({r_w:.2f}x), bf16 tsqr within 8x ({r_t:.2f}x), "
          "accurate bit-identical, compressed repeat bit-identical)")


def _stage_armor(c: _Mesh) -> None:
    """One injected collective corruption is detected and re-dispatched
    away within 8x; a persistent drop resolves typed with its label and
    recovery; the armor.* names exist; an armed repeat is unchanged."""
    import torch

    from dhqr_tpu_torch import armor, faults, obs
    from dhqr_tpu_torch.parallel import sharded_lstsq
    from dhqr_tpu_torch.utils.config import ArmorConfig, FaultConfig

    if c.skip("armor", 2, "one rank launches no collectives, so there is "
              "nothing to corrupt or verify"):
        return
    state = armor.arm(ArmorConfig(enabled=True))
    try:
        with faults.injected(FaultConfig(sites=(
                ("parallel.collective.corrupt", 1.0, 1, 3),))):
            xa = sharded_lstsq(c.A, c.b, c.cmesh, block_size=c.nb)
        snap = state.metrics_snapshot()
        assert snap["detections"] >= 1, ("injected corruption went "
                                         "UNDETECTED", snap)
        assert snap["recovered_redispatch"] >= 1, (
            "detection did not recover via re-dispatch", snap)
        r_a = _ratio(c.A, xa, c.b) if c.rank == 0 else 0.0
        assert r_a < 8, ("recovered armor solve out of bar", r_a)
        try:
            with faults.injected(FaultConfig(sites=(
                    ("parallel.collective.drop", 1.0, None),))):
                sharded_lstsq(c.A, c.b, c.cmesh, block_size=c.nb)
            raise AssertionError("persistent drop schedule returned "
                                 "UNTYPED")
        except armor.ArmorError as e:
            assert e.label and e.recovery, (e.label, e.recovery)
            typed = type(e).__name__
        snap_reg = obs.registry().snapshot()
        for dotted in ("armor.verifications", "armor.detections",
                       "armor.typed_failures"):
            assert dotted in snap_reg, (dotted, sorted(snap_reg))
        x1 = sharded_lstsq(c.A, c.b, c.cmesh, block_size=c.nb)
        x2 = sharded_lstsq(c.A, c.b, c.cmesh, block_size=c.nb)
        assert torch.equal(x1, x2), "armed repeat diverged"
        snap = state.metrics_snapshot()
    finally:
        armor.disarm()
        armor.reset_wire_trips()
    c.say(f"dryrun: armor ok (1 injected corruption detected and "
          f"re-dispatch-recovered within 8x ({r_a:.2f}x), persistent drop "
          f"typed {typed} with label+recovery, {snap['verifications']} "
          "verifications, armed repeat bit-identical)")


def _stage_pod(c: _Mesh) -> None:
    """A simulated 2x2 (DCN x ICI) factorization of 4 ranks: every panel
    broadcast crosses the hosts once, on a 1/ici_size share of its rows
    (half the flat payload, up to a padding row per part), dcn:bf16 holds
    a pod lstsq within 8x, and a repeat is bit-identical."""
    import dataclasses

    import numpy as np
    import torch

    import dhqr_tpu_torch as dt
    from dhqr_tpu_torch.parallel import pod_mesh, sharded_blocked_qr

    if c.skip("pod", 4, "a 2x2 DCN x ICI factorization needs 4 ranks"):
        return
    m, n, nb = 64, 32, 4
    rng = np.random.default_rng(20)
    Ap = rng.random((m, n)).astype(np.float32)
    bp = rng.random(m).astype(np.float32)
    pmesh, taxes = pod_mesh(4, topo="2x2", device=c.device)
    flat_axes = dataclasses.replace(taxes, hierarchical=False)
    (Hh, _), hier = _census(lambda: sharded_blocked_qr(
        Ap, pmesh, block_size=nb, axis_name=taxes))
    _, flat = _census(lambda: sharded_blocked_qr(
        Ap, pmesh, block_size=nb, axis_name=flat_axes))

    def legs(entries):
        return {leg: [e for e in entries if e["family"] == "broadcast"
                      and e["leg"] == leg] for leg in ("flat", "ici", "dcn")}

    lh, lf = legs(hier), legs(flat)
    n_bcast = len(lf["flat"])
    assert n_bcast and not lf["dcn"] and not lh["flat"], (lh, lf)
    assert len(lh["dcn"]) == n_bcast, (
        "hierarchical DCN legs diverged from one per broadcast",
        len(lh["dcn"]), n_bcast)
    assert all(e["crosses_dcn"] == (e["leg"] == "dcn") for e in hier)
    flat_bytes = sum(e["bytes"] for e in lf["flat"])
    dcn_bytes = sum(e["bytes"] for e in lh["dcn"])
    pad = sum(e["bytes"] // max(e["shapes"][0][0], 1) for e in lf["flat"])
    assert flat_bytes / taxes.ici_size <= dcn_bytes <= \
        flat_bytes / taxes.ici_size + pad, (
            "cross-DCN bytes are not 1/ici_size of the flat payload",
            dcn_bytes, flat_bytes)
    xp = dt.lstsq(Ap, bp, mesh=pmesh, block_size=nb, comms="dcn:bf16")
    r_p = _ratio(Ap, xp, bp) if c.rank == 0 else 0.0
    assert r_p < 8, ("pod dcn:bf16 lstsq", r_p)
    Hh2, _ = sharded_blocked_qr(Ap, pmesh, block_size=nb, axis_name=taxes)
    assert torch.equal(Hh, Hh2), "pod repeat diverged"
    # The committed two-tier contract, held on every rank's op log as the
    # comms audit holds it (per-tier DHQR302 through EngineParams.topology).
    from dhqr_tpu_torch.analysis import oplog
    from dhqr_tpu_torch.analysis.comms_pass import (
        EngineParams,
        check_comms,
        collect_comms,
        load_contracts,
        stamp_shard_inputs,
    )

    groups = {pmesh.group: ("dcn", "ici"), pmesh.ici_mesh.group: ("ici",),
              pmesh.dcn_mesh.group: ("dcn",)}
    with oplog.record("pod-audit", groups=groups) as log:
        sharded_blocked_qr(Ap, pmesh, block_size=nb, axis_name=taxes)
    stamp_shard_inputs(log, Ap.nbytes // 4)
    pod_contract = load_contracts().get("blocked_qr_pod")
    assert pod_contract is not None, (
        "blocked_qr_pod contract missing from comms_contracts.json")
    pod_findings = check_comms(
        collect_comms(log), f"dryrun::blocked_qr_pod[rank {c.rank}]",
        pod_contract, EngineParams(m=m, n=n, nb=nb, P=4, topology=(2, 2)))
    assert not pod_findings, "pod contract findings:\n" + "\n".join(
        f.render() for f in pod_findings)
    c.say(f"dryrun: pod ok (2x2 hierarchical census {len(lh['ici'])} ICI "
          f"+ {len(lh['dcn'])} DCN legs for {n_bcast} broadcasts, "
          f"cross-DCN bytes {dcn_bytes} B vs flat {flat_bytes} B / "
          f"{taxes.ici_size}, dcn:bf16 lstsq within 8x ({r_p:.2f}x), "
          "repeat bit-identical, blocked_qr_pod contract green on every "
          "rank)")


def _stage_rows(c: _Mesh) -> None:
    import numpy as np

    from dhqr_tpu_torch.parallel import sharded_cholqr_lstsq, \
        sharded_tsqr_lstsq

    nt = 8
    mt = 2 * nt * c.P  # local row blocks stay tall
    rng = np.random.default_rng(16)
    At = rng.random((mt, nt)).astype(np.float32)
    bt = rng.random(mt).astype(np.float32)
    x = sharded_tsqr_lstsq(At, bt, c.rmesh, block_size=c.nb)
    _finite(x, "tsqr", (nt,))
    c.say("dryrun: sharded_tsqr_lstsq ok")
    x = sharded_cholqr_lstsq(At, bt, c.rmesh)
    _finite(x, "cholqr", (nt,))
    c.say("dryrun: sharded_cholqr_lstsq ok")


def _realistic_stage(c: _Mesh, n: int, nb: int) -> None:
    """Realistic panel widths against the reference's oracle and 8x rule
    (runtests.jl:49-51, 62): both layouts, then cyclic + grouped
    lookahead."""
    import numpy as np

    from dhqr_tpu_torch.parallel import sharded_lstsq

    m = 2 * n
    rng = np.random.default_rng(1)
    A = rng.random((m, n)).astype(np.float32)
    b = rng.random(m).astype(np.float32)
    runs = [(layout, dict(layout=layout)) for layout in ("block", "cyclic")]
    runs.append(("cyclic+agg2+lookahead",
                 dict(layout="cyclic", agg_panels=2, lookahead=True)))
    for name, kw in runs:
        x = sharded_lstsq(A, b, c.cmesh, block_size=nb, **kw)
        assert tuple(x.shape) == (n,)
        if c.rank == 0:
            r = _ratio(A, x, b)
            assert r < 8, (name, r)
            word = "layout=" + name if "+" not in name else name
            _say(f"dryrun: realistic n={n} nb={nb} {word} ok (residual "
                 f"{r:.2f}x the LAPACK oracle's < 8x)")


def _mesh_worker(device, stages, sizes, per_card):
    """One rank of :func:`run`'s mesh stages: each stage in order, timed;
    returns this rank's seconds per stage."""
    import torch
    import torch.distributed as dist

    if per_card:  # NCCL: every rank has a card of its own
        device = f"cuda:{dist.get_rank()}"
        torch.cuda.set_device(device)
    c = _Mesh(device)
    seconds = {}
    for stage in stages:
        # dhqr: ignore[DHQR008] the dry run reports each stage's real wall seconds — wall time is the measurement
        t0 = time.perf_counter()
        if stage == "realistic":
            for n, nb in sizes:
                _realistic_stage(c, n, nb)
        else:
            _MESH[stage](c)
        # dhqr: ignore[DHQR008] same measurement, closing read
        seconds[stage] = time.perf_counter() - t0
    return seconds


_MESH = {"layouts": _stage_layouts, "pipeline": _stage_pipeline,
         "awkward": _stage_awkward, "refine": _stage_refine,
         "policy": _stage_policy, "pulse": _stage_pulse,
         "wire": _stage_wire, "armor": _stage_armor, "pod": _stage_pod,
         "rows": _stage_rows}


def _spawn(n_ranks: int, dev, stages, sizes) -> dict:
    # by its module's name: under ``python -m`` this file is __main__,
    # which a spawned rank cannot import
    from dhqr_tpu_torch._dryrun import _mesh_worker as worker
    from dhqr_tpu_torch.parallel._ranks import run_ranks, rank_backend

    backend, per_card = rank_backend(dev, n_ranks)
    out = run_ranks(worker, n_ranks, backend=backend,
                    device="cuda:0" if dev.type == "cuda" else "cpu",
                    timeout_s=RANKS_TIMEOUT_S, stages=list(stages),
                    sizes=sizes, per_card=per_card)
    return {k: max(r[k] for r in out) for k in out[0]}


# ---------------------------------------------------- single-process stages


class _Local:
    """The single-process stages' shared state: the device, the JAX dry
    run's mixed-shape request stream, and the async stage's cache."""

    REQ_SHAPES = [(48, 16), (30, 24), (48, 16), (72, 40), (24, 24),
                  (60, 10), (40, 28)]

    def __init__(self, dev, n_ranks: int = 1):
        import numpy as np

        self.dev = dev
        self.n_ranks = n_ranks
        rng = np.random.default_rng(8)
        self.As = [rng.random(s).astype(np.float32) for s in self.REQ_SHAPES]
        self.bs = [rng.random(s[0]).astype(np.float32)
                   for s in self.REQ_SHAPES]
        self.acache = None

    def within_8x(self, xs, what, As=None, bs=None) -> float:
        worst = 0.0
        for i, (A, b, x) in enumerate(zip(As or self.As, bs or self.bs, xs)):
            assert tuple(x.shape) == (A.shape[1],), (what, i, x.shape)
            r = _ratio(A, x, b)
            assert r < 8, (what, i, A.shape, r)
            worst = max(worst, r)
        return worst

    def async_cache(self):
        """The async stage's cache, prewarmed through the sync tier's
        entry point with the stream's per-bucket totals."""
        from dhqr_tpu_torch.serve import prewarm
        from dhqr_tpu_torch.serve.cache import ExecutableCache

        if self.acache is None:
            self.acache = ExecutableCache(max_size=16)
            counts: "dict[tuple, int]" = {}
            for s in self.REQ_SHAPES:
                counts[s] = counts.get(s, 0) + 1
            prewarm([(k, m, n) for (m, n), k in counts.items()],
                    block_size=8, cache=self.acache, device=self.dev)
        return self.acache


def _poll_until(sched, futs, what: str, limit_s: float = 120.0) -> None:
    # dhqr: ignore[DHQR008] hang bound on a REAL poll loop — wall time is the point
    t0 = time.monotonic()
    while not all(f.done() for f in futs):
        sched.poll()
        # dhqr: ignore[DHQR008] same hang bound, closing read
        if time.monotonic() - t0 > limit_s:
            raise RuntimeError(f"{what}: futures did not resolve in "
                               f"{limit_s} s (stats: {sched.stats()})")
        time.sleep(0.005)


def _stage_serve(s: _Local) -> None:
    """A mixed-shape request list through ``batched_lstsq`` within 8x on
    every request, and a repeat with zero captures."""
    import torch

    from dhqr_tpu_torch.serve import batched_lstsq, cache_stats

    xs = batched_lstsq(s.As, s.bs, block_size=8, device=s.dev)
    s.within_8x(xs, "serve")
    s0 = cache_stats(s.dev)
    batched_lstsq(s.As, s.bs, block_size=8, device=s.dev)
    s1 = cache_stats(s.dev)
    assert s1["misses"] == s0["misses"], ("repeat request stream "
                                          "recaptured", s0, s1)
    # The "fast" preset composes through the batched path (bf16 trailing
    # passes + one refinement sweep): finite, its ratio printed. The port
    # runs bf16 passes on the CPU too, where the JAX package's CPU matmul
    # ignores the precision, so only "accurate" is held to 8x (PERF.md
    # section 2's rule for the policy rungs).
    xs = batched_lstsq(s.As, s.bs, block_size=8, policy="fast",
                       device=s.dev)
    fast = max(_ratio(A, x, b) for A, x, b in zip(s.As, xs, s.bs))
    assert all(bool(torch.isfinite(x).all()) for x in xs), "serve policy"
    _say(f"dryrun: serve batched_lstsq ok ({len(s.As)} mixed-shape "
         f"requests, {s1['size']} resident programs, repeat pass 0 "
         f"captures; policy=fast finite, worst {fast:.1f}x of oracle)")


def _stage_async(s: _Local) -> None:
    """The stream through the admission queue against keys the sync tier
    prewarmed: every residual within 8x, the warm pass inside its SLO, no
    capture past the prewarm."""
    from dhqr_tpu_torch.serve import AsyncScheduler
    from dhqr_tpu_torch.utils.config import SchedulerConfig

    acache = s.async_cache()
    warm_misses = acache.stats()["misses"]
    slo_s = 2.0
    kcfg = SchedulerConfig(slo_ms=slo_s * 1e3, flush_interval_ms=1e3)
    for attempt in ("cold", "warm"):
        sched = AsyncScheduler(sched_config=kcfg, cache=acache,
                               block_size=8, start=False, device=s.dev)
        futs = [sched.submit("lstsq", A, b, deadline=slo_s,
                             tenant=f"t{i % 2}")
                for i, (A, b) in enumerate(zip(s.As, s.bs))]
        sched.drain()
        s.within_8x([f.result(timeout=60) for f in futs], "async")
        st = sched.stats()
        assert st["completed"] == len(futs), st
        if attempt == "warm":
            assert st["latency"]["p99_ms"] <= slo_s * 1e3, (
                "async warm p99 blew the SLO", st["latency"])
            assert st["deadline_misses"] == 0, st
        sched.shutdown()
    assert acache.stats()["misses"] == warm_misses, (
        "async dispatch captured past the sync prewarm", warm_misses,
        acache.stats())
    _say(f"dryrun: async serve ok ({len(s.As)} streamed requests x 2 "
         f"passes, 0 captures past sync prewarm, warm p99 "
         f"{st['latency']['p99_ms']:.1f} ms <= SLO {slo_s * 1e3:.0f} ms)")


def _stage_faults(s: _Local) -> None:
    """One injected capture failure and one dispatch failure through the
    resilient scheduler: every future succeeds within 8x, the harness
    fired exactly those two, and the repeat after recovery captures
    nothing."""
    from dhqr_tpu_torch import faults
    from dhqr_tpu_torch.serve import AsyncScheduler
    from dhqr_tpu_torch.serve.cache import ExecutableCache
    from dhqr_tpu_torch.utils.config import FaultConfig, SchedulerConfig

    fcache = ExecutableCache(max_size=16, quarantine_s=0.2)
    kcfg = SchedulerConfig(slo_ms=30e3, flush_interval_ms=20.0,
                           retry_base_ms=5.0)
    sched = AsyncScheduler(sched_config=kcfg, cache=fcache, block_size=8,
                           start=False, device=s.dev)
    cfg = FaultConfig(sites=(("serve.compile", 1.0, 1),
                             ("serve.dispatch", 1.0, 1)), seed=0)
    with faults.injected(cfg) as harness:
        futs = [sched.submit("lstsq", A, b, deadline=30.0)
                for A, b in zip(s.As, s.bs)]
        _poll_until(sched, futs, "faults stage")
    s.within_8x([f.result(timeout=0) for f in futs], "faults")
    hstats = harness.stats()
    assert hstats["serve.compile"]["fired"] == 1, hstats
    assert hstats["serve.dispatch"]["fired"] == 1, hstats
    fstats = sched.stats()
    assert fstats["retries"] >= 2 and fstats["flush_failures"] >= 2, fstats
    assert fstats["failed"] == 0 and fstats["completed"] == len(s.As), \
        fstats
    assert fcache.stats()["compile_failures"] == 1, fcache.stats()
    for attempt in ("recovery", "warm"):
        if attempt == "warm":
            warm_misses = fcache.stats()["misses"]
        futs = [sched.submit("lstsq", A, b, deadline=30.0)
                for A, b in zip(s.As, s.bs)]
        sched.drain()
        assert all(f.exception() is None for f in futs), attempt
    assert fcache.stats()["misses"] == warm_misses, (
        "post-recovery repeat recaptured", fcache.stats())
    sched.shutdown()
    _say(f"dryrun: faults ok ({len(s.As)} requests through 1 injected "
         f"capture + 1 injected dispatch failure, {fstats['retries']} "
         "retries, all futures resolved within 8x, quarantine released, "
         "warm repeat after recovery 0 captures)")


_FLEET_CHILD = r'''
import json
import sys

import numpy as np

import dhqr_tpu_torch as dt
from dhqr_tpu_torch.serve.store import default_store

rng = np.random.default_rng(13)
A = rng.standard_normal((64, 32)).astype(np.float32)
b = rng.standard_normal(64).astype(np.float32)
dt.batched_lstsq([A], [b], device=sys.argv[1])
print(json.dumps(default_store().stats()))
'''


def _stage_fleet(s: _Local) -> None:
    """A child interpreter captures into a shared key store; here the
    recorded key arrives as a counted NOT_A_PROGRAM miss and one
    recapture (a CUDA graph does not outlive its process), the repeat
    captures nothing, and one injected store corruption degrades to a
    counted recapture, never a failure on the dispatch path."""
    import numpy as np

    from dhqr_tpu_torch import faults
    from dhqr_tpu_torch.serve import engine
    from dhqr_tpu_torch.serve.cache import ExecutableCache
    from dhqr_tpu_torch.serve.store import NOT_A_PROGRAM, ExecutableStore
    from dhqr_tpu_torch.utils.config import FaultConfig

    with tempfile.TemporaryDirectory(prefix="dhqr-dryrun-fleet-") as root:
        store_dir = os.path.join(root, "store")
        child = os.path.join(root, "child.py")
        with open(child, "w", encoding="utf-8") as fh:
            fh.write(_FLEET_CHILD)
        env = dict(os.environ, DHQR_FLEET_STORE=store_dir,
                   PYTHONPATH=os.pathsep.join(
                       p for p in (_REPO, os.environ.get("PYTHONPATH"))
                       if p))
        proc = subprocess.run(
            [sys.executable, child, str(s.dev)], env=env, cwd=_REPO,
            capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, ("fleet child failed:\n"
                                      + proc.stderr[-2000:])
        child_stats = json.loads(proc.stdout.strip().splitlines()[-1])
        assert child_stats["puts"] >= 1, child_stats
        store = ExecutableStore(store_dir)
        rng = np.random.default_rng(13)
        A = rng.standard_normal((64, 32)).astype(np.float32)
        b = rng.standard_normal(64).astype(np.float32)
        wcache = ExecutableCache(max_size=16, store=store)
        [x] = engine.batched_lstsq([A], [b], cache=wcache, device=s.dev)
        r_w = _ratio(A, x, b)
        assert r_w < 8, ("fleet warm", r_w)
        st = store.stats()
        assert st["records_found"] >= 1 and st["deserialize_failures"] == 0, \
            st
        assert store.last_reason == NOT_A_PROGRAM, store.last_reason
        assert wcache.stats()["misses"] == 1, wcache.stats()  # recapture
        engine.batched_lstsq([A], [b], cache=wcache, device=s.dev)
        assert wcache.stats()["misses"] == 1, ("the repeat recaptured",
                                               wcache.stats())
        ccache = ExecutableCache(max_size=16, store=store)
        with faults.injected(FaultConfig(
                sites=(("serve.store", 1.0, 1),))) as harness:
            [xc] = engine.batched_lstsq([A], [b], cache=ccache,
                                        device=s.dev)
        assert harness.stats()["serve.store"]["fired"] == 1, harness.stats()
        assert store.stats()["deserialize_failures"] == 1, store.stats()
        assert _ratio(A, xc, b) < 8, "fleet corrupt"
        assert ccache.stats()["misses"] == 1, ccache.stats()
    _say(f"dryrun: fleet ok (child captured and recorded "
         f"{child_stats['puts']} key(s); parent found "
         f"{st['records_found']} record(s), a counted NOT_A_PROGRAM miss "
         "and 1 recapture, repeat 0 captures; 1 injected store corruption "
         "degraded to a counted recapture, dispatch unharmed)")


def _stage_numeric(s: _Local) -> None:
    """One injected breakdown on a cholqr2 route resolves through the
    ladder within 8x on cholqr3; the disarmed repeat is rung 0 again,
    bit for bit."""
    import numpy as np
    import torch

    from dhqr_tpu_torch import faults
    from dhqr_tpu_torch.numeric import guarded_lstsq
    from dhqr_tpu_torch.utils.config import FaultConfig

    rng = np.random.default_rng(13)
    A = rng.random((96, 12)).astype(np.float32)
    b = rng.random(96).astype(np.float32)
    g = guarded_lstsq(A, b, engine="cholqr2", guards="fallback",
                      device=s.dev)
    assert g.engine == "cholqr2" and g.escalations == 0, g
    with faults.injected(FaultConfig(sites=(("numeric.breakdown", 1.0, 1),),
                                     seed=0)) as harness:
        g2 = guarded_lstsq(A, b, engine="cholqr2", guards="fallback",
                           device=s.dev)
    assert harness.stats()["numeric.breakdown"]["fired"] == 1
    assert g2.escalations == 1 and g2.engine == "cholqr3", (
        g2.engine, [a.outcome for a in g2.attempts])
    r = _ratio(A, g2.x, b)
    assert r < 8, ("numeric fallback", r)
    g3 = guarded_lstsq(A, b, engine="cholqr2", guards="fallback",
                       device=s.dev)
    assert g3.escalations == 0, g3
    assert torch.equal(g3.x, g.x), "guarded repeat diverged"
    _say(f"dryrun: numeric ok (injected breakdown -> cholqr3 fallback "
         f"within 8x ({r:.2f}x), repeat after recovery rung 0 "
         "bit-identical)")


def _stage_obs(s: _Local) -> None:
    """A traced async stream with one injected dispatch escalation: the
    typed error carries its trace id, the flight recorder rebuilds its
    span path, the traced repeat captures nothing, and the registry
    carries the dotted names."""
    from dhqr_tpu_torch import faults, obs
    from dhqr_tpu_torch.serve import AsyncScheduler
    from dhqr_tpu_torch.serve.errors import DispatchFailed
    from dhqr_tpu_torch.utils.config import (
        FaultConfig,
        ObsConfig,
        SchedulerConfig,
    )

    acache = s.async_cache()
    kcfg = SchedulerConfig(slo_ms=30e3, flush_interval_ms=5.0,
                           max_retries=0)
    with obs.observed(ObsConfig(enabled=True, buffer_spans=2048)):
        sched = AsyncScheduler(sched_config=kcfg, cache=acache,
                               block_size=8, start=False, device=s.dev)
        with faults.injected(FaultConfig(
                sites=(("serve.dispatch", 1.0, 2),), seed=0)):
            bad = sched.submit("lstsq", s.As[0], s.bs[0], deadline=30.0)
            _poll_until(sched, [bad], "obs stage")
        err = bad.exception(timeout=0)
        assert isinstance(err, DispatchFailed), err
        assert getattr(err, "trace_id", None) == bad.trace_id, (
            "typed error lost its trace id", err)
        path = [sp["name"] for sp in obs.flight_dump(err.trace_id)["spans"]]
        assert path[0] == "submit" and path[-1] == "resolve", path
        for hop in ("flush", "dispatch", "isolate"):
            assert hop in path, (hop, path)
        misses = acache.stats()["misses"]
        futs = [sched.submit("lstsq", A, b, deadline=30.0)
                for A, b in zip(s.As, s.bs)]
        sched.drain()
        assert all(f.exception(timeout=0) is None for f in futs)
        assert acache.stats()["misses"] == misses, (
            "traced warm stream recaptured", acache.stats())
        snap = obs.registry().snapshot()
        for dotted in ("serve.cache.hits", "serve.sched.poisoned",
                       "serve.sched.completed", "numeric.guarded_calls",
                       "obs.minted"):
            assert dotted in snap, (dotted, sorted(snap))
        sched.shutdown()
    _say(f"dryrun: obs ok (typed {type(err).__name__} trace reconstructed "
         f"{len(path)} spans incl. flush/dispatch/isolate, warm traced "
         f"repeat of {len(s.As)} requests 0 captures, registry "
         f"{len(snap)} metrics)")


def _stage_xray(s: _Local) -> None:
    """Capture armed on a fresh cache: one report per captured key with
    analytic flops and a measured side or its reason, the xray.* names,
    and nothing captured on the repeat."""
    import torch

    from dhqr_tpu_torch import obs
    from dhqr_tpu_torch.obs import xray
    from dhqr_tpu_torch.serve import batched_lstsq
    from dhqr_tpu_torch.serve.cache import ExecutableCache

    xcache = ExecutableCache(max_size=16)
    with xray.captured() as xstore:
        xs = batched_lstsq(s.As[:4], s.bs[:4], block_size=8, cache=xcache,
                           device=s.dev)
        assert all(bool(torch.isfinite(x).all()) for x in xs)
        reports = xstore.reports()
        assert reports, "armed xray capture recorded no reports"
        for rep in reports:
            assert rep.analytic_flops and rep.analytic_flops > 0, rep
            assert rep.measured is not None or rep.measured_unavailable, rep
            row = rep.to_json()
            for field in ("analytic_flops", "roofline_bound"):
                assert field in row, (field, row)
        snap = obs.registry().snapshot()
        assert snap.get("xray.captures", 0) >= len(reports), snap
        before = xstore.stats()["captures"]
        batched_lstsq(s.As[:4], s.bs[:4], block_size=8, cache=xcache,
                      device=s.dev)
        assert xstore.stats()["captures"] == before, (
            "warm repeat re-captured", xstore.stats())
    flops = sum(r.analytic_flops for r in reports)
    _say(f"dryrun: xray ok ({len(reports)} captured programs introspected, "
         f"analytic {flops / 1e6:.1f} MF, warm repeat 0 captures)")


def _stage_tune(s: _Local) -> None:
    """A tiny on-device search: tune, persist, resolve, and the tuned
    lstsq within 8x, its repeat bit-identical."""
    import numpy as np
    import torch

    import dhqr_tpu_torch as dt
    from dhqr_tpu_torch.tune import PlanDB, resolve_plan, tune

    rng = np.random.default_rng(9)
    m, n = 256, 16
    with tempfile.TemporaryDirectory(prefix="dhqr_dryrun_tune_") as tmp:
        db = PlanDB(os.path.join(tmp, "plans.json"))
        res = tune("lstsq", m, n, db=db, budget=5, repeats=1, device=s.dev)
        plan = resolve_plan("lstsq", m, n, db=db, on_miss="default",
                            device=s.dev)
    assert plan is not None, "tuned plan did not persist to the DB"
    assert plan == res.plan, (plan, res.plan)
    A = rng.random((m, n)).astype(np.float32)
    b = rng.random(m).astype(np.float32)
    x = dt.lstsq(A, b, plan=plan, device=s.dev)
    r = _ratio(A, x, b)
    assert r < 8, ("tuned lstsq", r)
    x2 = dt.lstsq(A, b, plan=plan, device=s.dev)
    assert torch.equal(x, x2), "tuned lstsq repeat diverged"
    _say(f"dryrun: tune ok (winner {res.plan.describe()}, "
         f"{res.speedup:.2f}x vs static default, residual within 8x, "
         "repeat bit-identical)")


def _stage_sketch(s: _Local) -> None:
    """The sketched engine within 8x on both operators, an updatable QR's
    update/downdate round trip within 8x, and bit-identical repeats."""
    import numpy as np
    import torch

    from dhqr_tpu_torch.interop import to_numpy
    from dhqr_tpu_torch.solvers import UpdatableQR, sketched_lstsq

    rng = np.random.default_rng(17)
    A = rng.random((768, 12)).astype(np.float32)   # m/n = 64
    b = rng.random(768).astype(np.float32)
    worst = 0.0
    for op in ("countsketch", "srht"):
        x = sketched_lstsq(A, b, operator=op, device=s.dev)
        r = _ratio(A, x, b)
        assert r < 8, ("sketch", op, r)
        worst = max(worst, r)
    fact = UpdatableQR(rng.random((192, 8)).astype(np.float32),
                       device=s.dev)
    ub = rng.random(192).astype(np.float32)
    u = rng.standard_normal(192).astype(np.float32)
    v = rng.standard_normal(8).astype(np.float32)
    fact.update(u, v)
    live = to_numpy(fact.matrix)
    assert _ratio(live, fact.solve(ub), ub) < 8, "update solve"
    fact.downdate(u, v)
    assert _ratio(to_numpy(fact.matrix), fact.solve(ub), ub) < 8, \
        "round trip"
    # 768 rows take the count sketch, whose bucket sum runs in the order
    # of the operator's bucket table: bit for bit on every device.
    x2 = sketched_lstsq(A, b, device=s.dev)
    x3 = sketched_lstsq(A, b, device=s.dev)
    assert torch.equal(x2, x3), "sketched repeat diverged"
    assert _ratio(A, x3, b) < 8, "sketched repeat"
    _say(f"dryrun: sketch ok (768x12 within 8x on both operators, worst "
         f"{worst:.2f}x of oracle; update/downdate round trip within 8x, "
         "repeat bit-identical)")


def _stage_comms(s: _Local) -> None:
    """The comms-contract audit (dhqr-audit): the mesh matrix on 2 ranks
    of its own at one preset, the donation probes and the double-run
    stability check — a collective-shaped regression fails the dry run."""
    from dhqr_tpu_torch.analysis.comms_pass import run_comms_pass

    if s.n_ranks < 2:
        _say("dryrun: comms audit SKIPPED (needs >= 2 ranks: a 1-rank mesh "
             "is the pass's blind spot)")
        return
    findings = [f for f in run_comms_pass(presets=["fast"],
                                          device_counts=(2,), device=s.dev)
                if not f.suppressed]
    assert not findings, "comms audit findings:\n" + "\n".join(
        f.render() for f in findings)
    _say("dryrun: comms audit ok (contracts green at P=2, donation in place, "
         "op logs stable across two runs)")


def _stage_atlas(s: _Local) -> None:
    """The route registry's self-check, always; with >= 2 ranks the whole
    DHQR5xx drift audit (coverage, contract bijection, serve-key
    collisions run on the dry run's device, grid drift)."""
    from dhqr_tpu_torch.tune.registry import self_check

    problems = self_check()
    assert not problems, "route registry self-check:\n" + "\n".join(
        problems)
    if s.n_ranks < 2:
        _say("dryrun: atlas DHQR5xx audit SKIPPED (needs >= 2 ranks like "
             "the mesh stages; the registry self-check ran)")
        return
    from dhqr_tpu_torch.analysis.atlas import run_atlas_pass

    findings = run_atlas_pass(device=s.dev)
    assert not findings, "atlas findings:\n" + "\n".join(
        f.render() for f in findings)
    _say("dryrun: atlas ok (route registry structurally sound, DHQR501-505 "
         "green: contracts bijective, serve keys collision-free, grid "
         "inside the registry)")


def _stage_concurrency(s: _Local) -> None:
    """Lock discipline (dhqr-warden): the DHQR6xx static self-scan plus one
    armed lock-witness burst over a tiny scheduler/router stream on the
    run's device — the witnessed acquisition-order edges must be a subset
    of the committed graph with zero held-set violations."""
    from dhqr_tpu_torch.analysis.concurrency_pass import run_concurrency_pass

    stats: dict = {}
    findings = [f for f in run_concurrency_pass(witness=True, device=s.dev,
                                                stats=stats)
                if not f.suppressed]
    assert not findings, "concurrency findings:\n" + "\n".join(
        f.render() for f in findings)
    _say(f"dryrun: concurrency ok (DHQR601-604 static scan green, "
         f"lock-witness burst: {len(stats['edges'])} witnessed edges "
         f"within the committed lock_order.json graph, "
         f"{stats['violations']} held-set violations)")


_LOCAL = {"serve": _stage_serve, "async": _stage_async,
          "faults": _stage_faults, "fleet": _stage_fleet,
          "numeric": _stage_numeric, "obs": _stage_obs,
          "xray": _stage_xray, "tune": _stage_tune, "sketch": _stage_sketch,
          "comms": _stage_comms, "atlas": _stage_atlas,
          "concurrency": _stage_concurrency}


# ------------------------------------------------------------ entry points


def _device(device):
    import torch

    from dhqr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def run(n_ranks: int, device=None, stages=None) -> dict:
    """Every stage (or only ``stages``, names of :data:`STAGES`, in the
    dry run's order) on ``n_ranks`` ranks of ``device`` (None: the card);
    returns the seconds per stage (the mesh stages': the slowest rank's;
    ``"spawn"``: the rank launch and teardown around them)."""
    dev = _device(device)
    chosen = STAGES if stages is None else tuple(stages)
    unknown = sorted(set(chosen) - set(STAGES))
    if unknown:
        raise ValueError(f"unknown dry-run stages {unknown}; stages are "
                         f"{STAGES}")
    seconds: "dict[str, float]" = {}
    mesh = [s for s in MESH_STAGES if s in chosen]
    if mesh:
        sizes = [(512, 64)]
        if os.environ.get("DHQR_DRYRUN_FULL") == "1":
            sizes.append((1024, 128))
        # dhqr: ignore[DHQR008] the dry run reports each stage's real wall seconds — wall time is the measurement
        t0 = time.perf_counter()
        seconds.update(_spawn(n_ranks, dev, mesh, sizes))
        # dhqr: ignore[DHQR008] same measurement, closing read
        seconds["spawn"] = time.perf_counter() - t0 - sum(seconds.values())
    local = _Local(dev, n_ranks)
    for stage in LOCAL_STAGES:
        if stage in chosen:
            # dhqr: ignore[DHQR008] same measurement, per local stage
            t0 = time.perf_counter()
            _LOCAL[stage](local)
            # dhqr: ignore[DHQR008] same measurement, closing read
            seconds[stage] = time.perf_counter() - t0
    _say("dryrun: stage seconds " + json.dumps(
        {k: round(v, 3) for k, v in seconds.items()}))
    return seconds


def realistic(n_ranks: int, n: int = 1024, nb: int = 128,
              device=None) -> None:
    """The realistic-panel stage alone (the JAX package's ``realistic``):
    m = 2n, both layouts and cyclic + grouped lookahead at panel width
    ``nb`` on ``n_ranks`` ranks, each against LAPACK under 8x."""
    _spawn(n_ranks, _device(device), ["realistic"], [(n, nb)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dhqr_tpu_torch._dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU; default the card")
    args = ap.parse_args(argv)
    run(args.n_ranks, device=args.device)
    _say("dryrun: all paths ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
