"""Pulse: runtime collective profiling of the sharded tier — port of
``dhqr_tpu/obs/pulse.py``.

One :class:`PulseReport` per measured mesh dispatch pairs three sources:

* **measured collective timing** — the dispatch runs once under
  ``torch.profiler`` (CPU and, on the card, CUDA activities) on each rank;
  its NCCL kernels on the card, else its c10d operators on the host, give
  per-family times and launch counts (:func:`collective_census`). A
  profiler that refuses costs the measured side of the report, null with
  the reason, never the dispatch;
* **the analytic census** — the wire seam's record of the same run
  (:class:`~dhqr_tpu_torch.parallel.wire.WireCensus`): per family, the
  collectives, launches and bytes on the wire, and the share that crossed
  between hosts. (The JAX package walks the traced program instead.)
* **the interconnect table** — :mod:`dhqr_tpu_torch.utils.platform`.
  With a known wire the two sides close into the DHQR306 check: a
  measured collective time must be explainable by volume over bandwidth,
  times a slack (:mod:`~dhqr_tpu_torch.obs.netmodel`). A wire with no
  known bandwidth — gloo (ranks sharing one card, or the CPU), an NCCL
  rank alone — reads ``skip`` with the reason, never a made-up number.

Arming: ``ObsConfig.pulse`` / ``DHQR_OBS_PULSE`` + ``dhqr_tpu_torch.obs.
arm``, or the :func:`pulsed` scope. Disarmed, every instrumented dispatch
pays one module-global ``None`` check. Armed, each label is measured once:
its first dispatch runs twice (warm, with the fault sites suspended, then
under the profiler, whose result it returns) and later dispatches run
plain. Each rank measures its own process, so pulse must be armed on every
rank of a mesh: the measured dispatch runs its collectives twice.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

from dhqr_tpu_torch.analysis import oplog as _oplog
from dhqr_tpu_torch.obs import netmodel as _net
from dhqr_tpu_torch.utils import lockwitness as _lockwitness

__all__ = [
    "DEFAULT_SLACK",
    "PulseReport",
    "PulseStore",
    "active",
    "arm",
    "collective_census",
    "disarm",
    "format_table",
    "measure",
    "observed_dispatch",
    "pulsed",
    "rows_from_json",
]

#: DHQR306 slack over the pure bandwidth bound (the JAX package's): the
#: bound models bandwidth only, and a real collective pays launch latency
#: and synchronisation the slack absorbs.
DEFAULT_SLACK = 8.0


def parse_trace_dir(logdir: str) -> "list[dict]":
    """Raises :class:`~dhqr_tpu_torch.utils.config.NotPortedError`: the
    JAX package reads the files a ``jax.profiler`` session wrote; the port
    reads its ``torch.profiler`` events in process (:func:`measure`)."""
    from dhqr_tpu_torch.utils.config import NotPortedError

    del logdir
    raise NotPortedError(
        "obs.pulse.parse_trace_dir()", "Queue A, Not ported by design",
        reason="the port's profiler events never go through a trace "
               "directory: measure() reads them from the torch.profiler "
               "session it ran")


def collective_census(events: "list[dict]") -> dict:
    """Per-family timing and per-lane busy time of profiler events
    (``{"name", "dur" (us), "lane", "device"}`` dicts), read from the
    first source that holds a collective: the card's kernels (NCCL), else
    the backend's own worker events (``gloo:broadcast`` ...: the
    collective's execution), else every event (the c10d operators, whose
    span on the caller's thread is the enqueue). Returns ``{"families":
    {family: {"events", "time_us"}}, "lanes": {lane: {"busy_us",
    "collective_us"}}, "device_events": N}``."""
    def walk(pool) -> dict:
        families: "dict[str, dict]" = {}
        lanes: "dict[str, dict]" = {}
        for event in pool:
            dur = float(event.get("dur", 0.0) or 0.0)
            lane = lanes.setdefault(str(event.get("lane", "?")),
                                    {"busy_us": 0.0, "collective_us": 0.0})
            lane["busy_us"] += dur
            family = _net.classify_event(event.get("name", ""))
            if family:
                lane["collective_us"] += dur
                fam = families.setdefault(family,
                                          {"events": 0, "time_us": 0.0})
                fam["events"] += 1
                fam["time_us"] += dur
        return {"families": families, "lanes": lanes}

    device = [e for e in events if e.get("device")]
    backend = [e for e in events if not e.get("device")
               and str(e.get("name", "")).startswith(("gloo:", "nccl:"))]
    for pool in (device, backend, events):
        census = walk(pool)
        if census["families"]:
            break
    census["device_events"] = len(device)
    return census


@dataclasses.dataclass(frozen=True)
class PulseReport:
    """Runtime comms profile of ONE mesh dispatch on one rank (the JAX
    package's fields).

    ``measured``: collective family -> this rank's launches and seconds,
    or None with the reason in ``measured_unavailable``. ``analytic``: the
    wire census (per family: collectives, launches, wire bytes, the share
    between hosts, the uncompressed bytes), or None with a reason.
    ``skew``: the spread of busy time over this rank's lanes (streams and
    threads); the spread across ranks needs their reports side by side.
    ``dhqr306``: the measured-vs-analytic verdict. ``comms``: the
    roofline block."""

    label: str
    n_devices: int = 1
    device_kind: "str | None" = None
    wire_format: "str | None" = None
    wall_s: "float | None" = None
    measured: "dict | None" = None
    measured_unavailable: "str | None" = None
    analytic: "dict | None" = None
    analytic_unavailable: "str | None" = None
    opaque_families: "tuple[str, ...]" = ()
    skew: "dict | None" = None
    skew_unavailable: "str | None" = None
    ici_gbps: "float | None" = None
    dcn_gbps: "float | None" = None
    dhqr306: "dict | None" = None
    comms: "dict | None" = None

    @property
    def dhqr306_pass(self) -> bool:
        """Green = not red: an ``ok`` or a reasoned ``skip`` both count."""
        return (self.dhqr306 or {}).get("status") != "fail"

    def measured_collective_s(self) -> "float | None":
        if self.measured is None:
            return None
        return sum(f["time_s"] for f in self.measured.values())

    def to_json(self) -> dict:
        """JSON-ready record (null with a reason, never silently
        absent)."""
        out: dict = {"label": self.label, "n_devices": self.n_devices,
                     "device_kind": self.device_kind}
        if self.wire_format is not None:
            out["wire_format"] = self.wire_format
        if self.wall_s is not None:
            out["wall_s"] = round(self.wall_s, 6)
        out["measured"] = self.measured
        if self.measured is None:
            out["measured_unavailable"] = (
                self.measured_unavailable or "no measurement captured")
        out["analytic"] = self.analytic
        if self.analytic is None:
            out["analytic_unavailable"] = (
                self.analytic_unavailable or "no traced census captured")
        if self.opaque_families:
            out["opaque_families"] = list(self.opaque_families)
        out["skew"] = self.skew
        if self.skew is None:
            out["skew_unavailable"] = (
                self.skew_unavailable or "no per-shard lanes captured")
        if self.ici_gbps is not None:
            out["ici_gbps"] = self.ici_gbps
        if self.dcn_gbps is not None:
            out["dcn_gbps"] = self.dcn_gbps
        out["dhqr306"] = self.dhqr306
        out["dhqr306_pass"] = self.dhqr306_pass
        if self.comms is not None:
            out["comms"] = self.comms
        return out


def _check_dhqr306(measured: "dict | None", analytic: "dict | None",
                   opaque: "tuple[str, ...]", n_devices: int,
                   ici_gbps: "float | None", slack: float,
                   contract_families: "tuple | None" = None,
                   wire_format: "str | None" = None,
                   dcn_gbps: "float | None" = None,
                   link_reason: "str | None" = None) -> dict:
    """The runtime verdict (the JAX package's rules): per measured family,
    the :func:`~dhqr_tpu_torch.obs.netmodel.explain_measured` check
    against the census volume; a measured family with no census
    counterpart, or outside ``contract_families``, fails; a
    loop-opaque family skips. ``link_reason`` says why no bandwidth
    applies when ``ici_gbps`` is None."""
    verdict: dict = {"slack": slack, "checks": []}
    if wire_format is not None:
        verdict["wire_format"] = wire_format
    if link_reason is not None:
        verdict["link"] = link_reason
    if measured is None:
        verdict["status"] = "skip"
        verdict["reason"] = "no measured collective timing"
        return verdict
    failed = ok = 0
    for family in sorted(measured):
        meas = measured[family]
        if contract_families is not None \
                and family not in contract_families:
            verdict["checks"].append({
                "family": family, "status": "fail",
                "reason": f"measured collective family '{family}' is "
                "outside the dispatch's contract "
                f"({sorted(contract_families) or 'none'}) — a collective "
                "executed at runtime that the contract forbids"})
            failed += 1
            continue
        if family in opaque:
            verdict["checks"].append({
                "family": family, "status": "skip",
                "reason": "family launches inside a while-loop: volume "
                "unboundable (the PR-5 opacity rule)"})
            continue
        row = (analytic or {}).get(family)
        if row is None:
            verdict["checks"].append({
                "family": family, "status": "fail",
                "reason": f"measured collective family '{family}' has no "
                "counterpart in the wire census — the runtime executed a "
                "collective the seam did not send"})
            failed += 1
            continue
        check = _net.explain_measured(
            family, meas["time_s"], row["volume_bytes"], n_devices,
            ici_gbps or 0.0, slack, wire_format=wire_format,
            dcn_volume_bytes=row.get("dcn_volume_bytes", 0) or 0,
            dcn_gbps=dcn_gbps)
        if check["status"] == "skip" and link_reason and not ici_gbps:
            check["reason"] = link_reason
        verdict["checks"].append(check)
        if check["status"] == "fail":
            failed += 1
        elif check["status"] == "ok":
            ok += 1
    if failed:
        verdict["status"] = "fail"
    elif ok:
        verdict["status"] = "ok"
    else:
        verdict["status"] = "skip"
        verdict["reason"] = (
            (link_reason or "no per-family check could run (no known "
             "interconnect bandwidth, or no measured collectives)")
            if verdict["checks"] else "no collectives measured")
    return verdict


def _link(mesh, device_kind):
    """``(ici_gbps, dcn_gbps, reason)`` of the mesh's wire: NCCL between
    cards has the card's NVLink figure; gloo has none."""
    from dhqr_tpu_torch.utils.platform import device_dcn_gbps, \
        device_ici_gbps

    if mesh is None:
        return None, None, "no mesh: the dispatch crossed no wire"
    import torch.distributed as dist

    backend = str(dist.get_backend(mesh.group)).lower()
    if backend != "nccl":
        return None, None, (
            f"the {backend} backend carries collectives through host "
            "memory (ranks sharing one card, or the CPU): no interconnect "
            "bandwidth applies")
    if mesh.size <= 1:
        return None, None, ("one NCCL rank: no collective leaves the card")
    ici = device_ici_gbps(device_kind) if device_kind else None
    dcn = device_dcn_gbps(device_kind) if device_kind else None
    reason = None if ici else (f"no published interconnect bandwidth for "
                               f"{device_kind!r}")
    return ici, dcn, reason


def _events(prof, device_type_cuda) -> "list[dict]":
    out = []
    for e in prof.events():
        device = e.device_type == device_type_cuda
        out.append({"name": e.name,
                    "dur": float(e.time_range.elapsed_us()),
                    "lane": (f"{e.device_type.name}/{e.device_index}/"
                             f"{e.thread}"),
                    "device": bool(device)})
    return out


def measure(label: str, thunk: Callable[[], object], *, mesh=None,
            n_devices: int = 1, device_kind: "str | None" = None,
            slack: float = DEFAULT_SLACK,
            contract_families: "tuple | None" = None,
            keep_trace_dir: "str | None" = None,
            wire_format: "str | None" = None, device=None):
    """Run ``thunk`` warm (once with the fault sites suspended, absorbing
    first-call costs such as a kernel build), then once under
    ``torch.profiler`` and a wire census, and build its
    :class:`PulseReport`. Returns ``(thunk's result, report)`` — the
    profiled run's result. A thunk that raises raises; a profiler that
    refuses costs only the measured side, null with the reason.
    ``keep_trace_dir`` keeps the profiled run's Chrome trace there.

    The device measured is ``mesh.device``, or without a mesh the port's
    device rule (:func:`~dhqr_tpu_torch.utils.device.resolve_device`):
    ``device=None`` is the card, and without CUDA that raises rather than
    profile the CPU for a call that was meant for the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dhqr_tpu_torch.faults import harness as _faults
    from dhqr_tpu_torch.parallel import wire as _wire

    from dhqr_tpu_torch.utils.device import resolve_device

    if mesh is None:
        device = resolve_device(device)
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(
            f"device={device!r} differs from the mesh's device "
            f"{mesh.device}: a mesh measurement runs on mesh.device")
    else:
        device = mesh.device
    cuda = device.type == "cuda"
    if device_kind is None:
        device_kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    ici, dcn, link_reason = _link(mesh, device_kind)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    with _faults.suspended():
        thunk()
    sync()
    reason = None
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except Exception as e:  # a refusing profiler costs the report only
        reason = (f"profiler capture failed: {type(e).__name__}: {e}")
        prof = None
    with _wire.census() as cen:
        # dhqr: ignore[DHQR008] the dispatch wall clock IS the measurement (profiler event time is cross-checked against it)
        t0 = time.perf_counter()
        try:
            out = thunk()
            sync()
        finally:
            # dhqr: ignore[DHQR008] closing read of the dispatch wall clock
            wall_s = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
    events: "list[dict]" = []
    if prof is not None:
        events = _events(prof, torch.autograd.DeviceType.CUDA)
        if keep_trace_dir is not None:
            os.makedirs(keep_trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                keep_trace_dir,
                # dhqr: ignore[DHQR008] a unique trace file name, not a timing decision
                f"pulse_{os.getpid()}_{time.time_ns()}.json"))
        if not events:
            reason = "profiler trace contained no events"
    analytic = cen.families() or None
    analytic_reason = None if analytic else \
        "the dispatch sent no collective through the wire seam"

    measured = skew = comms = None
    skew_reason = reason
    if reason is None:
        census = collective_census(events)
        if census["families"]:
            measured = {family: {"launches": row["events"],
                                 "time_s": round(row["time_us"] / 1e6, 9)}
                        for family, row in sorted(census["families"].items())}
        else:
            reason = "no collective events in the profiler trace"
        lanes = {k: v for k, v in census["lanes"].items()
                 if v["collective_us"] > 0} or census["lanes"]
        if len(lanes) >= 2:
            busy = sorted(r["busy_us"] / 1e6 for r in lanes.values())
            med = busy[len(busy) // 2]
            skew = {"lanes": len(lanes), "n_devices": int(n_devices),
                    "per_lane_busy_s": [round(b, 6) for b in busy],
                    "max_over_median": round(busy[-1] / med, 4)
                    if med > 0 else None,
                    "lane_caveat": "lanes are this rank's threads and "
                    "streams, not ranks"}
            skew_reason = None
        else:
            skew_reason = (f"trace exposed {len(lanes)} lane(s) of this "
                           "rank: a spread needs >= 2")
        if measured is not None:
            comms_s = sum(f["time_s"] for f in measured.values())
            device_busy = sum(e["dur"] for e in events if e["device"]) / 1e6
            busy = device_busy if census["device_events"] else wall_s
            moved = sum(_net.wire_bytes(f, row["volume_bytes"], n_devices)
                        for f, row in (analytic or {}).items())
            comms = _net.comms_roofline(comms_s, max(busy - comms_s, 0.0),
                                        link_gbps=ici,
                                        wire_bytes_moved=moved or None)
    dhqr306 = _check_dhqr306(measured, analytic, (), n_devices, ici, slack,
                             contract_families=contract_families,
                             wire_format=wire_format, dcn_gbps=dcn,
                             link_reason=link_reason)
    report = PulseReport(
        label=str(label), n_devices=int(n_devices), device_kind=device_kind,
        wire_format=wire_format, wall_s=wall_s, measured=measured,
        measured_unavailable=reason, analytic=analytic,
        analytic_unavailable=analytic_reason, skew=skew,
        skew_unavailable=skew_reason, ici_gbps=ici, dcn_gbps=dcn,
        dhqr306=dhqr306, comms=comms)
    return out, report


class PulseStore:
    """Bounded label -> report store of one armed pulse session.
    ``begin(label)`` claims a label for measurement once per session (an
    evicted label stays claimed: the warm path never pays a second
    profile)."""

    def __init__(self, max_reports: int = 256,
                 slack: float = DEFAULT_SLACK) -> None:
        if max_reports < 1:
            raise ValueError(
                f"max_reports must be >= 1, got {max_reports}")
        self.max_reports = int(max_reports)
        self.slack = float(slack)
        self._lock = _lockwitness.make_lock("PulseStore._lock")
        self._reports: "dict[str, PulseReport]" = {}  # guarded by: _lock
        self._seen: "set[str]" = set()                # guarded by: _lock
        self._captures = 0
        self._unsupported = 0
        self._failed_306 = 0
        self._evicted = 0

    def begin(self, label: str) -> bool:
        """Claim ``label`` (False: already measured or claimed — run the
        plain path)."""
        label = str(label)
        with self._lock:
            if label in self._seen:
                return False
            self._seen.add(label)
            return True

    def capture(self, label: str, report: PulseReport) -> None:
        with self._lock:
            self._captures += 1
            if report.measured is None:
                self._unsupported += 1
            if not report.dhqr306_pass:
                self._failed_306 += 1
            self._seen.add(str(label))
            self._reports[str(label)] = report
            while len(self._reports) > self.max_reports:
                self._reports.pop(next(iter(self._reports)))
                self._evicted += 1

    def reports(self) -> "list[PulseReport]":
        with self._lock:
            return list(self._reports.values())

    def report(self, label: str) -> Optional[PulseReport]:
        with self._lock:
            return self._reports.get(str(label))

    def stats(self) -> dict:
        """Session counts (the ``comms.*`` numbers of the JAX package's
        metrics registry)."""
        with self._lock:
            reports = list(self._reports.values())
            skews = [r.skew["max_over_median"] for r in reports
                     if r.skew and r.skew.get("max_over_median")]
            coll = [r.measured_collective_s() for r in reports]
            return {
                "captures": self._captures,
                "reports": len(reports),
                "unsupported": self._unsupported,
                "dhqr306_failures": self._failed_306,
                "evicted": self._evicted,
                "capacity": self.max_reports,
                "measured_collective_s": round(
                    sum(c for c in coll if c), 6),
                "skew_max_over_median": round(max(skews), 4)
                if skews else 0.0,
            }

    def export_jsonl(self, path: str) -> int:
        """Append every resident report as one ``{"pulse": {...}}`` line."""
        reports = self.reports()
        with open(path, "a", encoding="utf-8") as fh:
            for rep in reports:
                fh.write(json.dumps({"pulse": rep.to_json()}) + "\n")
        return len(reports)


# The one armed store (or None — the fast path).
_ACTIVE: "PulseStore | None" = None
_ARM_LOCK = _lockwitness.make_lock("pulse._ARM_LOCK")


def arm(max_reports: int = 256, slack: float = DEFAULT_SLACK,
        store: "PulseStore | None" = None) -> PulseStore:
    """Arm process-wide capture (normally through ``dhqr_tpu_torch.obs.
    arm`` with ``ObsConfig.pulse``); ``store`` re-installs a store."""
    global _ACTIVE
    with _ARM_LOCK:
        _ACTIVE = store if store is not None \
            else PulseStore(max_reports=max_reports, slack=slack)
        return _ACTIVE


def disarm() -> None:
    global _ACTIVE
    with _ARM_LOCK:
        _ACTIVE = None


def active() -> Optional[PulseStore]:
    """The armed store, or None — the dispatch seams' one read."""
    return _ACTIVE


class pulsed:
    """Scope a pulse session (arm on entry, restore the previous store on
    exit; scopes nest)."""

    def __init__(self, max_reports: int = 256,
                 slack: float = DEFAULT_SLACK) -> None:
        self._store = PulseStore(max_reports=max_reports, slack=slack)
        self._previous: "PulseStore | None" = None

    def __enter__(self) -> PulseStore:
        global _ACTIVE
        with _ARM_LOCK:
            self._previous = _ACTIVE
            _ACTIVE = self._store
        return self._store

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with _ARM_LOCK:
            _ACTIVE = self._previous


def observed_dispatch(label: str, thunk: Callable[[], object], *,
                      mesh=None, n_devices: int = 1,
                      contract_families: "tuple | None" = None,
                      on_report=None, wire_format: "str | None" = None,
                      device=None):
    """The mesh engines' instrumentation seam: ``thunk()`` when pulse is
    disarmed (one ``None`` check) or ``label`` was measured already;
    measured once (:func:`measure`) when armed and new. The result is
    returned either way. ``device`` (no mesh) is what :func:`measure`
    profiles: None is the card. ``on_report(report)`` fires once, after
    the capture; its failure costs the pairing, never the dispatch."""
    if _oplog.ARMED is not None:  # the op log's shard body
        thunk = _oplog.scoped(f"shard:{label}", thunk)
    store = _ACTIVE
    if store is None:
        return thunk()
    if not store.begin(label):
        return thunk()
    out, report = measure(label, thunk, mesh=mesh, n_devices=n_devices,
                          slack=store.slack,
                          contract_families=contract_families,
                          wire_format=wire_format, device=device)
    store.capture(label, report)
    if on_report is not None:
        try:
            on_report(report)
        # dhqr: ignore[DHQR006] pairing is best-effort evidence: a callback bug must cost the pairing, never the dispatch
        except Exception:
            pass
    return out


def rows_from_json(records) -> "list[dict]":
    """Pulse blocks of parsed JSON records: any dict carrying a
    ``"pulse"`` sub-dict or sub-list, or that is a report (has
    ``dhqr306_pass``)."""
    rows = []
    for rec in records:
        if not isinstance(rec, dict):
            continue
        blk = rec.get("pulse")
        blocks = blk if isinstance(blk, list) else [blk]
        matched = False
        for one in blocks:
            if isinstance(one, dict):
                matched = True
                row = dict(one)
                row.setdefault("label", rec.get("stage")
                               or rec.get("metric") or "?")
                rows.append(row)
        if not matched and "dhqr306_pass" in rec:
            rows.append(dict(rec))
    return rows


def _fmt_ms(value) -> str:
    if not isinstance(value, (int, float)):
        return "-"
    return f"{value * 1e3:.3f}"


def format_table(rows: "list[dict]") -> str:
    """Aligned per-label table of pulse rows: label, ranks, measured
    launches per family, collective ms, comms fraction, lane skew,
    effective GB/s, DHQR306."""
    header = ("label", "P", "collectives", "comms_ms", "f(comms)",
              "skew", "effGB/s", "DHQR306")
    table = [header]
    for row in rows:
        measured = row.get("measured") or {}
        fams = " ".join(
            f"{fam}:{m.get('launches', '?')}x"
            for fam, m in sorted(measured.items())) or "-"
        comms_ms = sum(m.get("time_s", 0.0) for m in measured.values())
        comms = row.get("comms") or {}
        skew = (row.get("skew") or {}).get("max_over_median")
        verdict = (row.get("dhqr306") or {}).get("status") or (
            "ok" if row.get("dhqr306_pass") else "fail")
        table.append((
            str(row.get("label", "?"))[:48],
            str(row.get("n_devices", "?")),
            fams[:36],
            _fmt_ms(comms_ms) if measured else "-",
            (f"{comms['comms_fraction']:.2f}"
             if isinstance(comms.get("comms_fraction"), (int, float))
             else "-"),
            f"{skew:.2f}" if isinstance(skew, (int, float)) else "-",
            (f"{comms['effective_gbps']:.2f}"
             if isinstance(comms.get("effective_gbps"), (int, float))
             else "-"),
            verdict,
        ))
    widths = [max(len(r[i]) for r in table) for i in range(len(header))]
    lines = []
    for i, r in enumerate(table):
        lines.append("  ".join(
            c.ljust(w) if j in (0, 2) else c.rjust(w)
            for j, (c, w) in enumerate(zip(r, widths))))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)
