"""dhqr-xray: bucket-program introspection and MFU/roofline — port of
``dhqr_tpu/obs/xray.py``.

One :class:`XrayReport` per compiled serve program pairs three sources:

* **measured**: XLA's compile-time ``cost_analysis()`` has no PyTorch
  twin, so the port measures instead. When the serve cache captures a
  key on the card, the warm-up run that the capture needs anyway runs
  once under ``torch.profiler``: the card's seconds by kernel class
  (GEMM, triangular solve, Cholesky, copies, elementwise), the kernels
  launched, and the profiler's FLOP count where it has one (its matmul
  operators). ``memory`` is the CUDA caching allocator's account of the
  capture: its peak above what was allocated before, the static inputs
  and outputs, and the graph's private pool;
* **the analytic flop model** (:mod:`dhqr_tpu_torch.obs.flops`): the
  useful-work numerator, so ``analytic / device seconds`` is the achieved
  rate and ``/ peak`` the MFU;
* **the peak table** (:mod:`dhqr_tpu_torch.utils.platform`).

What has no source stays ``None`` with its reason, as in the JAX report:
the profiler counts no bytes moved, so ``bytes accessed`` and the
roofline position are ``None`` with that reason; on the CPU nothing is
captured or profiled, and ``measured`` / ``memory`` say so.

Capture discipline, as in the JAX package: the serve cache consults
:func:`active` on its miss path only, so warm dispatches pay nothing, and
capture never raises into the compile that triggered it. Arm with
``ObsConfig(xray=True)`` / ``DHQR_OBS_XRAY`` + ``dhqr_tpu_torch.obs.arm``,
or scope with :func:`captured`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from dhqr_tpu_torch.obs import flops as _flops
from dhqr_tpu_torch.utils import lockwitness as _lockwitness

__all__ = [
    "XrayReport",
    "XrayStore",
    "active",
    "arm",
    "captured",
    "disarm",
    "format_table",
    "profile_run",
    "report_for",
    "rows_from_json",
]

#: Why the port's measured side has no byte count.
BYTES_REASON = ("torch.profiler counts no bytes moved by a kernel, so the "
                "program has no measured bytes accessed")
#: The roofline's basis on a device whose peak is known: the profiler
#: counts no bytes, so the intensity is over the key's analytic bytes.
ANALYTIC_BYTES_REASON = ("intensity over the key's analytic bytes (each "
                         "input read once, each output written once): "
                         "torch.profiler counts no bytes moved")
#: Why a CPU program has no measured side.
CPU_REASON = ("the CPU runs the bucket program eagerly: nothing is "
              "captured, so no profiled capture run exists")
#: Why a CPU program has no memory side.
CPU_MEMORY_REASON = ("the CPU has no CUDA caching allocator to account the "
                     "capture")


@dataclasses.dataclass(frozen=True)
class XrayReport:
    """Introspection of ONE compiled serve program (the fields of the JAX
    package's report).

    ``measured`` is the profiled capture run (:func:`profile_run`:
    ``flops``, ``bytes accessed`` (None), ``device_seconds``, ``kernels``,
    ``by_class``, ``program``), ``memory`` the allocator's account of the
    capture; each is None with its reason in ``measured_unavailable`` /
    ``memory_unavailable``. ``analytic_flops`` is the closed-form
    useful-work count of the key. Roofline fields need a measured byte
    count, which the profiler does not give: on a device whose peak and
    bandwidth are known the intensity is over the key's analytic bytes
    (``roofline_reason`` says so), elsewhere ``roofline_bound`` is None
    and ``roofline_reason`` says why. :meth:`mfu` and
    :meth:`achieved_gflops` pair the report with measured seconds (the
    profiled run's ``device_seconds``)."""

    key: str
    analytic_flops: "float | None" = None
    measured: "dict | None" = None
    memory: "dict | None" = None
    measured_unavailable: "str | None" = None
    memory_unavailable: "str | None" = None
    device_kind: "str | None" = None
    dtype: "str | None" = None
    peak_tflops: "float | None" = None
    hbm_gbps: "float | None" = None
    intensity_flops_per_byte: "float | None" = None
    ridge_flops_per_byte: "float | None" = None
    roofline_bound: "str | None" = None
    roofline_reason: "str | None" = None
    ceiling_gflops: "float | None" = None
    compile_seconds: "float | None" = None
    # Round 16 (dhqr-pulse): the COMMS side of the roofline — the
    # ``netmodel.comms_roofline`` block a paired pulse measurement
    # fills (comms_s / compute_s / comms_fraction / comms_bound /
    # effective_gbps). None for programs with no comms measurement;
    # to_json then stamps the reason so artifact rows stay
    # null-with-reason on both halves of the roofline.
    comms: "dict | None" = None

    def mfu(self, seconds: float) -> "float | None":
        """Analytic-flops MFU for one execution taking ``seconds``
        (None without a known peak or analytic count)."""
        if not seconds or not self.analytic_flops or not self.peak_tflops:
            return None
        return (self.analytic_flops / seconds) / (self.peak_tflops * 1e12)

    def achieved_gflops(self, seconds: float) -> "float | None":
        if not seconds or not self.analytic_flops:
            return None
        return self.analytic_flops / seconds / 1e9

    def to_json(self) -> dict:
        """JSON-ready record — the shape artifact rows and the ``obs xray``
        table speak, its keys the JAX package's."""
        out = {"key": self.key, "analytic_flops": self.analytic_flops}
        if self.measured is not None:
            out["measured_cost_analysis"] = {
                k.replace(" ", "_"): v for k, v in self.measured.items()}
        else:
            out["measured_cost_analysis"] = None
            out["measured_unavailable"] = (
                self.measured_unavailable or "no analysis captured")
        if self.memory is not None:
            out["memory"] = dict(self.memory)
        else:
            out["memory"] = None
            out["memory_unavailable"] = (
                self.memory_unavailable or "no analysis captured")
        for field in ("device_kind", "dtype", "peak_tflops", "hbm_gbps",
                      "intensity_flops_per_byte", "ridge_flops_per_byte",
                      "roofline_bound", "roofline_reason",
                      "ceiling_gflops", "compile_seconds"):
            val = getattr(self, field)
            if val is not None:
                out[field] = val
        if self.roofline_bound is None and "roofline_reason" not in out:
            out["roofline_reason"] = "no roofline basis captured"
        out.setdefault("roofline_bound", None)
        if self.comms is not None:
            out["comms"] = dict(self.comms)
        else:
            out["comms"] = None
            out["comms_reason"] = ("no paired pulse measurement for this "
                                   "program (no collectives measured, "
                                   "single-device, or DHQR_OBS_PULSE "
                                   "disarmed)")
        return out


def _roofline(analytic, measured, peak_tflops, hbm_gbps):
    """(intensity, ridge, bound, reason, ceiling), as the JAX package's:
    intensity is the analytic flop count over the measured bytes — which
    the port's profiler does not give, so the bound is None with
    :data:`BYTES_REASON`."""
    flops = analytic if analytic else (
        measured.get("flops") if measured else None)
    bytes_accessed = measured.get("bytes accessed") if measured else None
    if not flops or not bytes_accessed:
        return (None, None, None, BYTES_REASON, None)
    intensity = flops / bytes_accessed
    if not peak_tflops or not hbm_gbps:
        return (round(intensity, 3), None, None,
                "no published peak/bandwidth for this device_kind",
                None)
    ridge = (peak_tflops * 1e12) / (hbm_gbps * 1e9)
    bound = "compute" if intensity >= ridge else "memory"
    ceiling = min(peak_tflops * 1e3, intensity * hbm_gbps)
    return (round(intensity, 3), round(ridge, 3), bound, None,
            round(ceiling, 1))


def _analytic_for_key(key) -> "float | None":
    """Closed-form flop count for a serve :class:`CacheKey` (duck-typed
    on its fields so this module never imports serve); None for keys
    the model does not describe (other keys pass analytic explicitly via
    :func:`report_for`)."""
    kind = getattr(key, "kind", None)
    batch = getattr(key, "batch", None)
    m, n = getattr(key, "m", None), getattr(key, "n", None)
    if None in (kind, batch, m, n):
        return None
    if kind == "qr":
        return _flops.batched_qr_flops(batch, m, n)
    if kind == "lstsq":
        return _flops.batched_lstsq_flops(
            batch, m, n, refine=getattr(key, "refine", 0) or 0)
    if kind == "sketch":
        # the key's sketch triple carries s, and refine is the CGLS
        # iteration count
        sk = getattr(key, "sketch", None)
        if not sk:
            return None
        return batch * _flops.sketched_lstsq_flops(
            m, n, sk[0], refine=getattr(key, "refine", 0) or 0)
    return None


def _analytic_bytes_for_key(key) -> "int | None":
    """The least bytes a serve key's program moves: its inputs read once
    and its outputs written once (qr: A in, H and alpha out; lstsq and
    sketch: A and b in, x out), at the key's dtype; None for other keys."""
    kind = getattr(key, "kind", None)
    batch = getattr(key, "batch", None)
    m, n = getattr(key, "m", None), getattr(key, "n", None)
    if None in (kind, batch, m, n):
        return None
    itemsize = {"float32": 4, "float64": 8, "complex64": 8,
                "complex128": 16}.get(str(getattr(key, "dtype", "")))
    if itemsize is None:
        return None
    words = 2 * m * n + n if kind == "qr" else m * n + m + n
    return batch * words * itemsize


def _kernel_class(name: str) -> str:
    """The class of one CUDA kernel, by its name."""
    low = name.lower()
    for cls, marks in (("gemm", ("gemm", "cutlass", "matmul", "gemv", "dot")),
                       ("trsm", ("trsm", "trsv")),
                       ("cholesky", ("potrf", "chol")),
                       ("copy", ("copy", "memcpy", "memset", "fill",
                                 "cat", "index"))):
        if any(mark in low for mark in marks):
            return cls
    return "elementwise"


def profile_run(fn, device) -> "tuple[dict | None, str | None]":
    """Run ``fn()`` once under ``torch.profiler`` (host and card) and
    return ``(measured, None)`` — ``flops`` (the profiler's count, summed
    over the operators that carry one; None when none does),
    ``bytes accessed`` (None: :data:`BYTES_REASON`), ``device_seconds``
    (the kernels' summed time), ``kernels`` and ``by_class`` — or
    ``(None, reason)`` when the profiler refuses or sees no kernel. A
    failing ``fn`` raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA], with_flops=True)
        prof.__enter__()
    except Exception as e:  # a refusing profiler costs the report only
        fn()
        return None, f"profiler capture failed: {type(e).__name__}: {e}"
    try:
        fn()
        torch.cuda.synchronize(device)
    finally:
        prof.__exit__(None, None, None)
    by_class: "dict[str, list]" = {}
    flops = 0
    kernels = 0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            row = by_class.setdefault(_kernel_class(e.key), [0.0, 0])
            row[0] += e.self_device_time_total / 1e6
            row[1] += e.count
            kernels += e.count
        else:
            flops += getattr(e, "flops", 0) or 0
    if not kernels:
        return None, "the profiler trace holds no kernel"
    return {"flops": float(flops) if flops else None,
            "bytes accessed": None,
            "device_seconds": round(sum(r[0] for r in by_class.values()), 9),
            "kernels": kernels,
            "by_class": {k: {"seconds": round(v[0], 9), "kernels": v[1]}
                         for k, v in sorted(by_class.items())}}, None


def report_for(key, compiled, *, analytic_flops: "float | None" = None,
               device_kind: "str | None" = None,
               dtype: "str | None" = None,
               compile_seconds: "float | None" = None,
               comms: "dict | None" = None) -> XrayReport:
    """Build the :class:`XrayReport` for one compiled serve program.

    ``compiled`` carries what its capture recorded (``measured`` /
    ``measured_reason``, ``memory`` / ``memory_reason``, ``device``: the
    serve cache's programs do); an object without them reads as
    unmeasured, with the reason. Serve ``CacheKey``\\ s get their analytic
    flop count derived; pass ``analytic_flops`` for anything else.
    Degrades field by field and never raises."""
    from dhqr_tpu_torch.utils.platform import (device_hbm_gbps,
                                               device_kind as _kind_of,
                                               device_peak_tflops)

    measured = getattr(compiled, "measured", None)
    reason = None if measured is not None else getattr(
        compiled, "measured_reason", None) or "no profiled capture run"
    memory = getattr(compiled, "memory", None)
    mem_reason = None if memory is not None else getattr(
        compiled, "memory_reason", None) or "no capture accounted"
    if analytic_flops is None:
        analytic_flops = _analytic_for_key(key)
    if device_kind is None:
        device = getattr(compiled, "device", None)
        try:
            device_kind = _kind_of(device) if device is not None else None
        except Exception:  # an unprobeable device reads as unknown
            device_kind = None
    if dtype is None:
        dtype = str(getattr(key, "dtype", None) or "") or None
    peak = device_peak_tflops(device_kind, dtype or "float32") \
        if device_kind else None
    bw = device_hbm_gbps(device_kind) if device_kind else None
    intensity, ridge, bound, roof_reason, ceiling = _roofline(
        analytic_flops, measured, peak, bw)
    nbytes = _analytic_bytes_for_key(key)
    if bound is None and peak and bw and nbytes \
            and not (measured or {}).get("bytes accessed"):
        intensity, ridge, bound, _, ceiling = _roofline(
            analytic_flops, {"bytes accessed": nbytes}, peak, bw)
        roof_reason = ANALYTIC_BYTES_REASON
    return XrayReport(
        key=str(key), analytic_flops=analytic_flops, measured=measured,
        memory=memory, measured_unavailable=reason,
        memory_unavailable=mem_reason,
        device_kind=device_kind, dtype=dtype, peak_tflops=peak,
        hbm_gbps=bw, intensity_flops_per_byte=intensity,
        ridge_flops_per_byte=ridge, roofline_bound=bound,
        roofline_reason=roof_reason, ceiling_gflops=ceiling,
        compile_seconds=(round(compile_seconds, 4)
                         if compile_seconds is not None else None),
        comms=comms,
    )


class XrayStore:
    """Bounded per-cache-key report store for one armed capture session.

    ``capture`` is called by the serve cache's compile path (under the
    cache lock, so a report's insertion order is its compile order);
    insertion past ``max_reports`` evicts the oldest (counted)."""

    def __init__(self, max_reports: int = 512) -> None:
        if max_reports < 1:
            raise ValueError(
                f"max_reports must be >= 1, got {max_reports}")
        self.max_reports = int(max_reports)
        self._lock = _lockwitness.make_lock("XrayStore._lock")
        self._reports: "dict[str, XrayReport]" = {}  # guarded by: _lock
        self._captures = 0
        self._unsupported = 0
        self._evicted = 0
        self._failed = 0

    def capture(self, key, compiled,
                compile_seconds: "float | None" = None) -> None:
        """Introspect one freshly compiled executable. Never raises."""
        try:
            report = report_for(key, compiled,
                                compile_seconds=compile_seconds)
        except Exception:  # costs the report, never the program
            with self._lock:
                self._captures += 1
                self._failed += 1
            return
        with self._lock:
            self._captures += 1
            if report.measured is None:
                self._unsupported += 1
            self._reports[report.key] = report
            while len(self._reports) > self.max_reports:
                self._reports.pop(next(iter(self._reports)))
                self._evicted += 1

    def reports(self) -> "list[XrayReport]":
        """Resident reports in capture order (oldest first)."""
        with self._lock:
            return list(self._reports.values())

    def report(self, key) -> Optional[XrayReport]:
        with self._lock:
            return self._reports.get(str(key))

    def attach_comms(self, key, comms: dict) -> None:
        """Pair a pulse measurement's comms-roofline block into the
        resident report for ``key`` (the serve dispatch seam calls this
        once, after a label's pulse capture). A key with no resident
        report is a no-op."""
        with self._lock:
            rep = self._reports.get(str(key))
            if rep is not None:
                self._reports[str(key)] = dataclasses.replace(
                    rep, comms=dict(comms))

    def stats(self) -> dict:
        """The ``xray.*`` numbers the metrics registry exports."""
        with self._lock:
            return {
                "captures": self._captures,
                "reports": len(self._reports),
                "unsupported": self._unsupported,
                "evicted": self._evicted,
                "failed": self._failed,
                "capacity": self.max_reports,
            }

    def export_jsonl(self, path: str) -> int:
        """Append every resident report as one JSON line each (the
        file format ``python -m dhqr_tpu_torch.obs xray`` renders); returns
        the number written."""
        reports = self.reports()
        with open(path, "a", encoding="utf-8") as fh:
            for rep in reports:
                fh.write(json.dumps({"xray": rep.to_json()}) + "\n")
        return len(reports)


# The one armed store (or None — the fast path); same module-global
# discipline as faults.harness / obs.trace.
_ACTIVE: "XrayStore | None" = None
_ARM_LOCK = _lockwitness.make_lock("xray._ARM_LOCK")


def arm(max_reports: int = 512) -> XrayStore:
    """Arm process-wide capture (normally reached via
    ``dhqr_tpu_torch.obs.arm`` with ``ObsConfig.xray`` /
    ``DHQR_OBS_XRAY``)."""
    global _ACTIVE
    with _ARM_LOCK:
        _ACTIVE = XrayStore(max_reports=max_reports)
        return _ACTIVE


def disarm() -> None:
    global _ACTIVE
    with _ARM_LOCK:
        _ACTIVE = None


def active() -> Optional[XrayStore]:
    """The armed store, or None — THE hot-path read (the serve cache
    consults it on compile misses only)."""
    return _ACTIVE


class captured:
    """Scope an xray capture session (arm on entry, restore the
    previous store on exit; scopes nest):

    >>> with xray.captured() as store:
    ...     serve.prewarm(...)
    ...     store.reports()
    """

    def __init__(self, max_reports: int = 512) -> None:
        self._store = XrayStore(max_reports=max_reports)
        self._previous: "XrayStore | None" = None

    def __enter__(self) -> XrayStore:
        global _ACTIVE
        with _ARM_LOCK:
            self._previous = _ACTIVE
            _ACTIVE = self._store
        return self._store

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with _ARM_LOCK:
            _ACTIVE = self._previous


# ------------------------------------------------------------------ table

def rows_from_json(records) -> "list[dict]":
    """Extract xray blocks from parsed JSON records (bench summaries,
    artifact rows, ``export_jsonl`` lines): any dict carrying an
    ``"xray"`` sub-dict or sub-list, or that is a report (has
    ``analytic_flops``)."""
    rows = []
    for rec in records:
        if not isinstance(rec, dict):
            continue
        blk = rec.get("xray")
        blocks = blk if isinstance(blk, list) else [blk]
        matched = False
        for one in blocks:
            if isinstance(one, dict):
                matched = True
                row = dict(one)
                row.setdefault("key", rec.get("stage") or rec.get("metric")
                               or rec.get("key") or "?")
                rows.append(row)
        if not matched and "analytic_flops" in rec:
            rows.append(dict(rec))
    return rows


def _fmt_flops(value) -> str:
    if not isinstance(value, (int, float)):
        return "-"
    if value >= 1e12:
        return f"{value / 1e12:.2f}T"
    if value >= 1e9:
        return f"{value / 1e9:.2f}G"
    if value >= 1e6:
        return f"{value / 1e6:.2f}M"
    return f"{value:.0f}"


def format_table(rows: "list[dict]") -> str:
    """Aligned per-key table of xray rows (the ``obs xray`` CLI output).

    Columns: key, analytic flops, measured flops, bytes accessed,
    the card's milliseconds in the profiled run (the port's measured
    side; "-" in the JAX package's rows), intensity (flop/byte),
    roofline bound, ceiling GF/s, MFU (when the row carries one),
    compile seconds, and the comms side of the roofline (the paired
    pulse measurement's comms fraction, "-" for rows without one)."""
    header = ("key", "analytic", "measured", "bytes", "dev_ms", "f/B",
              "bound", "ceilGF", "mfu", "compile_s", "f(comms)")
    table = [header]
    for row in rows:
        meas = row.get("measured_cost_analysis") or {}
        mfu = row.get("mfu")
        comms = row.get("comms") or {}
        table.append((
            str(row.get("key", "?"))[:48],
            _fmt_flops(row.get("analytic_flops")),
            _fmt_flops(meas.get("flops")),
            _fmt_flops(meas.get("bytes_accessed")),
            (f"{meas['device_seconds'] * 1e3:.3f}"
             if isinstance(meas.get("device_seconds"), (int, float))
             else "-"),
            (f"{row['intensity_flops_per_byte']:.1f}"
             if isinstance(row.get("intensity_flops_per_byte"),
                           (int, float)) else "-"),
            str(row.get("roofline_bound") or "-"),
            (f"{row['ceiling_gflops']:.0f}"
             if isinstance(row.get("ceiling_gflops"), (int, float))
             else "-"),
            (f"{mfu:.4f}" if isinstance(mfu, (int, float)) else "-"),
            (f"{row['compile_seconds']:.2f}"
             if isinstance(row.get("compile_seconds"), (int, float))
             else "-"),
            (f"{comms['comms_fraction']:.2f}"
             if isinstance(comms.get("comms_fraction"), (int, float))
             else "-"),
        ))
    widths = [max(len(r[i]) for r in table) for i in range(len(header))]
    lines = []
    for i, r in enumerate(table):
        lines.append("  ".join(
            c.ljust(w) if j == 0 else c.rjust(w)
            for j, (c, w) in enumerate(zip(r, widths))))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)
