"""DHQR401: the xray introspection smoke — the twin of
``dhqr_tpu/analysis/xray_smoke.py``.

``check`` (and the dry run) must prove that the device-observability seam
produces evidence on this device: one tiny bucket program compiled through
the serving tier's ONE compile entry (``serve.cache.ExecutableCache.
get_or_compile``) with capture armed yields an
:class:`~dhqr_tpu_torch.obs.xray.XrayReport` whose analytic, measured and
roofline fields are populated (or null WITH a reason), and whose
accounting registers under the ``xray.*`` dotted names. On the card the
H100's peak is known, so the profiled capture run, its MFU and the
roofline bound must be numbers; on the CPU they are null with a reason.
"""

from __future__ import annotations

from dhqr_tpu_torch.analysis.findings import Finding

_PATH = "dhqr_tpu_torch/obs/xray.py"

#: This pass's rule-catalogue rows.
RULES = (
    ("DHQR401", "compiled-program xray introspection smoke failed",
     "xray"),
)


def run_xray_smoke(device=None, stats: "dict | None" = None
                   ) -> "list[Finding]":
    """Compile one tiny serve bucket on ``device`` (None: the card) with
    xray capture armed; every broken invariant is one DHQR401 finding (an
    infrastructure crash is one finding too — a smoke that cannot run must
    not pass). ``stats``, when given, receives the report's row."""
    findings = []

    def bad(msg: str) -> None:
        findings.append(Finding("DHQR401", _PATH, 0, msg))

    try:
        from functools import partial

        from dhqr_tpu_torch.obs import registry
        from dhqr_tpu_torch.obs import xray as _xray
        from dhqr_tpu_torch.serve.cache import ExecutableCache
        from dhqr_tpu_torch.serve.engine import _lower_for_key, _plan_key
        from dhqr_tpu_torch.utils.config import DHQRConfig, ServeConfig
        from dhqr_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        with _xray.captured() as store:
            cache = ExecutableCache(max_size=4, store=None)
            key, _bucket = _plan_key(
                "lstsq", 1, 24, 8, "float32",
                DHQRConfig(block_size=8), ServeConfig())
            cache.get_or_compile(key, partial(_lower_for_key, key, dev))
            reports = store.reports()
            if not reports:
                bad("armed capture recorded no report for a compile "
                    "through ExecutableCache.get_or_compile — the "
                    "cache-side hook is disconnected")
                return findings
            report = reports[0]
            if not report.analytic_flops or report.analytic_flops <= 0:
                bad("XrayReport.analytic_flops missing for a serve "
                    "CacheKey — the obs.flops closed-form derivation "
                    "is disconnected")
            if report.measured is None and not report.measured_unavailable:
                bad("the measured side is None WITHOUT a reason — the "
                    "null-with-reason contract dropped")
            row = report.to_json()
            for field in ("analytic_flops", "measured_cost_analysis",
                          "roofline_bound"):
                if field not in row:
                    bad(f"XrayReport.to_json() lost the {field!r} field "
                        "the artifact rows and the regress gate key on")
            if report.roofline_bound is None and not report.roofline_reason:
                bad("roofline_bound is None without a roofline_reason")
            seconds = (report.measured or {}).get("device_seconds")
            mfu = report.mfu(seconds or 1.0)
            if report.peak_tflops is None and mfu is not None:
                bad("mfu computed without a known device peak")
            if dev.type == "cuda":
                # the card's peak is known: everything must be a number
                if not seconds:
                    bad("no profiled capture run on the card: "
                        f"{report.measured_unavailable}")
                if report.peak_tflops is None or mfu is None:
                    bad("no MFU on the card (peak "
                        f"{report.peak_tflops} TFLOP/s)")
                if report.roofline_bound is None:
                    bad("no roofline bound on the card: "
                        f"{report.roofline_reason}")
            snap = registry().snapshot()
            if not snap.get("xray.captures"):
                bad("the metrics registry snapshot carries no armed "
                    "xray.captures — the xray provider is unregistered")
            if stats is not None:
                stats.update(row, mfu=mfu if seconds else None,
                             device_seconds=seconds)
    # dhqr: ignore[DHQR006] a smoke that crashes is a finding, never a pass
    except Exception as e:
        bad(f"xray smoke crashed: {type(e).__name__}: {e}")
    return findings
