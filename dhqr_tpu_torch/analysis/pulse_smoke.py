"""DHQR402: the pulse runtime-comms smoke — the twin of
``dhqr_tpu/analysis/pulse_smoke.py``.

DHQR401 proves the device-observability seam (xray at the serve compile
entry) produces evidence; this is its comms twin: one tiny mesh
dispatch with pulse capture armed must yield a
:class:`~dhqr_tpu_torch.obs.pulse.PulseReport` whose measured / analytic /
skew / DHQR306 fields are populated (or null WITH a reason), and whose
accounting registers under the ``comms.*`` dotted names. A refactor that
disconnects the seam (drops ``observed_dispatch`` from an engine, breaks
the profiler parse, unregisters the provider) fails lint here.

The dispatch runs on a 1-rank mesh in this process (the jaxpr pass's
:func:`~dhqr_tpu_torch.analysis.jaxpr_pass.solo_meshes`), the JAX
smoke's 1-device backend: it exercises the whole seam, and on the card
the measured census must be there (NCCL's collectives are in the
profiler's trace); on the CPU the reasoned null is accepted.
"""

from __future__ import annotations

from dhqr_tpu_torch.analysis.findings import Finding

_PATH = "dhqr_tpu_torch/obs/pulse.py"

#: This pass's rule-catalogue rows. DHQR306 rides here: the
#: measured-vs-priced gate is pulse-side.
RULES = (
    ("DHQR306", "measured collective time unexplainable by volume "
     "/ interconnect bandwidth x slack (priced per ICI/DCN tier "
     "on two-tier meshes)", "pulse"),
    ("DHQR402", "pulse runtime-comms profiling smoke failed", "pulse"),
)


def run_pulse_smoke(device=None, stats: "dict | None" = None
                    ) -> "list[Finding]":
    """Dispatch one tiny mesh factorization on ``device`` (None: the card)
    with pulse armed; every broken invariant is one DHQR402 finding (a
    crash is one finding too). ``stats``, when given, receives the
    report's row."""
    findings = []

    def bad(msg: str) -> None:
        findings.append(Finding("DHQR402", _PATH, 0, msg))

    try:
        import torch

        from dhqr_tpu_torch.analysis.jaxpr_pass import solo_meshes
        from dhqr_tpu_torch.obs import pulse as _pulse
        from dhqr_tpu_torch.obs import registry
        from dhqr_tpu_torch.parallel import sharded_blocked_qr
        from dhqr_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        with solo_meshes(dev) as (meshes, _groups):
            mesh = meshes["cols"]
            A = torch.ones((16, 8), dtype=torch.float32, device=dev)
            with _pulse.pulsed() as store:
                sharded_blocked_qr(A, mesh, block_size=4)
                reports = store.reports()
                if not reports:
                    bad("armed pulse capture recorded no report for a mesh "
                        "dispatch — the observed_dispatch seam is "
                        "disconnected from the engine")
                    return findings
                report = reports[0]
                if report.measured is None \
                        and not report.measured_unavailable:
                    bad("measured collective census is None WITHOUT a "
                        "reason — the null-with-reason contract dropped")
                if dev.type == "cuda" and report.measured is None:
                    bad("no measured collective census on the card (the "
                        "profiler/trace path is broken: "
                        f"{report.measured_unavailable})")
                if report.analytic is None \
                        and not report.analytic_unavailable:
                    bad("analytic census is None without a reason — the "
                        "wire census bridge dropped")
                if not (report.analytic or {}).get("broadcast"):
                    bad("the analytic census lost the blocked engine's "
                        "broadcasts")
                if report.dhqr306 is None or "status" not in report.dhqr306:
                    bad("DHQR306 verdict block missing from the report")
                elif not report.dhqr306_pass:
                    findings.append(Finding(
                        "DHQR306", _PATH, 0,
                        "measured collective time is not explainable by "
                        "the census volume / interconnect bandwidth x "
                        f"slack on the smoke dispatch: {report.dhqr306}"))
                row = report.to_json()
                for field in ("measured", "analytic", "skew", "dhqr306",
                              "dhqr306_pass"):
                    if field not in row:
                        bad(f"PulseReport.to_json() lost the {field!r} "
                            "field the artifact rows and the pulse CLI "
                            "key on")
                # warm repeat: the same label must NOT re-measure
                captures = store.stats()["captures"]
                sharded_blocked_qr(A, mesh, block_size=4)
                if store.stats()["captures"] != captures:
                    bad("a warm repeat of the same label re-measured — "
                        "the capture-once discipline is broken")
                snap = registry().snapshot()
                if not snap.get("comms.captures"):
                    bad("the metrics registry snapshot carries no armed "
                        "comms.captures — the pulse provider is "
                        "unregistered")
                if stats is not None:
                    stats.update(row)
    # dhqr: ignore[DHQR006] a smoke that crashes is a finding, never a pass
    except Exception as e:
        bad(f"pulse smoke crashed: {type(e).__name__}: {e}")
    return findings
