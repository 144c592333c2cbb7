"""panel_step_roofline_pct: the least time of the panels each call
factors over the device time of every operation attributed to the
``dhqr.panel`` spans (the kernel, and the geqrt3 recursion's GEMMs and
copies around it).

P = ``dhqr.panel`` spans per call, whole panels side by side: the panel
at column c has r = m - c rows and width nb = n / P, ``2 r nb^2 - (2/3)
nb^3`` operations against 67 TFLOP/s, its slice read and written once
against 3.35 TB/s, the larger of the two per panel."""

from hqrbench import program, work


def read(view):
    prog = program.of(view)
    panels = prog.whole_per_call("dhqr.panel")
    device_s = prog.device_seconds(("dhqr.panel",))
    if panels is None or not device_s:
        return None
    c = view.ctx
    least = work.panel_least_seconds(c["m"], c["n"], panels, c["item"],
                                     c["peak"])
    if least is None:
        return None
    return 100.0 * least * view.calls / device_s
