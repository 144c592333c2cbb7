"""solve_step_roofline_pct: the solve's least time (Q^T b and
back-substitution against 67 TFLOP/s; H, b and x once against 3.35 TB/s)
for each ``dhqr.apply_qt`` span, over the device time of every operation
attributed to the ``dhqr.apply_qt`` and ``dhqr.back_substitute`` spans."""

from hqrbench import program, work

SPANS = ("dhqr.apply_qt", "dhqr.back_substitute")


def read(view):
    prog = program.of(view)
    solves = prog.count(("dhqr.apply_qt",))
    device_s = prog.device_seconds(SPANS)
    if not solves or not device_s:
        return None
    c = view.ctx
    least = work.solve_least_seconds(c["m"], c["n"], c["item"], c["peak"])
    return 100.0 * least * solves / device_s
