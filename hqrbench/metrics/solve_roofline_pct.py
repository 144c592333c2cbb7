"""solve_roofline_pct: the solve's least time (Q^T b and back-substitution
against 67 TFLOP/s; H, b and x once against 3.35 TB/s) over the device
time of every operation in the solve spans."""

from hqrbench import work

SPANS = ("hqrbench.solve",)


def read(view):
    device_s = view.device_seconds(None, SPANS)
    n_solves = len(view.span_seconds(SPANS))
    if not device_s or not n_solves:
        return None
    c = view.ctx
    least = work.solve_least_seconds(c["m"], c["n"], c["item"], c["peak"])
    return 100.0 * least * n_solves / device_s
