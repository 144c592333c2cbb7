"""panel_roofline_pct: the panel kernel's least time over its device time,
for the panel-class kernels launched in the factor (or lstsq) spans.

The kernel ran ``launches`` times per factorization on equal leaves side
by side (their count read from the trace), so a leaf of width w at column
c has r = m - c rows: ``2 r w^2 - (2/3) w^3`` operations against 67
TFLOP/s, its r x w slice read and written once against 3.35 TB/s, the
larger of the two per leaf."""

from hqrbench import work

SPANS = ("hqrbench.factor", "hqrbench.lstsq")


def read(view):
    kernel_s = view.device_seconds({"panel"}, SPANS)
    launches = view.count({"panel"}, SPANS)
    if not kernel_s or not view.calls or launches % view.calls:
        return None
    c = view.ctx
    least = work.panel_least_seconds(c["m"], c["n"], launches // view.calls,
                                     c["item"], c["peak"])
    if least is None:
        return None
    return 100.0 * least * view.calls / kernel_s
