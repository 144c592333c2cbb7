"""panel_f64_step_roofline_pct: the least time of the configuration's own
panels (as ``panel_f64_roofline_pct`` counts them) over the device time
of every operation attributed to the ``dhqr.panel`` spans: the kernel and
whatever the panel step runs around it."""

from hqrbench import program
from hqrbench.metrics.panel_f64_roofline_pct import least_seconds


def read(view):
    device_s = program.of(view).device_seconds(("dhqr.panel",))
    if not device_s or not view.calls:
        return None
    return 100.0 * least_seconds(view.ctx) * view.calls / device_s
