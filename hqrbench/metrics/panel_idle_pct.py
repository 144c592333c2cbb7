"""panel_idle_pct: the share of the traced window in which the device ran
nothing while the host was inside a ``dhqr.panel`` span (its self time):
100 x the device's idle stretches intersected with those host intervals,
over the window."""

from hqrbench import program


def read(view):
    prog = program.of(view)
    if not view.ops or not prog.count(("dhqr.panel",)):
        return None
    return 100.0 * prog.idle_seconds(("dhqr.panel",)) / view.window_seconds()
