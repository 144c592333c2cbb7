"""trailing_step_roofline_pct: the least time of the factorization's
nominal trailing work (its Householder count less its P whole panels',
against the trailing matrix read and written once per update) over the
device time of every operation attributed to the ``dhqr.trailing`` spans.
P counts the ``dhqr.panel`` spans per call, so a panel's own recursion
stays with the panel on both sides of the ratio."""

from hqrbench import program, work


def read(view):
    prog = program.of(view)
    panels = prog.whole_per_call("dhqr.panel")
    device_s = prog.device_seconds(("dhqr.trailing",))
    if panels is None or not device_s:
        return None
    c = view.ctx
    least = work.trailing_least_seconds(c["m"], c["n"], panels, c["item"],
                                        c["peak"])
    if least is None:
        return None
    return 100.0 * least * view.calls / device_s
