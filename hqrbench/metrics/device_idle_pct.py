"""device_idle_pct: the share of the traced window in which no device
operation ran on any stream, 1 - union of their intervals / window."""


def read(view):
    if not view.ops:
        return None
    return 100.0 * (1.0 - view.busy_seconds() / view.window_seconds())
