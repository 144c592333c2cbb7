"""panel_f64_roofline_pct: the least time of the configuration's own
panels over the device time of the panel-class kernels launched in the
factor spans.

The panels are the configuration's, not the kernel's launches, so the
yardstick reads the same work whatever leaf width the program picks: the
panel at column c is BLOCK columns wide (the last one what is left) and
has r = m - c rows, ``2 r w^2 - (2/3) w^3`` operations against 67
TFLOP/s (``peaks.json``; for float64 the FP64 tensor-core rate, the most
any float64 kernel reaches on the card), its r x w slice read and written
once against 3.35 TB/s, the larger of the two per panel."""

from hqrbench import work

# The configuration's panel width (its ``assumed.block_size``); part of
# the yardstick, so it is fixed here and not read from the program.
BLOCK = 128
SPANS = ("hqrbench.factor",)


def panels(m: int, n: int) -> "list[tuple[int, int]]":
    """``[(rows, width), ...]`` of the BLOCK-wide panels of an (m, n)
    factorization, the last one narrower where BLOCK does not divide n."""
    return [(m - c, min(BLOCK, n - c)) for c in range(0, min(m, n), BLOCK)]


def least_seconds(ctx: dict) -> float:
    """Least time of one factorization's panels, each held to its own
    bound."""
    return sum(work.least_seconds(work.qr_flops(r, w),
                                  work.panel_bytes(r, w, ctx["item"]),
                                  ctx["peak"])
               for r, w in panels(ctx["m"], ctx["n"]))


def read(view):
    kernel_s = view.device_seconds({"panel"}, SPANS)
    if not kernel_s or not view.calls:
        return None
    return 100.0 * least_seconds(view.ctx) * view.calls / kernel_s
