"""trailing_roofline_pct: the least time of the factorization's nominal
trailing work (its Householder count less the panel leaves' counts,
against the trailing matrix read and written once per update) over the
device time of the gemm- and trsm-class kernels in the factor spans."""

from hqrbench import work

SPANS = ("hqrbench.factor",)


def read(view):
    kernel_s = view.device_seconds({"gemm", "trsm"}, SPANS)
    launches = view.count({"panel"}, SPANS)
    if not kernel_s or not view.calls or launches % view.calls:
        return None
    c = view.ctx
    least = work.trailing_least_seconds(c["m"], c["n"],
                                        launches // view.calls, c["item"],
                                        c["peak"])
    if least is None:
        return None
    return 100.0 * least * view.calls / kernel_s
