"""``qr_solve``: each call is ``fact = prog.qr(A)``, then
``fact.solve(b)``, on an A and b it has not seen. Its nominal work is
``lstsq``'s: the same three counts."""

from torch.profiler import record_function

from hqrbench.work import lstsq_flops as flops  # noqa: F401


def setup(loop) -> None:
    pass


def draw(loop, tag: str, index: int) -> tuple:
    return loop.inputs.matrix(tag, index), loop.inputs.rhs(tag, index)


def call(loop, A, b):
    with record_function("hqrbench.factor"):
        fact = loop.prog.qr(A, device=loop.device, **loop.options)
    with record_function("hqrbench.solve"):
        return fact.solve(b), fact


def matrix_of(index: int) -> "tuple[str, int]":
    return "call", index
