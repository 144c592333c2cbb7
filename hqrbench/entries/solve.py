"""``solve``: one A, drawn from the seed and factored by ``prog.qr(A)``
in set-up; each call is ``fact.solve(b)`` on a b it has not seen."""

from torch.profiler import record_function

from hqrbench.work import solve_flops as flops  # noqa: F401


def setup(loop) -> None:
    A = loop.inputs.matrix(*matrix_of(0))
    loop.fact = loop.prog.qr(A, device=loop.device, **loop.options)


def draw(loop, tag: str, index: int) -> tuple:
    return (loop.inputs.rhs(tag, index),)


def call(loop, b):
    with record_function("hqrbench.solve"):
        return loop.fact.solve(b), loop.fact


def matrix_of(index: int) -> "tuple[str, int]":
    return "setup", 0
