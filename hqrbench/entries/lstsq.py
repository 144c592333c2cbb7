"""``lstsq``: each call is ``prog.lstsq(A, b)`` on an A and b it has not
seen; the call keeps no factorization."""

from torch.profiler import record_function

from hqrbench.work import lstsq_flops as flops  # noqa: F401


def setup(loop) -> None:
    pass


def draw(loop, tag: str, index: int) -> tuple:
    return loop.inputs.matrix(tag, index), loop.inputs.rhs(tag, index)


def call(loop, A, b):
    with record_function("hqrbench.lstsq"):
        return loop.prog.lstsq(A, b, device=loop.device, **loop.options), None


def matrix_of(index: int) -> "tuple[str, int]":
    return "call", index
