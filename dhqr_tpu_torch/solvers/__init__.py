"""Solvers built on the port's engines, at the JAX package's import paths
(``dhqr_tpu/solvers/__init__.py``): the sketched least-squares solver
(:mod:`~dhqr_tpu_torch.solvers.sketch`) and the updatable QR
(:mod:`~dhqr_tpu_torch.solvers.update`)."""

from dhqr_tpu_torch.solvers.sketch import (
    batched_sketch_program,
    count_sketch_operator,
    resolve_operator,
    sketch_dim,
    sketched_lstsq,
    srht_operator,
)
from dhqr_tpu_torch.solvers.update import (
    UpdatableQR,
    solve_program,
    update_program,
)

__all__ = [
    "UpdatableQR",
    "batched_sketch_program",
    "count_sketch_operator",
    "resolve_operator",
    "sketch_dim",
    "sketched_lstsq",
    "solve_program",
    "srht_operator",
    "update_program",
]
