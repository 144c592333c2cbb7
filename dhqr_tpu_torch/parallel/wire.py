"""The collective seam of the port's sharded tier — the twin of
``dhqr_tpu/parallel/wire.py`` with ``comms=None`` only.

Every collective in ``dhqr_tpu_torch/parallel/`` goes through this module
(``tests/test_torch_guards.py`` scans for any other call). The JAX seam
chooses a collective's wire format; ``comms=None`` is its verbatim
passthrough to the raw collective, and that is the one format ported:

* :func:`wire_broadcast` — the owner's panel to every rank, the twin of
  the JAX engines' one-hot ``wire_psum(jnp.where(mine, x, 0))``
  (``sharded_qr.py:234-236``): ``dist.broadcast`` from the owner;
* :func:`wire_psum` — ``all_reduce(SUM)``, for dense reductions (the
  CholeskyQR Gram) and for a one-hot group gather with several owners;
* :func:`wire_all_gather` — ``all_gather`` into a list, then ``cat``.

Each reduces or fills in place where the collective does and returns the
result; with ``async_op=True`` it returns a :class:`Pending` whose
``wait()`` returns it, so a schedule can put a collective in flight
behind a GEMM. Complex tensors ride as their real view
(``torch.distributed`` does that for these three collectives). Any other
``comms`` (the compressed ``"bf16"`` / ``"int8"`` / ``"dcn:*"`` wire, its
quantizers and integrity tags) raises
:class:`~dhqr_tpu_torch.utils.config.NotPortedError`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dhqr_tpu_torch.utils.config import NotPortedError

COMPRESSED_ITEM = ("Queue A item 11 (the compressed wire, with the "
                   "two-tier pod mesh)")


def check_comms(comms) -> None:
    """Refuse every wire format but the uncompressed passthrough."""
    if comms is not None:
        raise NotPortedError(f"comms={comms!r} (the compressed wire)",
                             COMPRESSED_ITEM)


class Pending:
    """A collective in flight: ``wait()`` blocks (on the card: makes the
    current stream wait) until it is done and returns its result."""

    def __init__(self, work, finish):
        self._work = work
        self._finish = finish

    def wait(self):
        self._work.wait()
        return self._finish()


def _done(work, async_op: bool, finish):
    if async_op:
        return Pending(work, finish)
    return finish()


def wire_broadcast(x: torch.Tensor, src: int, mesh, comms=None, *,
                   async_op: bool = False):
    """``x`` of mesh rank ``src`` to every rank, in place in every rank's
    ``x`` (a buffer of the same shape and dtype on the receivers)."""
    check_comms(comms)
    work = dist.broadcast(x, mesh.global_rank(src), group=mesh.group,
                          async_op=async_op)
    return _done(work, async_op, lambda: x)


def wire_psum(x: torch.Tensor, mesh, comms=None, *, async_op: bool = False):
    """The sum of every rank's ``x``, in place in each ``x``."""
    check_comms(comms)
    work = dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group,
                           async_op=async_op)
    return _done(work, async_op, lambda: x)


def wire_all_gather(x: torch.Tensor, mesh, comms=None, *, dim: int = 0,
                    async_op: bool = False):
    """Every rank's ``x`` (same shape on every rank), concatenated along
    ``dim`` in rank order."""
    check_comms(comms)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    work = dist.all_gather(parts, x, group=mesh.group, async_op=async_op)
    return _done(work, async_op, lambda: torch.cat(parts, dim))
