"""TSQR — port of ``dhqr_tpu/ops/tsqr.py``, the communication-avoiding QR
for tall-skinny matrices:

    leaf stage:    split rows into blocks; QR each block independently;
    combine stage: stack the per-block R factors (n_blocks * n x n) and QR
                   once.

For least squares the orthogonal factors never materialize: each stage also
carries c = Q^H b, so ``x = R^{-1} c[:n]`` drops out of the tree.

The JAX engine vmaps the leaves; the port loops over them. Each leaf, and
the combine stack, is a blocked QR through the blocked engine, so on the
card every leaf panel launches the Hopper panel kernel
(``use_pallas`` is resolved against the leaf height, as in the JAX
package). :func:`tsqr_panel_plans` lists the panels of both stages.
Both stages factor through
:func:`~dhqr_tpu_torch.ops.differentiable.householder_factor`, so TSQR is
differentiable in A and b as the composition of its stages.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch.ops.blocked import (
    DEFAULT_BLOCK_SIZE,
    _apply_qt_impl,
    _resolve_kernel,
    panel_plan,
)
from dhqr_tpu_torch.ops.differentiable import householder_factor
from dhqr_tpu_torch.ops.householder import DEFAULT_PRECISION
from dhqr_tpu_torch.ops.solve import _back_substitute, as_matrix_rhs, r_matrix
from dhqr_tpu_torch.precision import (
    apply_policy_to_factor_args,
    resolve_policy,
)
from dhqr_tpu_torch.utils.device import as_tensor, check_fp32_matmul


def _leaf_factor(Ai, bi, nb, precision, kernel=False, trailing_precision=None):
    """One row block: packed QR (in place in ``Ai``, a copy, when autograd
    does not follow it) reduced to its (n, n) R head, and Q^H b's (n, k)
    head when ``bi`` is given (else None)."""
    n = Ai.shape[1]
    H, alpha = householder_factor(Ai, nb, in_place=True, kernel=kernel,
                                  precision=precision,
                                  trailing_precision=trailing_precision)
    c = None if bi is None else _apply_qt_impl(H, bi, nb, precision)[:n]
    return r_matrix(H, alpha), c


def _tsqr_factor(A, B, n_blocks, nb, precision, kernel=False,
                 trailing_precision=None):
    """Both stages: factor each row block (with B's rows when B is given),
    then QR the stacked R heads in place. Returns ``(H2, alpha2, c2)``,
    c2 the combined Q^H B (None without B)."""
    rows = A.shape[0] // n_blocks
    heads = [_leaf_factor(A[i * rows:(i + 1) * rows].clone(),
                          None if B is None else B[i * rows:(i + 1) * rows],
                          nb, precision, kernel, trailing_precision)
             for i in range(n_blocks)]
    return _combine_factor(torch.cat([R for R, _ in heads]),
                           None if B is None else torch.cat(
                               [c for _, c in heads]),
                           nb, precision, kernel, trailing_precision)


def _combine_factor(Rstack, cstack, nb, precision, kernel=False,
                    trailing_precision=None):
    """The combine stage: QR of the stacked R heads (in place in
    ``Rstack``, as the leaves) and Q^H of the stacked c heads (None
    without them).
    Returns ``(H2, alpha2, c2)``; the row-sharded TSQR shares it."""
    H2, alpha2 = householder_factor(Rstack, nb, in_place=True, kernel=kernel,
                                    precision=precision,
                                    trailing_precision=trailing_precision)
    c2 = None if cstack is None else _apply_qt_impl(H2, cstack, nb, precision)
    return H2, alpha2, c2


def _tsqr_lstsq_impl(A, b, n_blocks, block_size, precision, kernel=False,
                     trailing_precision=None):
    B, restore = as_matrix_rhs(b)
    H2, alpha2, c2 = _tsqr_factor(A, B, n_blocks, block_size, precision,
                                  kernel, trailing_precision)
    return restore(_back_substitute(H2, alpha2, c2))


def _tsqr_r_impl(A, n_blocks, block_size, precision, kernel=False,
                 trailing_precision=None):
    H2, alpha2, _ = _tsqr_factor(A, None, n_blocks, block_size, precision,
                                 kernel, trailing_precision)
    return r_matrix(H2, alpha2)


def _prepare(A, n_blocks, block_size, precision, use_pallas,
             trailing_precision, policy, device):
    """Shared argument handling of the two entry points: (A, precision,
    trailing_precision, kernel)."""
    precision, trailing_precision = apply_policy_to_factor_args(
        policy, precision, trailing_precision,
        default_precision=DEFAULT_PRECISION)
    A = as_tensor(A, device)
    check_fp32_matmul(A.device)
    m, n = A.shape
    _check_tsqr_shape(m, n, n_blocks)
    kernel = _resolve_kernel(use_pallas, m // int(n_blocks), A.dtype,
                             A.device)
    return A, precision, trailing_precision, kernel


def tsqr_lstsq(A, b, n_blocks: int = 8, block_size: int = DEFAULT_BLOCK_SIZE,
               precision: str = DEFAULT_PRECISION, use_pallas: str = "auto",
               trailing_precision: "str | None" = None, policy=None,
               device=None) -> torch.Tensor:
    """Least squares via TSQR: ``x = argmin ||A x - b||`` for m >> n.

    ``b`` may be (m,) or (m, k). Requires m divisible by ``n_blocks`` with
    each block still tall (m / n_blocks >= n). ``use_pallas`` routes the
    leaf and combine panels through the Hopper panel kernel, resolved
    against the leaf height. ``trailing_precision`` / ``policy`` split the
    leaf and combine QRs' trailing-update precision as on the blocked
    engine. ``policy.refine`` must be 0: the tree keeps no reusable
    factorization, so each sweep would repeat the whole factorization.
    """
    if policy is not None and resolve_policy(policy).refine:
        raise ValueError(
            "policy.refine > 0 is not supported with TSQR (no reusable "
            "factorization in the tree); use the householder or cholqr "
            "engines, or a refine=0 policy")
    A, precision, trailing_precision, kernel = _prepare(
        A, n_blocks, block_size, precision, use_pallas, trailing_precision,
        policy, device)
    b = as_tensor(b, A.device, A.dtype)
    return _tsqr_lstsq_impl(A, b, int(n_blocks), int(block_size), precision,
                            kernel, trailing_precision)


def tsqr_r(A, n_blocks: int = 8, block_size: int = DEFAULT_BLOCK_SIZE,
           precision: str = DEFAULT_PRECISION, use_pallas: str = "auto",
           trailing_precision: "str | None" = None, policy=None,
           device=None) -> torch.Tensor:
    """The n x n triangular factor of A via TSQR (R up to row signs:
    ``R^H R = A^H A``). ``trailing_precision`` / ``policy`` as in
    :func:`tsqr_lstsq`; ``policy.apply`` and ``policy.refine`` do not apply
    to a factor-only entry point."""
    A, precision, trailing_precision, kernel = _prepare(
        A, n_blocks, block_size, precision, use_pallas, trailing_precision,
        policy, device)
    return _tsqr_r_impl(A, int(n_blocks), int(block_size), precision, kernel,
                        trailing_precision)


def tsqr_panel_plans(m: int, n: int, n_blocks: int, block_size: int, kernel,
                     dtype, device=None):
    """The blocked engine's panel plans of one TSQR call:
    ``[(plan, count), ...]`` — the leaf plan (``count = n_blocks``) and the
    combine plan (``count = 1``), each as :func:`blocked.panel_plan`
    returns it."""
    return [(panel_plan(m // n_blocks, n, block_size, kernel, dtype, device),
             n_blocks),
            (panel_plan(n_blocks * n, n, block_size, kernel, dtype, device),
             1)]


def _check_tsqr_shape(m: int, n: int, n_blocks: int) -> None:
    if m % n_blocks != 0:
        raise ValueError(f"m={m} must be divisible by n_blocks={n_blocks}")
    if m // n_blocks < n:
        raise ValueError(
            f"row blocks must stay tall: m/n_blocks = {m // n_blocks} < n = "
            f"{n}; use fewer blocks")
