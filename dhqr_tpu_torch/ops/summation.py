"""Accurate reductions — port of ``dhqr_tpu/ops/summation.py``.

A compensated pairwise (TwoSum) tree with the JAX package's exact halving
order, odd-length zero pad included, so the same input gives the same sum
bit for bit. Eager PyTorch rounds every elementwise op on its own, so the
TwoSum error algebra holds as written.

Every reduction runs over the last axis; leading axes are a batch (the
serving tier's stacked problems), each row summed in the same tree order
as a lone vector.
"""

from __future__ import annotations

import torch


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """Knuth TwoSum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    z = s - a
    e = (a - (s - z)) + (b - z)
    return s, e


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Compensated pairwise sum over the last axis, accurate to ~1 ulp."""
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    err = torch.zeros_like(x)
    pad = x.shape[:-1] + (1,)
    while n > 1:
        if n % 2:
            x = torch.cat([x, x.new_zeros(pad)], dim=-1)
            err = torch.cat([err, err.new_zeros(pad)], dim=-1)
            n += 1
        s, e = _two_sum(x[..., 0::2], x[..., 1::2])
        # error terms are tiny; plain add is fine
        err = err[..., 0::2] + err[..., 1::2] + e
        x = s
        n //= 2
    return x[..., 0] + err[..., 0]


def sumsq(x: torch.Tensor, mode: str = "accurate") -> torch.Tensor:
    """sum(|x|^2) (real result, for real and complex x). ``"accurate"``:
    the compensated tree; ``"fast"``: a plain ``torch.sum``."""
    if x.is_complex():
        y = x.real * x.real + x.imag * x.imag
    else:
        y = x * x
    if mode == "fast":
        return torch.sum(y, dim=-1)
    if mode != "accurate":
        raise ValueError(f"norm mode must be 'accurate' or 'fast', got {mode!r}")
    return tree_sum(y)


def accurate_sumsq(x: torch.Tensor) -> torch.Tensor:
    """sum(|x|^2) to ~1 ulp (real result, for real and complex x)."""
    return sumsq(x, "accurate")


def accurate_norm(x: torch.Tensor) -> torch.Tensor:
    """||x||_2 to ~1 ulp: the reference's ``norm(view(Hl, j:m, j))``
    (src:129)."""
    return torch.sqrt(accurate_sumsq(x))


def norm2(x: torch.Tensor, mode: str = "accurate") -> torch.Tensor:
    """||x||_2 with selectable accumulation (see :func:`sumsq`)."""
    return torch.sqrt(sumsq(x, mode))


def accurate_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conj(a)·b with a compensated pairwise sum over the products."""
    return tree_sum(a.conj() * b)
