"""Accurate reductions — port of ``dhqr_tpu/ops/summation.py``.

A compensated pairwise (TwoSum) tree with the JAX package's exact halving
order, odd-length zero pad included, so the same input gives the same sum
bit for bit. Eager PyTorch rounds every elementwise op on its own, so the
TwoSum error algebra holds as written.
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
    """Compensated pairwise sum of a 1-D vector, accurate to ~1 ulp."""
    n = x.shape[0]
    if n == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    err = torch.zeros_like(x)
    while n > 1:
        if n % 2:
            x = torch.cat([x, x.new_zeros(1)])
            err = torch.cat([err, err.new_zeros(1)])
            n += 1
        s, e = _two_sum(x[0::2], x[1::2])
        err = err[0::2] + err[1::2] + e  # error terms are tiny; plain add is fine
        x = s
        n //= 2
    return x[0] + err[0]


def sumsq(x: torch.Tensor, mode: str = "accurate") -> torch.Tensor:
    """sum(|x|^2) (real result, for real and complex x). ``"accurate"``:
    the compensated tree; ``"fast"``: a plain ``torch.sum``."""
    if x.is_complex():
        y = x.real * x.real + x.imag * x.imag
    else:
        y = x * x
    if mode == "fast":
        return torch.sum(y)
    if mode != "accurate":
        raise ValueError(f"norm mode must be 'accurate' or 'fast', got {mode!r}")
    return tree_sum(y)


def norm2(x: torch.Tensor, mode: str = "accurate") -> torch.Tensor:
    """||x||_2 with selectable accumulation (see :func:`sumsq`)."""
    return torch.sqrt(sumsq(x, mode))


def accurate_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conj(a)·b with a compensated pairwise sum over the products."""
    return tree_sum(a.conj() * b)
