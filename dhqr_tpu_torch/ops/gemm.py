"""Matrix products at a named precision — the port's counterpart of
``jnp.matmul(a, b, precision=p)``.

The names mean what they mean on the TPU's MXU, chosen per call (PyTorch's
TF32 switches are process-wide and stay off):

===========================  =============================================
precision                    float32 / complex64 product
===========================  =============================================
``"highest"``, ``"float32"``  ``torch.matmul`` in full FP32
``"high"``                   three bf16 passes: a = a_hi + a_lo and
                             b = b_hi + b_lo split into bf16 parts, then
                             a_hi b_hi + a_hi b_lo + a_lo b_hi
``"default"``                one bf16 pass, a_hi b_hi
===========================  =============================================

Each bf16 x bf16 product accumulates in f32 and comes back in f32, never
rounded to bf16. The passes are fused along the inner dimension into one
product, ``[a_hi, a_hi, a_lo] @ [b_hi; b_lo; b_hi]``, so the three partial
products share one f32 accumulator. A complex64 product is four real
products at the same precision, fused the same way through the real
embedding ``[ar, ai] @ [[br, bi], [-bi, br]]`` (columns interleaved, so the
result is the complex tensor's own storage). float64 and complex128
products run at full precision whatever the name, as XLA computes them off
the TPU.

On a CUDA tensor each bf16 product is one cuBLAS bf16 GEMM with f32 output
(``torch.mm(..., out_dtype=torch.float32)``). The plain version — used for
CPU tensors, and the yardstick on the card — multiplies the same
bf16-rounded operands converted back to f32 in an f32 product: a product
of two bf16 values is exact in f32, so the two differ only in the order of
the f32 sums.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch.utils.config import check_precision

# bf16 passes per product of a float32/complex64 operand; other names (and
# other dtypes) are full precision.
BF16_PASSES = {"high": 3, "default": 1}
_SPLIT_DTYPES = (torch.float32, torch.complex64)


def bf16_passes(precision: str, dtype) -> int:
    """bf16 passes a product of ``dtype`` operands takes at ``precision``;
    0 means a full-precision product."""
    check_precision(precision)
    if dtype not in _SPLIT_DTYPES:
        return 0
    return BF16_PASSES.get(precision, 0)


def _split(x: torch.Tensor):
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(x.dtype)).to(torch.bfloat16)


def _real_operands(a: torch.Tensor, b: torch.Tensor, passes: int):
    """Real bf16 operands (A, B) whose product is the pass sum of a @ b
    (for complex a, b: its real embedding, columns interleaved)."""
    if a.is_complex():
        a, b = a.resolve_conj(), b.resolve_conj()
        ar, ai, br, bi = a.real, a.imag, b.real, b.imag
        k, n = b.shape
        a = torch.cat([ar, ai], dim=1)
        b = torch.cat([torch.stack([br, bi], dim=-1).reshape(k, 2 * n),
                       torch.stack([-bi, br], dim=-1).reshape(k, 2 * n)])
    if passes == 1:
        return a.to(torch.bfloat16), b.to(torch.bfloat16)
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return (torch.cat([a_hi, a_hi, a_lo], dim=1),
            torch.cat([b_hi, b_lo, b_hi], dim=0))


def _real_view(c: torch.Tensor) -> torch.Tensor:
    """``c`` as the real f32 matrix the embedded product writes."""
    if c.is_complex():
        return torch.view_as_real(c).view(c.shape[0], 2 * c.shape[1])
    return c


def _bf16_product(A, B, plain: bool) -> torch.Tensor:
    if plain:
        return torch.mm(A.float(), B.float())
    return torch.mm(A, B, out_dtype=torch.float32)


def _bf16_addmm_(out, A, B, alpha, plain: bool) -> None:
    if plain:
        out.addmm_(A.float(), B.float(), alpha=alpha)
    else:
        torch.addmm(out, A, B, out_dtype=torch.float32, alpha=alpha, out=out)


def _plain_for(t: torch.Tensor, plain) -> bool:
    """``plain`` as given, else by device: a CUDA tensor runs the bf16
    GEMM, a CPU tensor the plain version; any other device raises."""
    if plain is not None or t.device.type == "cuda":
        return bool(plain)
    if t.device.type == "cpu":
        return True
    raise ValueError(f"no bf16 product for device {t.device}")


def _matmul(a, b, precision, plain):
    passes = bf16_passes(precision, a.dtype)
    if not passes:
        return torch.matmul(a, b)
    if a.ndim == 1:
        return _matmul(a[None, :], b, precision, plain)[0]
    if b.ndim == 1:
        return _matmul(a, b[:, None], precision, plain)[:, 0]
    out = _bf16_product(*_real_operands(a, b, passes), _plain_for(a, plain))
    if a.is_complex():
        return torch.view_as_complex(out.view(out.shape[0], -1, 2))
    return out


def _addmm(c, a, b, precision, alpha, inplace, plain):
    passes = bf16_passes(precision, c.dtype)
    if not passes:
        if inplace:
            return c.addmm_(a, b, alpha=alpha)
        return torch.addmm(c, a, b, alpha=alpha)
    target = c if inplace else c.clone()
    _bf16_addmm_(_real_view(target), *_real_operands(a, b, passes), alpha,
                 _plain_for(c, plain))
    return target


def matmul(a, b, precision: str = "highest") -> torch.Tensor:
    """``a @ b`` at ``precision`` (``a`` or ``b`` may be a vector)."""
    return _matmul(a, b, precision, None)


def addmm(c, a, b, precision: str = "highest", *, alpha=-1,
          inplace: bool = False) -> torch.Tensor:
    """``c + alpha * (a @ b)`` at ``precision``; ``inplace=True`` writes it
    into c's storage (the trailing update), at every precision."""
    return _addmm(c, a, b, precision, alpha, inplace, None)


def matmul_plain(a, b, precision: str = "highest") -> torch.Tensor:
    """:func:`matmul`'s plain version, on any device."""
    return _matmul(a, b, precision, True)


def addmm_plain(c, a, b, precision: str = "highest", *, alpha=-1,
                inplace: bool = False) -> torch.Tensor:
    """:func:`addmm`'s plain version, on any device."""
    return _addmm(c, a, b, precision, alpha, inplace, True)
