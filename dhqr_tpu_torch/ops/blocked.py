"""Blocked compact-WY Householder QR — port of ``dhqr_tpu/ops/blocked.py``.

Each nb-wide panel is factored (by the Hopper panel kernel, or the plain
PyTorch panel loop), then its aggregate transform

    H_nb ... H_1 = I - Y T^H Y^H        (each H_i = I - v_i v_i^H, ||v||^2=2)

goes to the trailing matrix as two GEMMs and one small triangular solve.
With every tau equal to 1, ``T = (I + triu(Y^H Y, 1))^{-1}``; it is never
inverted, ``T^H`` is applied by a unit-diagonal triangular solve.

The JAX engine bounds XLA program size with a two-level super-block scan;
eager PyTorch has no program to bound, so the port runs one
shrinking-slice panel loop at every size, which does the textbook flop
count. The factorization runs in place in one (m, n) tensor.
"""

from __future__ import annotations

import torch

from dhqr_tpu_torch.ops.hopper_panel import (
    KERNEL_MAX_WIDTH,
    _panel_qr_kernel,
    panel_kernel_supported,
)
from dhqr_tpu_torch.ops.householder import (
    DEFAULT_PRECISION,
    _panel_qr_masked,
    _panel_qr_recursive,
)
from dhqr_tpu_torch.utils.config import NotPortedError, check_precision
from dhqr_tpu_torch.utils.device import as_tensor

DEFAULT_BLOCK_SIZE = 128

# Widest panel the kernel factors flat; wider panels split into kernel
# leaves by the geqrt3 recursion. 128 = one launch per default panel (a
# starting point to measure on the H100, not a tuned value).
KERNEL_FLAT_WIDTH = KERNEL_MAX_WIDTH


def wy_upper(Y: torch.Tensor) -> torch.Tensor:
    """U = I + triu(Y^H Y, 1), the inverse of the compact-WY T factor."""
    S = torch.matmul(Y.mH, Y)
    return torch.eye(Y.shape[1], dtype=Y.dtype, device=Y.device) \
        + torch.triu(S, diagonal=1)


def apply_block_reflector_h(Y: torch.Tensor, C: torch.Tensor, *,
                            inplace: bool = False) -> torch.Tensor:
    """C <- (I - Y T^H Y^H) C, i.e. apply H_nb ... H_1 (the Q^H direction).
    ``inplace=True`` writes the result into C's storage."""
    W = torch.matmul(Y.mH, C)
    Z = torch.linalg.solve_triangular(wy_upper(Y).mH, W, upper=False,
                                      unitriangular=True)
    if inplace:
        return C.addmm_(Y, Z, alpha=-1)
    return torch.addmm(C, Y, Z, alpha=-1)


def apply_block_reflector(Y: torch.Tensor, C: torch.Tensor, *,
                          inplace: bool = False) -> torch.Tensor:
    """C <- (I - Y T Y^H) C, i.e. apply H_1 ... H_nb (the Q direction)."""
    W = torch.matmul(Y.mH, C)
    Z = torch.linalg.solve_triangular(wy_upper(Y), W, upper=True,
                                      unitriangular=True)
    if inplace:
        return C.addmm_(Y, Z, alpha=-1)
    return torch.addmm(C, Y, Z, alpha=-1)


def shifted_tril(pf: torch.Tensor, offset: int) -> torch.Tensor:
    """Zero the entries above the shifted diagonal: keep rows >= offset +
    col (the Y factor of a panel factored at row ``offset``)."""
    return torch.tril(pf, diagonal=-offset)


def _panel_factor(panel, offset, norm="accurate", panel_impl="loop"):
    """The non-kernel panel engines: "loop" (masked column loop) or
    "recursive" (geqrt3 divide and conquer)."""
    if panel_impl == "recursive":
        return _panel_qr_recursive(panel, offset, norm=norm)
    if panel_impl == "loop":
        return _panel_qr_masked(panel, offset, norm=norm)
    if panel_impl.startswith("reconstruct"):
        raise NotPortedError(f"panel_impl={panel_impl!r}",
                             "Queue A item 3 (the reconstruct trio)")
    raise ValueError(f"panel_impl must be 'loop' or 'recursive', got "
                     f"{panel_impl!r}")


def _panel_factor_kernel(panel, offset, base=KERNEL_FLAT_WIDTH):
    """Kernel panel factorization: one flat kernel launch up to ``base``
    width, the geqrt3 recursion with the kernel as leaf above it."""
    return _panel_qr_recursive(panel, offset, base=base,
                               leaf=_panel_qr_kernel)


def kernel_leaves(width: int, base: int = KERNEL_FLAT_WIDTH) -> int:
    """Kernel launches :func:`_panel_factor_kernel` makes for a panel of
    ``width`` columns (the recursion halves until the width fits)."""
    if width <= base:
        return 1
    h = width // 2
    return kernel_leaves(h, base) + kernel_leaves(width - h, base)


def _resolve_kernel(mode: str, m: int, nb: int, dtype, device) -> bool:
    """Map a ``use_pallas`` value to "does the blocked engine route its
    panels through the Hopper kernel?".

    "auto": yes for float32/complex64 on a CUDA device; float64/complex128
    and CPU tensors take the plain panel engine (as the JAX package's
    "auto" stays on the XLA path off-TPU). "always": yes — on a CPU tensor
    the wrapper then runs the kernel's plain version, the analogue of the
    Pallas interpreter; raises if the kernel cannot take the panels.
    "never": no. There is no lowering probe: a CUDA kernel that fails to
    build or launch raises instead of degrading to another path.
    """
    supported = panel_kernel_supported(m, min(nb, KERNEL_FLAT_WIDTH), dtype)
    if mode == "never":
        return False
    if mode == "always":
        if not supported:
            raise ValueError(
                f"use_pallas='always' but an ({m}, {nb}) {dtype} panel is "
                "unsupported (float32/complex64 only)")
        return True
    if mode == "auto":
        return supported and torch.device(device).type == "cuda"
    raise ValueError(
        f"use_pallas must be 'auto', 'always' or 'never', got {mode!r}")


def panel_plan(m: int, n: int, nb: int, kernel: bool, dtype):
    """The blocked engine's panels: ``[(k, width, on_kernel), ...]``.

    ``on_kernel`` is the routing decision for that panel (the kernel must
    take its height and leaf width); the engine follows this list, so the
    kernel launches of a factorization are
    ``sum(kernel_leaves(w) for k, w, on in panel_plan(...) if on)``.
    """
    nb = min(nb, n)
    return [(k, min(nb, n - k),
             kernel and panel_kernel_supported(
                 m - k, min(nb, n - k, KERNEL_FLAT_WIDTH), dtype))
            for k in range(0, n, nb)]


def _blocked_qr_impl(H: torch.Tensor, block_size: int, kernel: bool = False,
                     norm: str = "accurate", panel_impl: str = "loop"):
    """Factor H (m x n, m >= n) in place; returns ``(H, alpha)``."""
    m, n = H.shape
    alpha = H.new_zeros(n)
    for k, b, on_kernel in panel_plan(m, n, block_size, kernel, H.dtype):
        panel = H[k:, k:k + b]
        if on_kernel:
            pf, alpha_k = _panel_factor_kernel(panel, 0)
        else:
            pf, alpha_k = _panel_factor(panel, 0, norm, panel_impl)
        panel.copy_(pf)
        alpha[k:k + b] = alpha_k
        if k + b < n:  # trailing update, in place in H
            apply_block_reflector_h(torch.tril(pf), H[k:, k + b:],
                                    inplace=True)
    return H, alpha


def auto_block_size(m: int, dtype, use_pallas: str = "auto") -> int:
    """Panel width when the caller leaves ``block_size`` unset: 128, a
    starting point to be measured on the H100 (the JAX package's 256/512
    rule came from TPU sweeps and is not carried over)."""
    del m, dtype, use_pallas
    return DEFAULT_BLOCK_SIZE


def blocked_householder_qr(
    A,
    block_size: "int | None" = None,
    donate: bool = False,
    precision: str = DEFAULT_PRECISION,
    use_pallas: str = "auto",
    norm: str = "accurate",
    panel_impl: str = "loop",
    trailing_precision: "str | None" = None,
    lookahead: bool = False,
    agg_panels: "int | None" = None,
    overlap_depth: "int | None" = None,
    policy=None,
    device=None,
):
    """Factor ``A`` (m x n, m >= n): returns ``(H, alpha)`` in packed storage
    (reflectors with ||v||^2 = 2 on and below the diagonal, R's strict
    upper triangle in H, R's diagonal in alpha).

    ``use_pallas`` routes the panels through the Hopper panel kernel (see
    :func:`_resolve_kernel`). ``donate=True`` factors in place in A's
    storage (``H`` is then ``A``) when A already is a tensor of the target
    device; otherwise the port factors a copy.
    """
    from dhqr_tpu_torch.utils.config import DHQRConfig, refuse_unported

    refuse_unported(DHQRConfig(
        precision=precision, use_pallas=use_pallas, norm=norm,
        panel_impl=panel_impl, trailing_precision=trailing_precision,
        lookahead=lookahead, agg_panels=agg_panels,
        overlap_depth=overlap_depth, policy=policy))
    A = as_tensor(A, device)
    m, n = A.shape
    if m < n:
        raise ValueError(
            f"blocked_householder_qr requires m >= n, got {tuple(A.shape)}")
    nb = auto_block_size(m, A.dtype, use_pallas) if block_size is None \
        else int(block_size)
    kernel = _resolve_kernel(use_pallas, m, min(nb, n), A.dtype, A.device)
    return _blocked_qr_impl(A if donate else A.clone(), nb, kernel=kernel,
                            norm=norm, panel_impl=panel_impl)


def _apply_qt_impl(H: torch.Tensor, b: torch.Tensor, block_size: int):
    m, n = H.shape
    nb = min(block_size, n)
    B = b[:, None].clone() if b.ndim == 1 else b.clone()
    for k in range(0, n, nb):
        Y = torch.tril(H[k:, k:k + nb])
        apply_block_reflector_h(Y, B[k:], inplace=True)
    return B[:, 0] if b.ndim == 1 else B


def _apply_q_impl(H: torch.Tensor, b: torch.Tensor, block_size: int):
    m, n = H.shape
    nb = min(block_size, n)
    B = b[:, None].clone() if b.ndim == 1 else b.clone()
    for k in reversed(range(0, n, nb)):
        Y = torch.tril(H[k:, k:k + nb])
        apply_block_reflector(Y, B[k:], inplace=True)
    return B[:, 0] if b.ndim == 1 else B


def blocked_apply_qt(H, alpha, b, block_size: int = DEFAULT_BLOCK_SIZE,
                     precision: str = DEFAULT_PRECISION, device=None):
    """b <- Q^H b with the compact-WY form, panel by panel; ``b`` is (m,)
    or (m, k)."""
    del alpha
    check_precision(precision)
    H = as_tensor(H, device)
    return _apply_qt_impl(H, as_tensor(b, H.device, H.dtype), int(block_size))


def blocked_apply_q(H, alpha, b, block_size: int = DEFAULT_BLOCK_SIZE,
                    precision: str = DEFAULT_PRECISION, device=None):
    """b <- Q b with the compact-WY form, panels in reverse order."""
    del alpha
    check_precision(precision)
    H = as_tensor(H, device)
    return _apply_q_impl(H, as_tensor(b, H.device, H.dtype), int(block_size))
