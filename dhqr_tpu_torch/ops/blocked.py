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

from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.hopper_panel import (
    KERNEL_MAX_WIDTH,
    KERNELS,
    _panel_qr_kernel,
    device_limits,
    kernel_flat_width,
)
from dhqr_tpu_torch.ops.householder import (
    DEFAULT_PRECISION,
    _panel_qr_masked,
    _panel_qr_recursive,
)
from dhqr_tpu_torch.precision import apply_policy_to_factor_args
from dhqr_tpu_torch.utils.config import NotPortedError, check_precision
from dhqr_tpu_torch.utils.device import as_tensor

DEFAULT_BLOCK_SIZE = 128

# Widest leaf the kernel factors flat; wider panels, and panels too tall
# for a 128-wide slice to fit each CTA's shared memory, split into narrower
# kernel leaves by the geqrt3 recursion (hopper_panel.kernel_flat_width).
KERNEL_FLAT_WIDTH = KERNEL_MAX_WIDTH
# Where panels too tall for the kernel's int32 element indices arrive.
_TALL_PANELS_ITEM = "Queue B2 item 7 (64-bit element indices in the panel kernel)"


def wy_upper(Y: torch.Tensor, precision: str = DEFAULT_PRECISION
             ) -> torch.Tensor:
    """U = I + triu(Y^H Y, 1), the inverse of the compact-WY T factor."""
    S = gemm.matmul(Y.mH, Y, precision)
    return torch.eye(Y.shape[1], dtype=Y.dtype, device=Y.device) \
        + torch.triu(S, diagonal=1)


def apply_block_reflector_h(Y: torch.Tensor, C: torch.Tensor,
                            precision: str = DEFAULT_PRECISION,
                            gemm_precision: "str | None" = None, *,
                            inplace: bool = False) -> torch.Tensor:
    """C <- (I - Y T^H Y^H) C, i.e. apply H_nb ... H_1 (the Q^H direction).

    ``gemm_precision`` (default: ``precision``) applies to the two
    panel-sized GEMMs only; the T factor (``wy_upper``) keeps ``precision``.
    The triangular solve runs at full precision. ``inplace=True`` writes
    the result into C's storage."""
    gp = precision if gemm_precision is None else gemm_precision
    W = gemm.matmul(Y.mH, C, gp)
    Z = torch.linalg.solve_triangular(wy_upper(Y, precision).mH, W,
                                      upper=False, unitriangular=True)
    return gemm.addmm(C, Y, Z, gp, alpha=-1, inplace=inplace)


def apply_block_reflector(Y: torch.Tensor, C: torch.Tensor,
                          precision: str = DEFAULT_PRECISION, *,
                          inplace: bool = False) -> torch.Tensor:
    """C <- (I - Y T Y^H) C, i.e. apply H_1 ... H_nb (the Q direction)."""
    W = gemm.matmul(Y.mH, C, precision)
    Z = torch.linalg.solve_triangular(wy_upper(Y, precision), W, upper=True,
                                      unitriangular=True)
    return gemm.addmm(C, Y, Z, precision, alpha=-1, inplace=inplace)


def shifted_tril(pf: torch.Tensor, offset: int) -> torch.Tensor:
    """Zero the entries above the shifted diagonal: keep rows >= offset +
    col (the Y factor of a panel factored at row ``offset``)."""
    return torch.tril(pf, diagonal=-offset)


def _panel_factor(panel, offset, precision=DEFAULT_PRECISION,
                  norm="accurate", panel_impl="loop"):
    """The non-kernel panel engines: "loop" (masked column loop) or
    "recursive" (geqrt3 divide and conquer)."""
    if panel_impl == "recursive":
        return _panel_qr_recursive(panel, offset, precision, norm=norm)
    if panel_impl == "loop":
        return _panel_qr_masked(panel, offset, precision, norm=norm)
    if panel_impl.startswith("reconstruct"):
        raise NotPortedError(f"panel_impl={panel_impl!r}",
                             "Queue A item 3 (the reconstruct trio)")
    raise ValueError(f"panel_impl must be 'loop' or 'recursive', got "
                     f"{panel_impl!r}")


def _panel_factor_kernel(panel, offset, base, precision=DEFAULT_PRECISION):
    """Kernel panel factorization: one flat kernel launch up to ``base``
    width (the plan's leaf, :func:`kernel_flat_width`), the geqrt3
    recursion with the kernel as leaf above it (its GEMMs at
    ``precision``)."""
    return _panel_qr_recursive(panel, offset, precision, base=base,
                               leaf=_panel_qr_kernel)


def kernel_leaves(width: int, base: int = KERNEL_FLAT_WIDTH) -> int:
    """Kernel launches :func:`_panel_factor_kernel` makes for a panel of
    ``width`` columns (the recursion halves until the width fits)."""
    if width <= base:
        return 1
    h = width // 2
    return kernel_leaves(h, base) + kernel_leaves(width - h, base)


def _resolve_kernel(mode: str, m: int, dtype, device) -> bool:
    """Map a ``use_pallas`` value to "does the blocked engine route the
    panels of an m-row matrix through the Hopper kernel?".

    "auto": yes for float32/complex64 on a CUDA device; float64/complex128
    and CPU tensors take the plain panel engine (as the JAX package's
    "auto" stays on the XLA path off-TPU). "always": yes — on a CPU tensor
    the wrapper then runs the kernel's plain version, the analogue of the
    Pallas interpreter; raises ValueError for another dtype. "never": no.
    Every height the kernel takes a leaf of runs on it (streamed past
    shared memory); a taller one raises :class:`NotPortedError` rather than
    leave the kernel on the card. There is no lowering probe: a CUDA kernel
    that fails to build or launch raises instead of degrading to another
    path.
    """
    if mode not in ("auto", "always", "never"):
        raise ValueError(
            f"use_pallas must be 'auto', 'always' or 'never', got {mode!r}")
    if mode == "never" or (mode == "auto" and (
            dtype not in KERNELS or torch.device(device).type != "cuda")):
        return False
    if dtype not in KERNELS:
        raise ValueError(f"use_pallas='always' but the panel kernel takes "
                         f"float32/complex64 only, got {dtype}")
    if kernel_flat_width(m, dtype, *device_limits(device)) == 0:
        raise NotPortedError(f"a panel kernel leaf of {m} rows",
                             _TALL_PANELS_ITEM)
    return True


def panel_plan(m: int, n: int, nb: int, kernel: bool, dtype, device=None):
    """The blocked engine's panels: ``[(k, width, leaf), ...]``.

    ``leaf`` is the routing decision for that panel: the kernel's leaf
    width (:func:`kernel_flat_width` of its m - k rows on ``device``'s card,
    the H100's on the CPU), or 0 when ``kernel`` is False and the panel
    takes the plain panel engine. The engine follows this list, so the
    kernel launches of a factorization are
    ``sum(kernel_leaves(w, leaf) for k, w, leaf in panel_plan(...) if leaf)``.
    """
    nb = min(nb, n)
    limits = device_limits(device)
    return [(k, min(nb, n - k),
             kernel_flat_width(m - k, dtype, *limits) if kernel else 0)
            for k in range(0, n, nb)]


def _blocked_qr_impl(H: torch.Tensor, block_size: int, kernel: bool = False,
                     norm: str = "accurate", panel_impl: str = "loop",
                     precision: str = DEFAULT_PRECISION,
                     trailing_precision: "str | None" = None):
    """Factor H (m x n, m >= n) in place; returns ``(H, alpha)``.

    The panels and T factors run at ``precision``, the trailing-update
    GEMMs at ``trailing_precision`` (None: the same)."""
    m, n = H.shape
    alpha = H.new_zeros(n)
    for k, b, leaf in panel_plan(m, n, block_size, kernel, H.dtype,
                                 H.device):
        panel = H[k:, k:k + b]
        if leaf:
            pf, alpha_k = _panel_factor_kernel(panel, 0, leaf, precision)
        else:
            pf, alpha_k = _panel_factor(panel, 0, precision, norm,
                                        panel_impl)
        panel.copy_(pf)
        alpha[k:k + b] = alpha_k
        if k + b < n:  # trailing update, in place in H
            apply_block_reflector_h(torch.tril(pf), H[k:, k + b:], precision,
                                    trailing_precision, inplace=True)
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
    device; otherwise the port factors a copy. ``trailing_precision``
    (default: ``precision``) sets the precision of the trailing-update
    GEMMs only; ``policy`` sets both (the solve-stage fields ``apply`` and
    ``refine`` do not apply to a factor-only entry point).
    """
    from dhqr_tpu_torch.utils.config import DHQRConfig, refuse_unported

    precision, trailing_precision = apply_policy_to_factor_args(
        policy, precision, trailing_precision,
        default_precision=DEFAULT_PRECISION)
    refuse_unported(DHQRConfig(
        precision=precision, use_pallas=use_pallas, norm=norm,
        panel_impl=panel_impl, trailing_precision=trailing_precision,
        lookahead=lookahead, agg_panels=agg_panels,
        overlap_depth=overlap_depth))
    A = as_tensor(A, device)
    m, n = A.shape
    if m < n:
        raise ValueError(
            f"blocked_householder_qr requires m >= n, got {tuple(A.shape)}")
    nb = auto_block_size(m, A.dtype, use_pallas) if block_size is None \
        else int(block_size)
    kernel = _resolve_kernel(use_pallas, m, A.dtype, A.device)
    return _blocked_qr_impl(A if donate else A.clone(), nb, kernel=kernel,
                            norm=norm, panel_impl=panel_impl,
                            precision=precision,
                            trailing_precision=trailing_precision)


def _apply_qt_impl(H: torch.Tensor, b: torch.Tensor, block_size: int,
                   precision: str = DEFAULT_PRECISION):
    m, n = H.shape
    nb = min(block_size, n)
    B = b[:, None].clone() if b.ndim == 1 else b.clone()
    for k in range(0, n, nb):
        Y = torch.tril(H[k:, k:k + nb])
        apply_block_reflector_h(Y, B[k:], precision, inplace=True)
    return B[:, 0] if b.ndim == 1 else B


def _apply_q_impl(H: torch.Tensor, b: torch.Tensor, block_size: int,
                  precision: str = DEFAULT_PRECISION):
    m, n = H.shape
    nb = min(block_size, n)
    B = b[:, None].clone() if b.ndim == 1 else b.clone()
    for k in reversed(range(0, n, nb)):
        Y = torch.tril(H[k:, k:k + nb])
        apply_block_reflector(Y, B[k:], precision, inplace=True)
    return B[:, 0] if b.ndim == 1 else B


def blocked_apply_qt(H, alpha, b, block_size: int = DEFAULT_BLOCK_SIZE,
                     precision: str = DEFAULT_PRECISION, device=None):
    """b <- Q^H b with the compact-WY form, panel by panel; ``b`` is (m,)
    or (m, k)."""
    del alpha
    check_precision(precision)
    H = as_tensor(H, device)
    return _apply_qt_impl(H, as_tensor(b, H.device, H.dtype), int(block_size),
                          precision)


def blocked_apply_q(H, alpha, b, block_size: int = DEFAULT_BLOCK_SIZE,
                    precision: str = DEFAULT_PRECISION, device=None):
    """b <- Q b with the compact-WY form, panels in reverse order."""
    del alpha
    check_precision(precision)
    H = as_tensor(H, device)
    return _apply_q_impl(H, as_tensor(b, H.device, H.dtype), int(block_size),
                         precision)
