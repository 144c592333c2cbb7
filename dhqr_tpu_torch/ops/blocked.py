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

Two schedules reorder that loop without changing what each column
receives: ``agg_panels=k`` (one trailing update per group of k panels)
and ``lookahead=True`` (panel q+1 factored before panel q's wide trailing
update; on the card the two run at once, on two CUDA streams).
"""

from __future__ import annotations

import contextlib
import functools

import torch

from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.hopper_panel import (
    KERNEL_MAX_WIDTH,
    KERNELS,
    LAYOUTS,
    LOOKAHEAD_CTAS,
    KernelRefusal,
    _panel_qr_kernel,
    _panel_qr_kernel_in_place,
    device_limits,
    kernel_flat_width,
    kernel_layout,
    kernel_variant,
)
from dhqr_tpu_torch.ops.householder import (
    DEFAULT_PRECISION,
    _panel_qr_masked,
    _panel_qr_reconstruct,
    _panel_qr_recursive,
)
from dhqr_tpu_torch.precision import apply_policy_to_factor_args
from dhqr_tpu_torch.utils.config import (
    check_precision,
    records_grad,
    refuse_grad,
)
from dhqr_tpu_torch.utils.device import as_tensor
from dhqr_tpu_torch.utils.profiling import phase

DEFAULT_BLOCK_SIZE = 128

# Widest leaf the kernel factors flat; wider panels, and panels too tall
# for a 128-wide slice to fit each CTA's shared memory, split into narrower
# kernel leaves by the geqrt3 recursion (hopper_panel.kernel_flat_width).
KERNEL_FLAT_WIDTH = KERNEL_MAX_WIDTH


def wy_upper(Y: torch.Tensor, precision: str = DEFAULT_PRECISION
             ) -> torch.Tensor:
    """U = I + triu(Y^H Y, 1), the inverse of the compact-WY T factor."""
    S = gemm.matmul(Y.mH, Y, precision)
    return torch.eye(Y.shape[-1], dtype=Y.dtype, device=Y.device) \
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
    """The non-kernel panel engines: "loop" (masked column loop),
    "recursive" (geqrt3 divide and conquer) or "reconstruct[:<chunk>]"
    (explicit QR + Householder reconstruction, real dtypes only). A stack
    (B, m, b) of panels takes "loop" and "recursive" as one batched loop,
    and "reconstruct" one panel after another."""
    if panel_impl == "recursive":
        return _panel_qr_recursive(panel, offset, precision, norm=norm)
    if panel_impl.startswith("reconstruct"):
        if panel.is_complex():
            raise ValueError(
                "panel_impl='reconstruct' supports real dtypes only (the "
                "complex variant needs the phase-tracking modified LU — "
                "LAPACK zunhr_col; use 'loop' or 'recursive' for complex)")
        chunk = _reconstruct_chunk(panel_impl)
        if panel.ndim == 3:
            parts = [_panel_qr_reconstruct(p, offset, tree_chunk=chunk)
                     for p in panel]
            return (torch.stack([pf for pf, _ in parts]),
                    torch.stack([a for _, a in parts]))
        return _panel_qr_reconstruct(panel, offset, tree_chunk=chunk)
    if panel_impl == "loop":
        return _panel_qr_masked(panel, offset, precision, norm=norm)
    raise ValueError(
        f"panel_impl must be 'loop', 'recursive', 'reconstruct' or "
        f"'reconstruct:<chunk>', got {panel_impl!r}")


def _reconstruct_chunk(panel_impl: str) -> int:
    """Row-chunk size from the ``reconstruct[:<chunk>]`` spelling (0 =
    direct QR). Raises on malformed spellings so a typo cannot silently
    select the direct path."""
    if panel_impl == "reconstruct":
        return 0
    try:
        chunk = int(panel_impl.split(":", 1)[1])
        if chunk <= 0:
            raise ValueError
        return chunk
    except (IndexError, ValueError):
        raise ValueError(
            f"malformed reconstruct spelling {panel_impl!r}: expected "
            "'reconstruct' or 'reconstruct:<positive chunk>'"
        ) from None


def _panel_factor_kernel(panel, offset, base, precision=DEFAULT_PRECISION,
                         leaf=None):
    """Kernel panel factorization: one flat kernel launch up to ``base``
    width (the plan's leaf, :func:`kernel_flat_width`), the geqrt3
    recursion with the kernel as leaf above it (its GEMMs at
    ``precision``). ``leaf`` stands in for the kernel's wrapper
    (``functools.partial(_panel_qr_kernel, sms=cap)`` for a capped grid;
    ``chip_smoke.py`` passes the grid model)."""
    return _panel_qr_recursive(panel, offset, precision, base=base,
                               leaf=_panel_qr_kernel if leaf is None else leaf)


def _panel_factor_in_place(panel, offset, base, alpha,
                           precision=DEFAULT_PRECISION, sms=None) -> None:
    """The kernel panel factorization in place in H: ``panel`` (a view of
    H) is factored where it lies and its alpha written into ``alpha`` (a
    view of the engine's). The geqrt3 recursion of
    :func:`_panel_factor_kernel` with nothing copied or joined: the left
    half in place, its reflectors applied to the right half in H, the
    right half in place at row ``offset + h``. A leaf of width <= ``base``
    is one :func:`~dhqr_tpu_torch.ops.hopper_panel._panel_qr_kernel_in_place`
    on at most ``sms`` SMs (which takes the transposed copy where
    :func:`~dhqr_tpu_torch.ops.hopper_panel.kernel_layout` says so)."""
    b = panel.shape[-1]
    if b <= base:
        _panel_qr_kernel_in_place(panel, offset, alpha, sms)
        return
    h = b // 2
    _panel_factor_in_place(panel[:, :h], offset, base, alpha[:h], precision,
                           sms)
    apply_block_reflector_h(shifted_tril(panel[:, :h], offset), panel[:, h:],
                            precision, inplace=True)
    _panel_factor_in_place(panel[:, h:], offset + h, base, alpha[h:],
                           precision, sms)


def kernel_leaves(width: int, base: int = KERNEL_FLAT_WIDTH) -> int:
    """Kernel launches :func:`_panel_factor_kernel` makes for a panel of
    ``width`` columns (the recursion halves until the width fits)."""
    if width <= base:
        return 1
    h = width // 2
    return kernel_leaves(h, base) + kernel_leaves(width - h, base)


def leaf_layouts(rows: int, width: int, base: int, dtype, device=None,
                 sms: "int | None" = None, offset: int = 0,
                 counts: "dict | None" = None) -> dict:
    """The launches :func:`_panel_factor_in_place` makes on a ``rows`` x
    ``width`` view of the engine's H (at ``offset``, on at most ``sms`` SMs
    of ``device``'s card), by layout: the count it adds to
    ``hopper_panel.LAYOUT_LAUNCHES``, added to ``counts``."""
    counts = {name: 0 for name in LAYOUTS} if counts is None else counts
    if width <= base:
        variant = kernel_variant(rows - offset, width, dtype,
                                 *device_limits(device, sms))
        counts[kernel_layout(variant, (width, 1))] += 1
        return counts
    h = width // 2
    leaf_layouts(rows, h, base, dtype, device, sms, offset, counts)
    return leaf_layouts(rows, width - h, base, dtype, device, sms,
                        offset + h, counts)


def _resolve_kernel(mode: str, m: int, dtype, device) -> bool:
    """Map a ``use_pallas`` value to "does the blocked engine route the
    panels of an m-row matrix through the Hopper kernel?".

    "auto": yes for float32, float64 and complex64 on a CUDA device (the
    kernel's :data:`KERNELS`; float64 has a kernel here though the JAX
    package has none); complex128 and CPU tensors take the plain panel
    engine (as the JAX package's "auto" stays on the XLA path off-TPU).
    "always": yes — on a CPU tensor the wrapper then runs the kernel's
    plain version, the analogue of the Pallas interpreter; raises
    :class:`KernelRefusal` (a ValueError) for complex128. "never": no.
    Every height runs on the kernel: resident in shared memory where a
    leaf's slices fit, streamed past that, with 64-bit row and element
    indices past 2^31 (the height is never a reason to leave the kernel).
    There is no lowering probe: a CUDA kernel that fails to build or
    launch raises instead of degrading to another path.
    """
    if mode not in ("auto", "always", "never"):
        raise ValueError(
            f"use_pallas must be 'auto', 'always' or 'never', got {mode!r}")
    if mode == "never" or (mode == "auto" and (
            dtype not in KERNELS or torch.device(device).type != "cuda")):
        return False
    if dtype not in KERNELS:
        raise KernelRefusal(f"use_pallas='always' but the panel kernel takes "
                            f"float32/float64/complex64 only, got {dtype}")
    return True


def _beside_gemm(index: int, k: int, width: int, n: int) -> bool:
    """In the lookahead schedule, panel ``index`` (columns k : k + width of
    n) is factored while the previous panel's wide trailing update runs:
    every panel but the first that has columns right of it."""
    return index > 0 and k + width < n


def panel_plan(m: int, n: int, nb: int, kernel: bool, dtype, device=None,
               lookahead_ctas: "int | None" = None, flat: "int | None" = None):
    """The blocked engine's panels: ``[(k, width, leaf), ...]``.

    ``leaf`` is the routing decision for that panel: the kernel's leaf
    width (:func:`kernel_flat_width` of its m - k rows on ``device``'s card,
    the H100's on the CPU), or 0 when ``kernel`` is False and the panel
    takes the plain panel engine. With ``lookahead_ctas`` (the lookahead
    schedule's CTA cap), a panel factored beside a trailing GEMM
    (:func:`_beside_gemm`) is planned on that many SMs: more rows per CTA,
    so a narrower leaf where the wider one's slices no longer fit shared
    memory. ``flat`` caps the leaf width (``lstsq_diff``'s ``pallas_flat``).
    The engine follows this list, so the kernel launches of a
    factorization are
    ``sum(kernel_leaves(w, leaf) for k, w, leaf in panel_plan(...) if leaf)``,
    by layout :func:`plan_layouts`.
    """
    nb = min(nb, n)
    plan = []
    for i, k in enumerate(range(0, n, nb)):
        width = min(nb, n - k)
        cap = lookahead_ctas if _beside_gemm(i, k, width, n) else None
        leaf = kernel_flat_width(m - k, dtype,
                                 *device_limits(device, cap)) if kernel else 0
        plan.append((k, width, min(leaf, flat) if flat and leaf else leaf))
    return plan


def plan_layouts(m: int, plan, dtype, device=None,
                 lookahead_ctas: "int | None" = None) -> dict:
    """``hopper_panel.LAYOUT_LAUNCHES`` of one factorization of an m-row
    matrix by ``plan`` (:func:`panel_plan`, with the same ``lookahead_ctas``
    for the lookahead schedule) on the kernel's own leaf."""
    counts = {name: 0 for name in LAYOUTS}
    n = plan[-1][0] + plan[-1][1] if plan else 0
    for i, (k, w, leaf) in enumerate(plan):
        if leaf:
            cap = lookahead_ctas if _beside_gemm(i, k, w, n) else None
            leaf_layouts(m - k, w, leaf, dtype, device, cap, counts=counts)
    return counts


def _blocked_qr_impl(H: torch.Tensor, block_size: int, kernel: bool = False,
                     norm: str = "accurate", panel_impl: str = "loop",
                     precision: str = DEFAULT_PRECISION,
                     trailing_precision: "str | None" = None,
                     lookahead: bool = False,
                     agg_panels: "int | None" = None, leaf=None,
                     lookahead_ctas: int = LOOKAHEAD_CTAS,
                     flat: "int | None" = None):
    """Factor H (m x n, m >= n) in place; returns ``(H, alpha)``.

    The panels and T factors run at ``precision``, the trailing-update
    GEMMs at ``trailing_precision`` (None: the same). ``lookahead`` and
    ``agg_panels`` pick the schedule (:func:`_lookahead_schedule`,
    :func:`_grouped_schedule`); the kernel's own leaf factors each panel in
    place in H (:func:`_panel_factor_in_place`), while a ``leaf`` standing
    in for the kernel's wrapper takes the out-of-place recursion and a
    copy back; ``leaf`` and ``lookahead_ctas``, the lookahead schedule's
    CTA cap, are for measurements; ``flat`` caps the kernel's leaf width
    (:func:`panel_plan`).

    A stack H (B, m, n) factors every matrix of the stack in one panel
    loop, each panel step and trailing update one batched op (the serving
    tier's twin of the JAX engine's ``vmap``); a stack takes the plain
    panel engines and the default schedule only."""
    with phase("dhqr.factor"):
        m, n = H.shape[-2:]
        alpha = H.new_zeros(H.shape[:-2] + (n,))
        if H.ndim != 2 and (kernel or lookahead or agg_panels):
            raise ValueError("a stack of matrices takes the plain panel "
                             "engines and the default schedule only")

        def factor(k, b, width_leaf, sms=None):
            """Factor the panel H[k:, k:k+b] in place (alpha[k:k+b] too),
            by the plan's route, the kernel on at most ``sms`` SMs; returns
            the factored panel. One ``dhqr.panel`` span."""
            with phase("dhqr.panel"):
                panel = H[..., k:, k:k + b]
                if width_leaf and leaf is None:
                    _panel_factor_in_place(panel, 0, width_leaf,
                                           alpha[k:k + b], precision, sms)
                    return panel
                if width_leaf:
                    kleaf = leaf if sms is None \
                        else functools.partial(leaf, sms=sms)
                    pf, alpha_k = _panel_factor_kernel(panel, 0, width_leaf,
                                                       precision, kleaf)
                else:
                    pf, alpha_k = _panel_factor(panel, 0, precision, norm,
                                                panel_impl)
                panel.copy_(pf)
                alpha[..., k:k + b] = alpha_k
                return pf

        if lookahead:
            plan = panel_plan(m, n, block_size, kernel, H.dtype, H.device,
                              lookahead_ctas, flat)
            _lookahead_schedule(H, plan, factor, precision,
                                trailing_precision, lookahead_ctas)
            return H, alpha
        plan = panel_plan(m, n, block_size, kernel, H.dtype, H.device,
                          flat=flat)
        if agg_panels:
            _grouped_schedule(H, plan, agg_panels, factor, precision,
                              trailing_precision)
            return H, alpha
        for k, b, width_leaf in plan:
            pf = factor(k, b, width_leaf)
            if k + b < n:  # trailing update, in place in H
                with phase("dhqr.trailing"):
                    apply_block_reflector_h(torch.tril(pf),
                                            H[..., k:, k + b:], precision,
                                            trailing_precision, inplace=True)
        return H, alpha


def refuse_batched_grad(t) -> None:
    """The batched engine's refusal of an input that autograd follows (the
    serving tier's entry points check every request with it)."""
    if isinstance(t, torch.Tensor):
        refuse_grad(t, "the batched engine", reason=(
            "it factors a donated stack in place, and the JAX package's "
            "batched engine is not differentiable either (it converts to "
            "the host)"))


def _batched_qr_impl(A: torch.Tensor, block_size: int,
                     precision: str = DEFAULT_PRECISION,
                     norm: str = "accurate", panel_impl: str = "loop",
                     trailing_precision: "str | None" = None):
    """The serving tier's factor-only dispatch unit — the twin of the JAX
    engine's ``_batched_qr_impl_donate`` (a ``vmap`` of the blocked engine
    over a donated stack): the blocked engine over a stack A (B, m, n),
    factored IN PLACE, so the returned stacked H is A's storage. Every
    panel step and trailing update is one batched op; row i agrees with
    the 2-D engine on A[i] to roundoff (the column norms take the same
    tree, the GEMMs are batched). The Hopper panel kernel is a
    single-problem tier and is never engaged here. A stack that autograd
    follows raises, as ``jax.grad`` fails through the JAX package's
    batched engine (it converts to the host)."""
    refuse_batched_grad(A)
    return _blocked_qr_impl(A, block_size, kernel=False, norm=norm,
                            panel_impl=panel_impl, precision=precision,
                            trailing_precision=trailing_precision)


def _grouped_schedule(H, plan, k, factor, precision, tprec) -> None:
    """``agg_panels=k``: the panels in groups of k consecutive ones, after
    ``_factor_group`` / ``_scan_panels_grouped`` of the JAX engine.

    Inside a group the panels factor left to right, each applying its
    compact-WY transform to the group's remaining columns only; then one
    trailing update per group applies the k panels' reflectors side by
    side (with every tau = 1 the aggregate's T factor is ``wy_upper`` of
    them, no new recurrence) to every column right of the group, at
    ``tprec``. The port groups at every size, from column 0, and a last
    group may hold fewer panels; the JAX engine groups only on its scanned
    path (n / nb > 8), in super-blocks of a multiple of k panels, with the
    same group boundaries, and runs smaller problems per panel. Every panel
    still takes its own kernel launches (the plan's count)."""
    n = H.shape[1]
    for g in range(0, len(plan), k):
        group = plan[g:g + k]
        kg, end = group[0][0], group[-1][0] + group[-1][1]
        for kk, b, width_leaf in group:
            pf = factor(kk, b, width_leaf)
            if kk + b < end:  # the group's interior update
                with phase("dhqr.trailing"):
                    apply_block_reflector_h(torch.tril(pf),
                                            H[kk:, kk + b:end], precision,
                                            tprec, inplace=True)
        if end < n:  # one trailing update for the whole group
            with phase("dhqr.trailing"):
                apply_block_reflector_h(torch.tril(H[kg:, kg:end]),
                                        H[kg:, end:], precision, tprec,
                                        inplace=True)


_SIDE_STREAMS: "dict[int, torch.cuda.Stream]" = {}


def _side_stream(device: torch.device):
    """The lookahead schedule's side stream on ``device`` (one per card,
    made on first use, at high priority so that the panel kernel's CTAs are
    placed ahead of the pending GEMM's as SMs free up); None on the CPU."""
    if device.type != "cuda":
        return None
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(device=index, priority=-1)
    return _SIDE_STREAMS[index]


def _lookahead_schedule(H, plan, factor, precision, tprec, ctas) -> None:
    """``lookahead=True``: the one-panel lookahead order of
    ``_unrolled_lookahead`` / ``_scan_panels_lookahead`` in the JAX engine.

    With panel q factored and pending, each step (1) applies panel q's
    transform to panel q+1's columns (the lookahead update), (2) factors
    panel q+1 and (3) applies panel q's transform to the columns right of
    q+1, which (2) neither reads nor writes. Every column still receives
    transforms 0, 1, 2, ... in order, so the factors match the default
    schedule to roundoff in the GEMM's column split.

    On the card, (2) runs on a side stream (:func:`_side_stream`) while (3),
    the wide cuBLAS GEMM, runs on the current one; the side stream waits
    for (1) and the current one for (2) before the next step. A panel that
    runs beside a GEMM launches on at most ``ctas`` SMs (the plan's leaf is
    planned on as many), since its cooperative grid must be resident all at
    once; the first panel, and a last one with nothing right of it, take
    the whole card. Everything (2) allocates (the kernel's buffers, its
    scratch and barrier, the recursion's GEMM results) is allocated on the
    side stream and used there only; ``H`` and ``alpha``, which it writes,
    outlive the join. On a CPU tensor the same order runs on one stream."""
    n = H.shape[1]
    side = _side_stream(H.device)
    kp, bp, leaf0 = plan[0]  # the pending panel: factored, not yet applied
    factor(kp, bp, leaf0)
    for i, (k1, b1, leaf1) in enumerate(plan[1:], 1):
        with phase("dhqr.trailing"):  # (1)
            Y = torch.tril(H[kp:, kp:kp + bp])
            apply_block_reflector_h(Y, H[kp:, k1:k1 + b1], precision, tprec,
                                    inplace=True)
        beside = _beside_gemm(i, k1, b1, n)
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(H.device))
        with torch.cuda.stream(side) if side is not None \
                else contextlib.nullcontext():  # (2)
            factor(k1, b1, leaf1, ctas if beside else None)
        if beside:  # (3)
            with phase("dhqr.trailing"):
                apply_block_reflector_h(Y, H[kp:, k1 + b1:], precision,
                                        tprec, inplace=True)
        if side is not None:
            torch.cuda.current_stream(H.device).wait_stream(side)
        kp, bp = k1, b1


def check_schedule_args(lookahead: bool, agg_panels, overlap_depth) -> None:
    """The ops-level schedule checks of the JAX engine's
    ``blocked_householder_qr`` (``lstsq_diff`` shares them)."""
    if agg_panels is not None and agg_panels < 2:
        raise ValueError(f"agg_panels must be >= 2 (got {agg_panels}); "
                         "None means per-panel updates")
    if agg_panels and lookahead:
        raise ValueError(
            "agg_panels and lookahead are mutually exclusive on the "
            "single-device engine (both only add flops here); the mesh "
            "tier composes them as grouped lookahead — use qr()/lstsq() "
            "with mesh= (parallel/sharded_qr._blocked_shard_agg)"
        )
    if overlap_depth is not None:
        raise ValueError(
            "overlap_depth is mesh-only: the depth-k pipeline exists to "
            "keep panel-broadcast collectives in flight, and a single "
            "device has no collective to hide — use qr()/lstsq() with "
            "mesh= (parallel/sharded_qr._blocked_shard_pipeline)"
        )


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

    ``lookahead=True`` factors each panel before the previous panel's wide
    trailing update, beside it on a second CUDA stream on the card
    (:func:`_lookahead_schedule`); ``agg_panels=k`` (k >= 2) applies the
    trailing update once per group of k panels (:func:`_grouped_schedule`).
    Both keep the default's factors to roundoff and are mutually exclusive
    on a single device; ``overlap_depth`` is mesh-only.

    Differentiable in A (:func:`~dhqr_tpu_torch.ops.differentiable.
    householder_factor`), with the forward bit for bit the one without
    grad; ``donate=True`` with an A that autograd follows raises.
    """
    from dhqr_tpu_torch.ops.differentiable import householder_factor
    from dhqr_tpu_torch.utils.config import DHQRConfig, refuse_unported

    precision, trailing_precision = apply_policy_to_factor_args(
        policy, precision, trailing_precision,
        default_precision=DEFAULT_PRECISION)
    check_schedule_args(lookahead, agg_panels, overlap_depth)
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
    if donate and records_grad(A):
        raise ValueError(
            "donate=True factors in place in A's storage, but autograd "
            "follows A (it requires grad, or carries a forward-mode "
            "tangent): the factorization would overwrite a tensor autograd "
            "tracks. Pass donate=False to differentiate")
    kernel = _resolve_kernel(use_pallas, m, A.dtype, A.device)
    return householder_factor(A, nb, in_place=donate, kernel=kernel,
                              norm=norm, panel_impl=panel_impl,
                              precision=precision,
                              trailing_precision=trailing_precision,
                              lookahead=lookahead, agg_panels=agg_panels)


def _apply_panels(H, b, block_size, order, apply, precision):
    """``apply`` (a panel's block reflector) to ``b`` panel by panel in
    ``order``; ``b`` is (m,) or (m, k), or for a stack H (B, m, n) a (B, m)
    or (B, m, k) stack. In place on a copy of b, or out of place (the same
    products) when autograd follows H or b."""
    n = H.shape[-1]
    nb = min(block_size, n)
    vec = b.ndim == H.ndim - 1
    B = b[..., None].clone() if vec else b.clone()
    traced = records_grad(H, b)
    for k in order(range(0, n, nb)):
        Y = torch.tril(H[..., k:, k:k + nb])
        if traced:
            B = torch.cat([B[..., :k, :], apply(Y, B[..., k:, :], precision)],
                          dim=-2)
        else:
            apply(Y, B[..., k:, :], precision, inplace=True)
    return B[..., 0] if vec else B


def _apply_qt_impl(H: torch.Tensor, b: torch.Tensor, block_size: int,
                   precision: str = DEFAULT_PRECISION):
    """Q^H b panel by panel, one ``dhqr.apply_qt`` span; shapes as
    :func:`_apply_panels`."""
    with phase("dhqr.apply_qt"):
        return _apply_panels(H, b, block_size, iter,
                             apply_block_reflector_h, precision)


def _apply_q_impl(H: torch.Tensor, b: torch.Tensor, block_size: int,
                  precision: str = DEFAULT_PRECISION):
    """Q b, panels in reverse order; shapes as :func:`_apply_panels`."""
    return _apply_panels(H, b, block_size, reversed, apply_block_reflector,
                         precision)


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
