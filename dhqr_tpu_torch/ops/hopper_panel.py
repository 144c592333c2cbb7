"""Hopper panel factorization kernels — port of ``dhqr_tpu/ops/pallas_panel.py``.

The fused panel factorization (float32 and complex64, the two TPU kernels'
types, and float64, which the JAX package factors with plain XLA ops) runs
as a CUDA C++ kernel written for ``sm_90a`` (``csrc/panel_qr.cu``; its
header says what bounds it and how it is built): one cooperative grid of up to one CTA per
SM, each CTA holding a slice of the panel's rows in its registers, in
shared memory where the slice is too large for the registers, or, for a
panel too tall for that, streaming it in place; one grid barrier per
column. This module holds, per kernel:

* the **wrapper** :func:`_panel_qr_kernel` — checks the panel, transposes
  it into a contiguous (nb, m) buffer as the JAX side does, factors that
  buffer in place and returns ``(pf, alpha)``. A CUDA tensor launches the
  kernel or raises; only a CPU tensor takes the plain version (the
  counterpart of the Pallas interpreter). There is no fallback;
* the **in-place entry** :func:`_panel_qr_kernel_in_place` — the blocked
  engine's leaf: the kernel launched on the engine's view of H itself,
  its rows read and written through H's row stride, alpha written into the
  engine's own, where :func:`kernel_layout` allows; else through the
  wrapper's transposed copy and a write-back;
* the **plain versions** :func:`_panel_qr_plain` (float32 and float64)
  and :func:`_panel_qr_plain_c64` — the TPU kernels' algorithm step by step
  in eager PyTorch, including :func:`_sumsq_compensated` (eager PyTorch
  rounds every op on its own, so the Veltkamp split holds as written), a
  row at a time in pieces of :data:`PLAIN_CHUNK` elements, so that the
  plain twin of a panel that fills much of the card fits beside it;
* the **schedule model** :func:`_panel_qr_grid_model` — the CUDA kernel's
  row partition and one-round merge in eager PyTorch (tests, and
  ``chip_smoke.py`` as a leaf of the blocked engine on the card);
* the **launch plan** :func:`kernel_grid` / :func:`kernel_variant` /
  :func:`kernel_flat_width` — the kernel's row partition, where each CTA
  keeps its slice (:data:`VARIANTS`: registers, shared memory or
  streamed), and the leaf width the blocked engine plans with, each for
  the card's SMs or a cap on them (:data:`LOOKAHEAD_CTAS`), at any height
  (the kernel's row and element indices are 64-bit). The launcher only
  checks the plan it is given;
* the **launch counts** :data:`LAUNCHES`, one integer per kernel,
  :data:`VARIANT_LAUNCHES`, one per variant, and :data:`LAYOUT_LAUNCHES`,
  one per layout (in place in the caller's matrix, or on the transposed
  copy), each raised by one per launch in :func:`_launch` and nowhere else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dhqr_tpu_torch.analysis import oplog as _oplog
from dhqr_tpu_torch.ops import _build, gemm
from dhqr_tpu_torch.utils.config import refuse_grad

# Widest panel one launch takes (csrc/panel_qr.cu kMaxWidth), and the leaf
# widths the blocked engine may split a panel into, widest first.
KERNEL_MAX_WIDTH = 128
KERNEL_LEAF_WIDTHS = (128, 64, 32, 16)
# The row partition: at most one CTA per SM and at most KERNEL_MAX_CTAS
# (csrc/panel_qr.cu kMaxCtas; the launcher refuses more), at least this
# many rows per CTA.
KERNEL_MIN_ROWS_PER_CTA = 32
KERNEL_MAX_CTAS = 144
# H100 SXM values (NVIDIA's data sheet), used where no card can be asked:
# SMs, and the opt-in shared memory of one block in bytes.
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232448
# Shared memory set aside for the kernel's static arrays (ptxas: 2.7 KB
# f32, 5.3 KB c64); the launcher checks the fit with the real figure.
KERNEL_STATIC_SMEM = 8192
# The register variant (csrc/panel_qr.cu kRegFloats, kWarps): each of a
# CTA's 16 warps holds ceil(rows / 16) rows, rounded up to a multiple of 4,
# and each lane 1, 2 or 4 columns of them (nb up to 32, 64, 128); a slice
# is held in registers when that is at most 64 floats per thread.
KERNEL_WARPS = 16
KERNEL_REGISTER_FLOATS = 64
# ... but at most 48 in the float64 one-column kernel (csrc/panel_qr.cu
# register_floats: 32 rows of doubles spill there), so 24 rows per warp.
KERNEL_REGISTER_FLOATS_F64_ONE_COLUMN = 48
# CTA cap of a panel launched beside a trailing GEMM (the lookahead
# schedule's side stream, ops/blocked.py): the cooperative grid must be
# resident at once, so it takes at most this many SMs and leaves the rest
# to cuBLAS. Chosen from the cap sweep of chip_smoke.py phase 11.
LOOKAHEAD_CTAS = 66

KERNELS = {torch.float32: "panel_qr_f32", torch.complex64: "panel_qr_c64",
           torch.float64: "panel_qr_f64"}
# The element type as the launch-plan calls of csrc/panel_qr.cu name it.
DTYPE_CODES = {torch.float32: 0, torch.complex64: 1, torch.float64: 2}
# Where a CTA keeps its slice, as the launchers' ``variant`` int names it.
VARIANTS = {"registers": 2, "shared": 1, "streamed": 0}

# Where a launch finds its panel: the caller's matrix itself, or the
# wrapper's contiguous transposed copy (:func:`kernel_layout`).
LAYOUTS = ("in_place", "transposed")

LAUNCHES = {name: 0 for name in KERNELS.values()}
VARIANT_LAUNCHES = {name: 0 for name in VARIANTS}
LAYOUT_LAUNCHES = {name: 0 for name in LAYOUTS}


class KernelRefusal(ValueError):
    """A panel the kernel route does not take (dtype, shape, offset,
    layout, device). A ``ValueError`` for the callers that test for one,
    but its own type so that the guarded ladder never reads it as an
    inapplicable rung: a fault of the kernel route propagates."""


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES, LAYOUT_LAUNCHES):
        for name in counts:
            counts[name] = 0


def device_limits(device=None, ctas: "int | None" = None
                  ) -> "tuple[int, int]":
    """(SMs, opt-in shared memory bytes per block) of ``device``'s card;
    the H100's values for a CPU device or where no card is present.
    ``ctas`` caps the SM count: the launch plan of a grid that may use at
    most that many SMs (the lookahead schedule's side-stream panels)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        sms, smem = H100_SMS, H100_SMEM_PER_BLOCK
    else:
        props = torch.cuda.get_device_properties(device)
        sms = props.multi_processor_count
        smem = getattr(props, "shared_memory_per_block_optin",
                       H100_SMEM_PER_BLOCK)
    return (sms if ctas is None else max(1, min(sms, int(ctas)))), smem


def kernel_grid(rows: int, sms: int = H100_SMS) -> "tuple[int, int]":
    """(CTAs, rows per CTA) of the kernel's partition of ``rows`` active
    rows: at most ``sms`` (and :data:`KERNEL_MAX_CTAS`) CTAs, at least 32
    rows each where there are enough; the last CTA may hold fewer."""
    ctas = max(1, min(sms, KERNEL_MAX_CTAS,
                      -(-rows // KERNEL_MIN_ROWS_PER_CTA)))
    per = -(-rows // ctas)
    return -(-rows // per), per


def kernel_resident(rows: int, nb: int, dtype, sms: int = H100_SMS,
                    smem_per_block: int = H100_SMEM_PER_BLOCK) -> bool:
    """True when each CTA's slice of ``rows`` active rows, ``nb`` columns
    wide, fits its shared memory on a card of ``sms`` SMs: the kernel then
    keeps the slice on chip; otherwise it streams the slice in place."""
    per = kernel_grid(rows, sms)[1]
    return per * nb * dtype.itemsize <= smem_per_block - KERNEL_STATIC_SMEM


def kernel_in_registers(rows: int, nb: int, dtype,
                        sms: int = H100_SMS) -> bool:
    """True when each CTA's slice of ``rows`` active rows, ``nb`` columns
    wide, fits the register variant on a card of ``sms`` SMs: ceil(rows
    per CTA / 16) rows per warp, rounded up to 4, times the columns per
    lane (1, 2 or 4 for nb up to 32, 64, 128), times 2 for complex64 and
    float64 (an 8-byte element takes two registers), at most 64 floats per
    thread (131072 x 32 f32: 993 rows per CTA, 64 x 1; f64 holds half as
    many values: 4400 x 128, 34 rows per CTA, 4 x 4 x 2), or 48 floats for
    float64 at one column per lane (nb up to 32: 24 rows per warp)."""
    per = kernel_grid(rows, sms)[1]
    warp_rows = (-(-per // KERNEL_WARPS) + 3) // 4 * 4
    cols = 1 if nb <= 32 else 2 if nb <= 64 else 4
    floats = dtype.itemsize // 4
    limit = KERNEL_REGISTER_FLOATS_F64_ONE_COLUMN \
        if dtype == torch.float64 and cols == 1 else KERNEL_REGISTER_FLOATS
    return warp_rows * cols * floats <= limit


def kernel_variant(rows: int, nb: int, dtype, sms: int = H100_SMS,
                   smem_per_block: int = H100_SMEM_PER_BLOCK) -> str:
    """Where each CTA keeps its slice of ``rows`` active rows, ``nb``
    columns wide, on a card of ``sms`` SMs: ``"registers"`` where it fits
    them (:func:`kernel_in_registers`), else ``"shared"`` where it fits
    shared memory (:func:`kernel_resident`), else ``"streamed"``."""
    if kernel_in_registers(rows, nb, dtype, sms):
        return "registers"
    if kernel_resident(rows, nb, dtype, sms, smem_per_block):
        return "shared"
    return "streamed"


def kernel_layout(variant: str, strides: "tuple[int, int]") -> str:
    """Where :func:`_panel_qr_kernel_in_place` launches the kernel on a
    panel of ``strides`` (row, column) whose slices take ``variant``:
    ``"in_place"`` on the panel itself where its rows are contiguous
    (column stride 1, a view of the row-major H) and the slices stay on
    chip (registers or shared memory: one load and one write-back of the
    rows); else ``"transposed"``, on the wrapper's contiguous (nb, m)
    copy, which a streamed slice needs (it walks whole columns through L2
    and HBM on every column step)."""
    return "in_place" if variant != "streamed" and strides[1] == 1 \
        else "transposed"


def panel_kernel_supported(m: int, nb: int, dtype) -> bool:
    """True when the kernel takes an (m, nb) panel of ``dtype``: float32,
    float64 or complex64 (:data:`KERNELS`), 1 <= nb <=
    :data:`KERNEL_MAX_WIDTH` and m >= nb. The height
    has no limit of its own (the kernel's row and element indices are
    64-bit): any panel that fits the card runs on it, its slices in
    registers or shared memory where they fit (:func:`kernel_variant`),
    streamed where they do not."""
    return dtype in KERNELS and 1 <= nb <= KERNEL_MAX_WIDTH and m >= nb


def kernel_flat_width(rows: int, dtype, sms: int = H100_SMS,
                      smem_per_block: int = H100_SMEM_PER_BLOCK) -> int:
    """The leaf width the blocked engine gives the kernel for panels of
    ``rows`` rows (its recursion splits a wider panel into leaves this
    wide): the widest in :data:`KERNEL_LEAF_WIDTHS` whose slices fit the
    shared memory of a card of ``sms`` SMs; past that, at any height, the
    narrowest, which the kernel streams; 0 for a ``dtype`` the kernel does
    not take (or no rows).

    On an H100: 16384 rows f32 -> 128 (125 rows x 512 B per CTA); 65536
    rows f32 -> 64 (497 rows x 256 B; 512 B would not fit 227 KB); from
    ~462k rows f32 -> 16, streamed, up to 2^27 rows and past them (a leaf
    of more than 2^31 elements). float64 takes c64's bytes: 4400 rows ->
    128, 65536 rows -> 32, from ~231k rows -> 16, streamed.
    """
    if dtype not in KERNELS or rows < 1:
        return 0
    for width in KERNEL_LEAF_WIDTHS:
        if kernel_resident(rows, width, dtype, sms, smem_per_block):
            return width
    return KERNEL_LEAF_WIDTHS[-1]


# -- plain versions ---------------------------------------------------------

# Elements in one temporary of the plain versions: a row longer than this
# is worked through in pieces this size, so that the plain version of a
# panel that fills much of the card (2^31 rows of f32 are 8.6 GB) runs
# beside it. The pieces change no element's arithmetic, only the order in
# which the compensated norm's error terms are summed.
PLAIN_CHUNK = 1 << 26


def _pieces(n: int, chunk: int) -> "list[slice]":
    return [slice(i, min(n, i + chunk)) for i in range(0, n, chunk)]


# Veltkamp's splitting constant 2^s + 1, s = ceil(mantissa bits / 2): it
# cuts a word into two halves whose products are exact.
VELTKAMP = {torch.float32: 4097.0, torch.float64: 134217729.0}


def _sumsq_compensated(x: torch.Tensor) -> torch.Tensor:
    """Compensated sum of squares of a 1-D float32 (or float64) row, as the
    TPU kernel computes it: a Veltkamp split (:data:`VELTKAMP`; in float64
    the CUDA kernel forms the same exact error with an FMA) makes every
    square exact as p + e; the p plane is zero-padded to the next power of
    two (widths >= 256) and summed by a contiguous-halving TwoSum tree down to
    128 lanes with the errors folded into a scalar; a plain sum ends it.

    The tree halves p in place, :data:`PLAIN_CHUNK` lanes at a time, and
    never forms the pad: a pad lane adds exactly 0 to its partner and to
    the error, so only the lanes that meet a live partner are summed."""
    w = x.shape[0]
    p = torch.empty_like(x)
    err = x.new_zeros(())
    split = VELTKAMP[x.dtype]
    for sl in _pieces(w, PLAIN_CHUNK):
        xc = x[sl]
        pc = torch.mul(xc, xc, out=p[sl])
        c = xc * split
        hi = c - (c - xc)
        lo = xc - hi
        e = ((hi * hi - pc) + 2.0 * hi * lo) + lo * lo
        err = err + torch.sum(e)
    if w >= 256:
        live, h = w, 1 << ((w - 1).bit_length() - 1)  # half the padded width
        while h >= 128:  # lanes [h, live) fold onto [0, live - h)
            for sl in _pieces(live - h, PLAIN_CHUNK):
                a, b = p[sl], p[sl.start + h:sl.stop + h]
                s = a + b
                z = s - a
                err = err + torch.sum((a - (s - z)) + (b - z))  # TwoSum error
                a.copy_(s)
            live, h = h, h // 2
        w = 128
    return torch.sum(p[:w]) + err


def _inv_scale(s: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    denom = s * (s + mag)
    ok = denom > 0
    return torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, denom, 1.0)), 0.0)


def _reflector(x: torch.Tensor, j: int, x_jj, alpha_j, f) -> torch.Tensor:
    """v = (x - alpha_j e_j) f in place of the masked row ``x``, elementwise
    as the TPU kernel forms it (x - alpha_j * 0 off the pivot)."""
    x.sub_(alpha_j * 0.0)
    x[j] = x_jj - alpha_j
    return x.mul_(f)


def _panel_qr_plain(at: torch.Tensor, offset: int) -> torch.Tensor:
    """Float32 (and float64) kernel, plain: factor the transposed panel
    ``at`` (nb, m) in place; returns alpha (nb,). Its temporaries are a few
    rows (the trailing update goes :data:`PLAIN_CHUNK` elements at a
    time). In float64 it is the CUDA kernel's arithmetic (every square
    exact, TwoSum accumulation, alpha, f and W as the kernel forms them)
    in the TPU kernel's summation order."""
    nb, m = at.shape
    alpha = at.new_zeros(nb)
    step = max(1, PLAIN_CHUNK // m)  # trailing rows per update piece
    for jl in range(nb):
        j = offset + jl
        v = at[jl].clone()
        v[:j] = 0.0  # the masked row x, rows < j zero
        s = torch.sqrt(_sumsq_compensated(v))
        a_jj = v[j].clone()
        alpha_j = torch.where(a_jj >= 0, -s, s)
        _reflector(v, j, a_jj, alpha_j, _inv_scale(s, a_jj.abs()))
        if jl + 1 < nb:
            W = gemm.matmul(at[jl + 1:], v, "highest")  # partial dots
            for k in range(0, nb - jl - 1, step):
                rows = slice(jl + 1 + k, jl + 1 + k + step)
                at[rows] -= W[k:k + step, None] * v[None, :]
        at[jl, j:] = v[j:]
        alpha[jl] = alpha_j
    return alpha


def _panel_qr_plain_c64(at: torch.Tensor, offset: int) -> torch.Tensor:
    """Complex64 kernel, plain, in real-plane arithmetic: factor ``at``
    (nb, m) in place; returns alpha (nb,). Temporaries as the float32
    version's."""
    nb, m = at.shape
    planes = torch.view_as_real(at)
    ar, ai = planes[..., 0], planes[..., 1]
    alpha = at.new_zeros(nb)
    step = max(1, PLAIN_CHUNK // m)
    for jl in range(nb):
        j = offset + jl
        vr, vi = ar[jl].clone(), ai[jl].clone()
        vr[:j] = 0.0
        vi[:j] = 0.0
        s = torch.sqrt(_sumsq_compensated(vr) + _sumsq_compensated(vi))
        ar_jj, ai_jj = vr[j].clone(), vi[j].clone()
        mag = torch.sqrt(ar_jj * ar_jj + ai_jj * ai_jj)
        live = mag > 0
        inv = torch.where(live, 1.0 / torch.where(live, mag, 1.0), 0.0)
        alr = s * torch.where(live, -ar_jj * inv, -1.0)
        ali = s * torch.where(live, -ai_jj * inv, 0.0)
        f = _inv_scale(s, mag)
        _reflector(vr, j, ar_jj, alr, f)
        _reflector(vi, j, ai_jj, ali, f)
        if jl + 1 < nb:
            tr, ti = ar[jl + 1:], ai[jl + 1:]
            Wr = (gemm.matmul(tr, vr, "highest")
                  + gemm.matmul(ti, vi, "highest"))[:, None]
            Wi = (gemm.matmul(ti, vr, "highest")
                  - gemm.matmul(tr, vi, "highest"))[:, None]
            for k in range(0, nb - jl - 1, step):
                rows = slice(k, k + step)
                new_r = tr[rows] - (Wr[rows] * vr - Wi[rows] * vi)
                new_i = ti[rows] - (Wr[rows] * vi + Wi[rows] * vr)
                tr[rows] = new_r
                ti[rows] = new_i
        ar[jl, j:] = vr[j:]
        ai[jl, j:] = vi[j:]
        alpha[jl] = torch.complex(alr, ali)
    return alpha


_PLAIN = {torch.float32: _panel_qr_plain, torch.complex64: _panel_qr_plain_c64,
          torch.float64: _panel_qr_plain}


# -- the CUDA kernel's schedule, in plain PyTorch ----------------------------

def _comp_merge(s, err, s2, e2):
    """(s, err) += (s2, e2): the kernel's TwoSum merge, rounded per op
    (numpy float32 scalars or 0-d float32 tensors)."""
    t = s + s2
    z = t - s
    err = (err + ((s - (t - z)) + (s2 - z))) + e2
    return t, err


def _column_scalars(ps, pe, pd, a_jj, ycol):
    """One column's merge and scalars, on the host in float32 (numpy):
    the slices' (s, err) and partial dots merged in slice order, then
    alpha, f and W = f (<x, y> - conj(alpha) y_j) as the kernel forms them.
    Returns (alpha_j, f, W)."""
    f32 = np.float32
    s, err = f32(0), f32(0)
    dots = np.zeros(pd.shape[1], pd.dtype)
    for i in range(pd.shape[0]):
        s, err = _comp_merge(s, err, ps[i], pe[i])
        dots = dots + pd[i]
    sn = np.sqrt(s + err)
    if np.iscomplexobj(a_jj):
        re, im = f32(a_jj.real), f32(a_jj.imag)
        mag = np.sqrt(re * re + im * im)
        inv = f32(1) / mag if mag > 0 else f32(0)
        alpha_j = np.complex64(complex(sn * (-re * inv if mag > 0 else f32(-1)),
                                       sn * (-im * inv if mag > 0 else f32(0))))
    else:
        mag = abs(a_jj)
        alpha_j = -sn if a_jj >= 0 else sn
    denom = sn * (sn + mag)
    f = f32(1) / np.sqrt(denom) if denom > 0 else f32(0)
    return alpha_j, f, (dots - np.conj(alpha_j) * ycol) * f


def _panel_qr_grid_model(at: torch.Tensor, offset: int,
                         n_slices: int) -> torch.Tensor:
    """The CUDA kernel's schedule in eager PyTorch: factor ``at`` (nb, m)
    float32 or complex64 in place, on its own device; returns alpha (nb,).

    The active rows [offset, m) are cut into slices of
    ceil((m - offset) / n_slices) rows, as the kernel cuts them over that
    many CTAs (``n_slices`` = :func:`kernel_grid`'s CTAs). Per column,
    each slice forms its compensated sum of squares (s, err) and its
    partial dots sum conj(x_i) y_i over its rows >= j (all slices at once,
    rows < j masked to zero); the slices are merged in slice order on the
    host (TwoSum for the norm, :func:`_column_scalars`), and the one-round
    identity W = f (<x, y> - conj(alpha) y_j) replaces the dots with v.
    Within a slice the compensated pair is formed in float64, where every
    float32 square is exact, and split into two float32 words. Tests and
    ``chip_smoke.py`` hold it against the JAX kernel, the plain versions
    and the CUDA kernel, and ``chip_smoke.py`` runs it on the card as the
    blocked engine's leaf (:func:`_panel_qr_grid_leaf`). A float64 panel
    raises: no wider type makes its squares exact here.
    """
    if at.dtype not in (torch.float32, torch.complex64):
        raise KernelRefusal(f"the grid model takes float32/complex64 panels, "
                            f"got {at.dtype}")
    nb, m = at.shape
    rows = m - offset
    per = -(-rows // n_slices)
    slices = -(-rows // per)
    buf = at.new_zeros((nb, slices * per))  # the active rows, zero-padded
    buf[:, :rows] = at[:, offset:]
    lane = torch.arange(slices * per, device=at.device) + offset
    f32 = torch.float32
    alpha = torch.empty(nb, dtype=at.dtype)
    for jl in range(nb):
        j = offset + jl
        X = torch.where(lane >= j, buf[jl], 0).view(slices, per)
        sq = torch.view_as_real(X).double() if X.is_complex() else X.double()
        sq = (sq ** 2).flatten(1).sum(1)
        ps = sq.to(f32)
        pe = (sq - ps.double()).to(f32)
        Y = buf[jl + 1:].view(nb - jl - 1, slices, per)
        # dhqr: ignore[DHQR002] the grid model's per-slice partial dots in full FP32 (the kernel's HIGHEST), kept as one einsum so the slices stay apart
        pd = torch.einsum("ksp,sp->sk", Y, X.conj())
        parts = [pd.flatten(), buf[jl:, jl]]  # dots, then a_jj and y_j
        if at.is_complex():
            parts = [torch.view_as_real(p).flatten() for p in parts]
        host = torch.cat([ps, pe, *parts]).cpu().numpy()  # one transfer
        rest = host[2 * slices:]
        if at.is_complex():
            rest = rest.view(np.complex64)
        k = nb - jl - 1
        alpha_j, f, W = _column_scalars(
            host[:slices], host[slices:2 * slices],
            rest[:slices * k].reshape(slices, k), rest[slices * k],
            rest[slices * k + 1:])
        v = buf[jl, jl:].clone()
        v[0] = v[0] - alpha_j.item()
        v = v * float(f)
        buf[jl + 1:, jl:] -= torch.from_numpy(W).to(at.device)[:, None] * v
        buf[jl, jl:] = v
        alpha[jl] = alpha_j.item()
    at[:, offset:] = buf[:, :rows]
    return alpha.to(at.device)


def _panel_qr_grid_leaf(panel: torch.Tensor, offset: int,
                        sms: "int | None" = None):
    """The grid model as a leaf of the blocked engine, in place of
    :func:`_panel_qr_kernel`: the same ``(pf, alpha)`` contract, cut into
    the CTAs the kernel would launch for this panel on its device (at most
    ``sms``). ``chip_smoke.py`` runs it on the card to measure the
    kernel's schedule in PyTorch's arithmetic."""
    m, nb = panel.shape
    at = panel.T.contiguous()
    ctas = _plan(m, nb, offset, panel.dtype, panel.device, sms)[0]
    return at.T, _panel_qr_grid_model(at, offset, ctas)


def _panel_qr_plain_leaf(panel: torch.Tensor, offset: int,
                         sms: "int | None" = None):
    """The kernel's plain version as a leaf of the blocked engine, in place
    of :func:`_panel_qr_kernel`, on any device: the counterpart of the
    Pallas interpreter (``lstsq_diff(..., pallas_interpret=True)``). It
    launches nothing and counts nothing."""
    del sms
    at = panel.T.contiguous()
    alpha = _PLAIN[panel.dtype](at, int(offset))
    if _oplog.ARMED is not None:
        _oplog.kernel(KERNELS[panel.dtype], "plain", panel.shape,
                      panel.dtype, offset)
    return at.T, alpha


# -- the kernels ------------------------------------------------------------

_LIBS: "dict[bool, ctypes.CDLL]" = {}

# The C signatures of the launchers (``dhqr_panel_qr_f32`` / ``_c64`` /
# ``_f64``) and of ``dhqr_panel_qr_info`` (whose ``dtype`` is a
# :data:`DTYPE_CODES` value) in csrc/panel_qr.cu, by parameter. A panel's
# height and offset are 64-bit there and here: a 32-bit ctypes int would cut
# a height past 2^31 short without a word.
# The panel's element (r, k) lies at ``a[r * row_stride + k * col_stride]``.
LAUNCH_ARGS = (
    ("a", ctypes.c_void_p), ("alpha", ctypes.c_void_p),
    ("scratch", ctypes.c_void_p), ("scratch_floats", ctypes.c_longlong),
    ("barrier", ctypes.c_void_p), ("m", ctypes.c_longlong),
    ("nb", ctypes.c_int), ("offset", ctypes.c_longlong),
    ("row_stride", ctypes.c_longlong), ("col_stride", ctypes.c_longlong),
    ("ctas", ctypes.c_int), ("rows", ctypes.c_int),
    ("variant", ctypes.c_int), ("stream", ctypes.c_void_p))
INFO_ARGS = (
    ("dtype", ctypes.c_int), ("m", ctypes.c_longlong),
    ("nb", ctypes.c_int), ("offset", ctypes.c_longlong),
    ("ctas", ctypes.c_int), ("rows", ctypes.c_int),
    ("variant", ctypes.c_int), ("out", ctypes.POINTER(ctypes.c_int)))

# Sections of a column step timed by the build with -DDHQR_PANEL_PROFILE
# (the register variant: "trailing_pass" is its one pass from registers,
# "column_pass" the lanes' pass over columns jl and jl+1).
PROFILE_SECTIONS = ("merge", "column_pass", "trailing_pass", "barrier")


def _library(profile: bool = False) -> ctypes.CDLL:
    """The kernels' library; ``profile=True`` is the build with section
    timers, a library of its own."""
    if profile not in _LIBS:
        lib = _build.load("panel_qr",
                          ("DHQR_PANEL_PROFILE",) if profile else ())
        lib.dhqr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dhqr_cuda_error_string.restype = ctypes.c_char_p
        lib.dhqr_panel_qr_info.argtypes = [t for _, t in INFO_ARGS]
        lib.dhqr_panel_qr_info.restype = ctypes.c_int
        lib.dhqr_panel_qr_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.dhqr_panel_qr_scratch_floats.restype = ctypes.c_longlong
        for kname in KERNELS.values():
            fn = getattr(lib, f"dhqr_{kname}")
            fn.argtypes = [t for _, t in LAUNCH_ARGS]
            fn.restype = ctypes.c_int
        if profile:
            lib.dhqr_panel_qr_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.dhqr_panel_qr_profile.restype = ctypes.c_int
        _LIBS[profile] = lib
    return _LIBS[profile]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _library().dhqr_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: cudaError {err} ({msg})")


def _plan(m: int, nb: int, offset: int, dtype, device,
          sms: "int | None" = None) -> "tuple[int, int, str]":
    """(CTAs, rows per CTA, variant) of the launch for an (m, nb) panel at
    ``offset`` on ``device``'s card, on at most ``sms`` SMs."""
    limits = device_limits(device, sms)
    ctas, rows = kernel_grid(m - offset, limits[0])
    return ctas, rows, kernel_variant(m - offset, nb, dtype, *limits)


def kernel_launch_info(m: int, nb: int, offset: int, dtype,
                       device=None, sms: "int | None" = None) -> dict:
    """The launch the CUDA kernel makes for an (m, nb) panel at ``offset``
    on ``device``'s card, on at most ``sms`` SMs: CTAs, rows per CTA and
    variant as planned here, and from the launcher the shared bytes per
    CTA, registers and spill bytes per thread, resident CTAs per SM and the
    scratch's floats. Raises what the launch would raise."""
    device = torch.device("cuda" if device is None else device)
    ctas, rows, variant = _plan(m, nb, offset, dtype, device, sms)
    out = (ctypes.c_int * 5)()
    code = DTYPE_CODES[dtype]
    with torch.cuda.device(device):
        lib = _library()
        err = lib.dhqr_panel_qr_info(code, m, nb, offset, ctas, rows,
                                     VARIANTS[variant], out)
        _raise_on(err, f"{KERNELS[dtype]} launch plan for ({m}, {nb}) at "
                  f"{offset}")
        scratch = lib.dhqr_panel_qr_scratch_floats(code, ctas, nb)
    keys = ("smem_dynamic_bytes", "smem_static_bytes", "registers",
            "spill_bytes", "ctas_per_sm")
    return {"ctas": ctas, "rows_per_cta": rows, "variant": variant,
            **dict(zip(keys, out)), "scratch_floats": scratch}


def _launch(panel: torch.Tensor, alpha: torch.Tensor, offset: int,
            plan: "tuple[int, int, str]", layout: str,
            profile: bool = False) -> None:
    """Launch the kernel on the (m, nb) ``panel`` where it lies (its
    element (r, k) at its two strides: the wrapper's transposed buffer
    ``at.T``, or a view of the engine's H), alpha into the contiguous
    ``alpha``, by ``plan`` (:func:`_plan`), on the current stream; its
    scratch and barrier are allocated on that stream. ``layout`` (one of
    :data:`LAYOUTS`) is what the launch is counted as."""
    name = KERNELS[panel.dtype]
    lib = _library(profile)
    m, nb = panel.shape
    if not alpha.is_contiguous():
        raise KernelRefusal("the panel kernel writes a contiguous alpha")
    ctas, rows, variant = plan
    floats = lib.dhqr_panel_qr_scratch_floats(DTYPE_CODES[panel.dtype], ctas,
                                              nb)
    scratch = torch.empty(floats, dtype=torch.float32, device=panel.device)
    barrier = torch.zeros(1, dtype=torch.int32, device=panel.device)
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream(panel.device).cuda_stream
        err = getattr(lib, f"dhqr_{name}")(
            panel.data_ptr(), alpha.data_ptr(), scratch.data_ptr(), floats,
            barrier.data_ptr(), m, nb, offset, *panel.stride(), ctas, rows,
            VARIANTS[variant], stream)
    _raise_on(err, f"{name} launch")
    LAUNCHES[name] += 1
    VARIANT_LAUNCHES[variant] += 1
    LAYOUT_LAUNCHES[layout] += 1


def kernel_section_cycles(panel: torch.Tensor, offset: int = 0) -> dict:
    """Factor a CUDA panel once with the kernel's timed build; returns, for
    each of :data:`PROFILE_SECTIONS`, the SM cycles per column that each
    CTA's first thread spent there, as the mean and the max over the CTAs.
    A measurement, not a path of the port."""
    m, nb = panel.shape
    at = panel.T.contiguous()
    alpha = torch.empty(nb, dtype=panel.dtype, device=panel.device)
    plan = _plan(m, nb, offset, panel.dtype, panel.device)
    _launch(at.T, alpha, offset, plan, "transposed", profile=True)
    torch.cuda.synchronize(panel.device)
    ctas = plan[0]
    buf = (ctypes.c_ulonglong * (len(PROFILE_SECTIONS) * ctas))()
    with torch.cuda.device(panel.device):
        _raise_on(_library(True).dhqr_panel_qr_profile(buf, ctas),
                  "reading the section timers")
    cycles = torch.tensor(list(buf), dtype=torch.float64).reshape(ctas, -1) / nb
    return {"mean": dict(zip(PROFILE_SECTIONS, cycles.mean(0).tolist())),
            "max": dict(zip(PROFILE_SECTIONS, cycles.max(0).values.tolist()))}


def _check_panel(panel: torch.Tensor, offset: int) -> None:
    """Raise for a panel the kernel route does not take: one that autograd
    follows (the kernel writes through a raw pointer), a dtype, width or
    offset the kernel does not take, a device that is neither the card nor
    the CPU (whose tensors take the plain version)."""
    refuse_grad(panel, "the Hopper panel kernel", reason=(
        "it writes its factors through a raw pointer, where autograd "
        "cannot follow; every public factorization differentiates through "
        "ops.differentiable.householder_factor instead"))
    m, nb = panel.shape
    if not panel_kernel_supported(m, nb, panel.dtype):
        raise KernelRefusal(
            f"the panel kernel takes float32/float64/complex64 panels with "
            f"m >= nb and nb <= {KERNEL_MAX_WIDTH}, got "
            f"{tuple(panel.shape)} {panel.dtype}")
    if not 0 <= offset <= m - nb:
        raise KernelRefusal(f"panel offset {offset} out of range for "
                            f"{tuple(panel.shape)}")
    if panel.device.type not in ("cuda", "cpu"):
        raise KernelRefusal(f"no panel kernel for device {panel.device}")


def _log_kernel(panel: torch.Tensor, offset: int, variant: str) -> None:
    if _oplog.ARMED is not None:  # the op log's pallas_call eqn
        _oplog.kernel(KERNELS[panel.dtype],
                      "kernel" if panel.device.type == "cuda" else "plain",
                      panel.shape, panel.dtype, offset, variant)


def _panel_qr_kernel(panel: torch.Tensor, offset: int,
                     sms: "int | None" = None):
    """Factor an (m, nb) panel whose reflector for local column jj starts at
    row ``offset + jj``; returns ``(pf, alpha)`` in the packed storage of
    ``householder._panel_qr_masked``. ``panel`` itself is not modified.

    A CUDA tensor launches the Hopper kernel on the current stream, on at
    most ``sms`` SMs (default: all; its slices in registers or shared
    memory where they fit, streamed where they do not), on a contiguous
    transposed copy; a CPU tensor runs the plain version. Anything the
    kernel does not take raises (:func:`_check_panel`): the differentiable
    route is ``ops.differentiable.householder_factor``, whose forward
    calls this wrapper with grad off.
    """
    _check_panel(panel, offset)
    m, nb = panel.shape
    at = torch.empty((nb, m), dtype=panel.dtype, device=panel.device)
    at.copy_(panel.T)  # (nb, m): panel column j -> row j
    variant = ""
    if panel.device.type == "cuda":
        alpha = torch.empty(nb, dtype=panel.dtype, device=panel.device)
        plan = _plan(m, nb, offset, panel.dtype, panel.device, sms)
        _launch(at.T, alpha, int(offset), plan, "transposed")
        variant = plan[2]
    else:
        alpha = _PLAIN[panel.dtype](at, int(offset))
    _log_kernel(panel, offset, variant)
    return at.T, alpha


def _panel_qr_kernel_in_place(panel: torch.Tensor, offset: int,
                              alpha: torch.Tensor,
                              sms: "int | None" = None) -> str:
    """Factor the (m, nb) ``panel`` in place, as :func:`_panel_qr_kernel`
    factors its copy: its rows ``offset:`` take the packed factors, alpha
    is written into ``alpha`` (nb,); rows above ``offset`` and everything
    outside the panel stay bit for bit. The blocked engine's leaf, on its
    view of H. Returns the layout (:func:`kernel_layout`) it took.

    A CUDA tensor launches the kernel, on at most ``sms`` SMs: on the panel
    itself where the layout is ``"in_place"`` (no copy), else through the
    wrapper's transposed copy (a streamed slice, or a panel whose rows
    are not contiguous), whose rows ``offset:`` are written back. A CPU
    tensor takes the wrapper's plain version, written back the same way.
    Raises as :func:`_panel_qr_kernel` does.
    """
    _check_panel(panel, offset)
    m, nb = panel.shape
    plan = _plan(m, nb, offset, panel.dtype, panel.device, sms)
    layout = kernel_layout(plan[2], panel.stride())
    if layout == "in_place" and panel.device.type == "cuda":
        _launch(panel, alpha, int(offset), plan, layout)
        _log_kernel(panel, offset, plan[2])
    else:
        pf, alpha_k = _panel_qr_kernel(panel, offset, sms)
        panel[offset:].copy_(pf[offset:])
        alpha.copy_(alpha_k)
    return layout


def panel_qr_kernel(panel: torch.Tensor):
    """Factor an (m, nb) float32/float64/complex64 panel with the Hopper
    kernel (plain version for a CPU tensor); returns ``(pf, alpha)``."""
    m, nb = panel.shape
    if m < nb:
        raise KernelRefusal(f"panel_qr_kernel requires m >= nb, got {tuple(panel.shape)}")
    if panel.dtype not in KERNELS:
        raise KernelRefusal(
            f"panel_qr_kernel supports float32/float64/complex64, got "
            f"{panel.dtype}")
    return _panel_qr_kernel(panel, 0)
