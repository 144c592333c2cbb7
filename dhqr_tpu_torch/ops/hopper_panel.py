"""Hopper panel factorization kernels — port of ``dhqr_tpu/ops/pallas_panel.py``.

The fused panel factorization (float32, and complex64) runs as a CUDA C++
kernel written for ``sm_90a`` (``csrc/panel_qr.cu``; its header says what
bounds it and how it is built): one cooperative grid of up to one CTA per
SM, each CTA holding a slice of the panel's rows in shared memory (or,
for a panel too tall for that, streaming it in place), one grid barrier
per column. This module holds, per kernel:

* the **wrapper** :func:`_panel_qr_kernel` — checks the panel, transposes
  it into a contiguous (nb, m) buffer as the JAX side does, factors that
  buffer in place and returns ``(pf, alpha)``. A CUDA tensor launches the
  kernel or raises; only a CPU tensor takes the plain version (the
  counterpart of the Pallas interpreter). There is no fallback;
* the **plain versions** :func:`_panel_qr_plain` and
  :func:`_panel_qr_plain_c64` — the TPU kernels' algorithm step by step in
  eager PyTorch, including :func:`_sumsq_compensated` (eager PyTorch rounds
  every op on its own, so the Veltkamp split holds as written);
* the **schedule model** :func:`_panel_qr_grid_model` — the CUDA kernel's
  row partition and one-round merge in eager PyTorch (tests, and
  ``chip_smoke.py`` as a leaf of the blocked engine on the card);
* the **launch plan** :func:`kernel_grid` / :func:`kernel_resident` /
  :func:`kernel_flat_width` — the kernel's row partition, whether the
  slices fit shared memory, and the leaf width the blocked engine plans
  with, each for the card's SMs or a cap on them
  (:data:`LOOKAHEAD_CTAS`). The launcher only checks the plan it is given;
* the **launch counts** :data:`LAUNCHES`, one integer per kernel, which
  the wrapper raises by one per launch and nowhere else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from dhqr_tpu_torch.ops import _build
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
# The kernel indexes a panel's elements with int32.
KERNEL_MAX_ELEMENTS = 2**31 - 1
# CTA cap of a panel launched beside a trailing GEMM (the lookahead
# schedule's side stream, ops/blocked.py): the cooperative grid must be
# resident at once, so it takes at most this many SMs and leaves the rest
# to cuBLAS. Chosen from the cap sweep of chip_smoke.py phase 11.
LOOKAHEAD_CTAS = 66

KERNELS = {torch.float32: "panel_qr_f32", torch.complex64: "panel_qr_c64"}

LAUNCHES = {name: 0 for name in KERNELS.values()}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    elem = 8 if dtype == torch.complex64 else 4
    return per * nb * elem <= smem_per_block - KERNEL_STATIC_SMEM


def panel_kernel_supported(m: int, nb: int, dtype) -> bool:
    """True when the kernel takes an (m, nb) panel of ``dtype``: float32 or
    complex64, 1 <= nb <= :data:`KERNEL_MAX_WIDTH`, m >= nb, and int32
    element indices. Any height that passes runs on the card: resident in
    shared memory where it fits (:func:`kernel_resident`), streamed where
    it does not."""
    return (dtype in KERNELS and 1 <= nb <= KERNEL_MAX_WIDTH and m >= nb
            and m * nb <= KERNEL_MAX_ELEMENTS)


def kernel_flat_width(rows: int, dtype, sms: int = H100_SMS,
                      smem_per_block: int = H100_SMEM_PER_BLOCK) -> int:
    """The leaf width the blocked engine gives the kernel for panels of
    ``rows`` rows (its recursion splits a wider panel into leaves this
    wide): the widest in :data:`KERNEL_LEAF_WIDTHS` whose slices fit the
    shared memory of a card of ``sms`` SMs; past that, the narrowest, which
    the kernel streams; 0 for a ``dtype`` the kernel does not take or a
    leaf past int32 element indices.

    On an H100: 16384 rows f32 -> 128 (125 rows x 512 B per CTA); 65536
    rows f32 -> 64 (497 rows x 256 B; 512 B would not fit 227 KB); from
    ~462k rows f32 -> 16, streamed.
    """
    narrow = KERNEL_LEAF_WIDTHS[-1]
    if dtype not in KERNELS or not 1 <= rows * narrow <= KERNEL_MAX_ELEMENTS:
        return 0
    for width in KERNEL_LEAF_WIDTHS:
        if kernel_resident(rows, width, dtype, sms, smem_per_block):
            return width
    return narrow


# -- plain versions ---------------------------------------------------------

def _sumsq_compensated(x: torch.Tensor) -> torch.Tensor:
    """Compensated sum of squares of a 1-D float32 row, as the TPU kernel
    computes it: a Veltkamp split (constant 2^12 + 1) makes every square
    exact as p + e; the p plane is zero-padded to the next power of two
    (widths >= 256) and summed by a contiguous-halving TwoSum tree down to
    128 lanes with the errors folded into a scalar; a plain sum ends it."""
    p = x * x
    c = x * 4097.0
    hi = c - (c - x)
    lo = x - hi
    e = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    err = torch.sum(e)
    w = p.shape[0]
    if w >= 256:
        w2 = 1 << (w - 1).bit_length()
        if w2 != w:
            p = F.pad(p, (0, w2 - w))
            w = w2
        while w > 128:
            h = w // 2
            a, b = p[:h], p[h:]
            s = a + b
            z = s - a
            err = err + torch.sum((a - (s - z)) + (b - z))  # TwoSum error
            p = s
            w = h
    return torch.sum(p) + err


def _inv_scale(s: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    denom = s * (s + mag)
    ok = denom > 0
    return torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, denom, 1.0)), 0.0)


def _panel_qr_plain(at: torch.Tensor, offset: int) -> torch.Tensor:
    """Float32 kernel, plain: factor the transposed panel ``at`` (nb, m) in
    place; returns alpha (nb,)."""
    nb, m = at.shape
    lane = torch.arange(m, device=at.device)
    alpha = at.new_zeros(nb)
    for jl in range(nb):
        j = offset + jl
        row = at[jl].clone()
        rmask = lane >= j
        rowm = torch.where(rmask, row, 0.0)
        s = torch.sqrt(_sumsq_compensated(rowm))
        a_jj = row[j]
        alpha_j = torch.where(a_jj >= 0, -s, s)
        f = _inv_scale(s, a_jj.abs())
        v = (rowm - alpha_j * (lane == j).to(at.dtype)) * f
        W = torch.matmul(at[jl + 1:], v)  # partial dots, full FP32
        at[jl + 1:] -= W[:, None] * v[None, :]
        at[jl] = torch.where(rmask, v, row)
        alpha[jl] = alpha_j
    return alpha


def _panel_qr_plain_c64(at: torch.Tensor, offset: int) -> torch.Tensor:
    """Complex64 kernel, plain, in real-plane arithmetic: factor ``at``
    (nb, m) in place; returns alpha (nb,)."""
    nb, m = at.shape
    planes = torch.view_as_real(at)
    ar, ai = planes[..., 0], planes[..., 1]
    lane = torch.arange(m, device=at.device)
    alpha = at.new_zeros(nb)
    for jl in range(nb):
        j = offset + jl
        rowr, rowi = ar[jl].clone(), ai[jl].clone()
        rmask = lane >= j
        rowmr = torch.where(rmask, rowr, 0.0)
        rowmi = torch.where(rmask, rowi, 0.0)
        s = torch.sqrt(_sumsq_compensated(rowmr) + _sumsq_compensated(rowmi))
        ar_jj, ai_jj = rowr[j], rowi[j]
        mag = torch.sqrt(ar_jj * ar_jj + ai_jj * ai_jj)
        live = mag > 0
        inv = torch.where(live, 1.0 / torch.where(live, mag, 1.0), 0.0)
        alr = s * torch.where(live, -ar_jj * inv, -1.0)
        ali = s * torch.where(live, -ai_jj * inv, 0.0)
        f = _inv_scale(s, mag)
        ej = (lane == j).to(ar.dtype)
        vr = (rowmr - alr * ej) * f
        vi = (rowmi - ali * ej) * f
        tr, ti = ar[jl + 1:], ai[jl + 1:]
        Wr = (torch.matmul(tr, vr) + torch.matmul(ti, vi))[:, None]
        Wi = (torch.matmul(ti, vr) - torch.matmul(tr, vi))[:, None]
        new_r = tr - (Wr * vr - Wi * vi)
        new_i = ti - (Wr * vi + Wi * vr)
        tr.copy_(new_r)
        ti.copy_(new_i)
        ar[jl] = torch.where(rmask, vr, rowr)
        ai[jl] = torch.where(rmask, vi, rowi)
        alpha[jl] = torch.complex(alr, ali)
    return alpha


_PLAIN = {torch.float32: _panel_qr_plain, torch.complex64: _panel_qr_plain_c64}


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
    blocked engine's leaf (:func:`_panel_qr_grid_leaf`).
    """
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


# -- the kernels ------------------------------------------------------------

_LIBS: "dict[bool, ctypes.CDLL]" = {}

# Sections of a column step timed by the build with -DDHQR_PANEL_PROFILE.
PROFILE_SECTIONS = ("merge", "column_pass", "trailing_pass", "barrier")


def _library(profile: bool = False) -> ctypes.CDLL:
    """The kernels' library; ``profile=True`` is the build with section
    timers, a library of its own."""
    if profile not in _LIBS:
        lib = _build.load("panel_qr",
                          ("DHQR_PANEL_PROFILE",) if profile else ())
        lib.dhqr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dhqr_cuda_error_string.restype = ctypes.c_char_p
        lib.dhqr_panel_qr_info.argtypes = [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.dhqr_panel_qr_info.restype = ctypes.c_int
        lib.dhqr_panel_qr_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.dhqr_panel_qr_scratch_floats.restype = ctypes.c_longlong
        for kname in KERNELS.values():
            fn = getattr(lib, f"dhqr_{kname}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p,
                           *[ctypes.c_int] * 6, ctypes.c_void_p]
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
          sms: "int | None" = None) -> "tuple[int, int, bool]":
    """(CTAs, rows per CTA, resident) of the launch for an (m, nb) panel at
    ``offset`` on ``device``'s card, on at most ``sms`` SMs."""
    limits = device_limits(device, sms)
    ctas, rows = kernel_grid(m - offset, limits[0])
    return ctas, rows, kernel_resident(m - offset, nb, dtype, *limits)


def kernel_launch_info(m: int, nb: int, offset: int, dtype,
                       device=None, sms: "int | None" = None) -> dict:
    """The launch the CUDA kernel makes for an (m, nb) panel at ``offset``
    on ``device``'s card, on at most ``sms`` SMs: CTAs, rows per CTA and
    residency as planned here, and from the launcher the shared bytes per
    CTA, registers and spill bytes per thread, resident CTAs per SM and the
    scratch's floats. Raises what the launch would raise."""
    device = torch.device("cuda" if device is None else device)
    ctas, rows, resident = _plan(m, nb, offset, dtype, device, sms)
    out = (ctypes.c_int * 5)()
    complex64 = int(dtype == torch.complex64)
    with torch.cuda.device(device):
        lib = _library()
        err = lib.dhqr_panel_qr_info(complex64, m, nb, offset, ctas, rows,
                                     int(resident), out)
        _raise_on(err, f"{KERNELS[dtype]} launch plan for ({m}, {nb}) at "
                  f"{offset}")
        scratch = lib.dhqr_panel_qr_scratch_floats(complex64, ctas, nb)
    keys = ("smem_dynamic_bytes", "smem_static_bytes", "registers",
            "spill_bytes", "ctas_per_sm")
    return {"ctas": ctas, "rows_per_cta": rows, "resident": resident,
            **dict(zip(keys, out)), "scratch_floats": scratch}


def _launch(at: torch.Tensor, alpha: torch.Tensor, offset: int,
            profile: bool = False, sms: "int | None" = None) -> None:
    """Launch the kernel on ``at`` on the current stream, on at most
    ``sms`` SMs; its scratch and barrier are allocated on that stream."""
    name = KERNELS[at.dtype]
    lib = _library(profile)
    nb, m = at.shape
    if not (at.is_contiguous() and alpha.is_contiguous()):
        raise ValueError("the panel kernel takes contiguous buffers")
    ctas, rows, resident = _plan(m, nb, offset, at.dtype, at.device, sms)
    floats = lib.dhqr_panel_qr_scratch_floats(int(at.dtype == torch.complex64),
                                              ctas, nb)
    scratch = torch.empty(floats, dtype=torch.float32, device=at.device)
    barrier = torch.zeros(1, dtype=torch.int32, device=at.device)
    with torch.cuda.device(at.device):
        stream = torch.cuda.current_stream(at.device).cuda_stream
        err = getattr(lib, f"dhqr_{name}")(
            at.data_ptr(), alpha.data_ptr(), scratch.data_ptr(), floats,
            barrier.data_ptr(), m, nb, offset, ctas, rows, int(resident),
            stream)
    _raise_on(err, f"{name} launch")
    LAUNCHES[name] += 1


def kernel_section_cycles(panel: torch.Tensor, offset: int = 0) -> dict:
    """Factor a CUDA panel once with the kernel's timed build; returns, for
    each of :data:`PROFILE_SECTIONS`, the SM cycles per column that each
    CTA's first thread spent there, as the mean and the max over the CTAs.
    A measurement, not a path of the port."""
    m, nb = panel.shape
    at = panel.T.contiguous()
    alpha = torch.empty(nb, dtype=panel.dtype, device=panel.device)
    _launch(at, alpha, offset, profile=True)
    torch.cuda.synchronize(panel.device)
    ctas = _plan(m, nb, offset, panel.dtype, panel.device)[0]
    buf = (ctypes.c_ulonglong * (len(PROFILE_SECTIONS) * ctas))()
    with torch.cuda.device(panel.device):
        _raise_on(_library(True).dhqr_panel_qr_profile(buf, ctas),
                  "reading the section timers")
    cycles = torch.tensor(list(buf), dtype=torch.float64).reshape(ctas, -1) / nb
    return {"mean": dict(zip(PROFILE_SECTIONS, cycles.mean(0).tolist())),
            "max": dict(zip(PROFILE_SECTIONS, cycles.max(0).values.tolist()))}


def _panel_qr_kernel(panel: torch.Tensor, offset: int,
                     sms: "int | None" = None):
    """Factor an (m, nb) panel whose reflector for local column jj starts at
    row ``offset + jj``; returns ``(pf, alpha)`` in the packed storage of
    ``householder._panel_qr_masked``. ``panel`` itself is not modified.

    A CUDA tensor launches the Hopper kernel on the current stream, on at
    most ``sms`` SMs (default: all; its slices resident in shared memory
    where they fit, streamed where they do not); a CPU tensor runs the
    plain version. Anything the kernel does not take raises, and so does a
    panel that requires grad.
    """
    refuse_grad(panel, "the Hopper panel kernel")
    m, nb = panel.shape
    if not panel_kernel_supported(m, nb, panel.dtype):
        raise ValueError(
            f"the panel kernel takes float32/complex64 panels with m >= nb, "
            f"nb <= {KERNEL_MAX_WIDTH} and at most 2^31 - 1 elements, got "
            f"{tuple(panel.shape)} {panel.dtype}")
    if not 0 <= offset <= m - nb:
        raise ValueError(f"panel offset {offset} out of range for "
                         f"{tuple(panel.shape)}")
    at = torch.empty((nb, m), dtype=panel.dtype, device=panel.device)
    at.copy_(panel.T)  # (nb, m): panel column j -> row j
    if panel.device.type == "cuda":
        alpha = torch.empty(nb, dtype=panel.dtype, device=panel.device)
        _launch(at, alpha, int(offset), sms=sms)
    elif panel.device.type == "cpu":
        alpha = _PLAIN[panel.dtype](at, int(offset))
    else:
        raise ValueError(f"no panel kernel for device {panel.device}")
    return at.T, alpha


def panel_qr_kernel(panel: torch.Tensor):
    """Factor an (m, nb) float32/complex64 panel with the Hopper kernel
    (plain version for a CPU tensor); returns ``(pf, alpha)``."""
    m, nb = panel.shape
    if m < nb:
        raise ValueError(f"panel_qr_kernel requires m >= nb, got {tuple(panel.shape)}")
    if panel.dtype not in KERNELS:
        raise ValueError(
            f"panel_qr_kernel supports float32/complex64, got {panel.dtype}")
    return _panel_qr_kernel(panel, 0)
