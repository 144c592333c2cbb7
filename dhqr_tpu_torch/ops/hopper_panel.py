"""Hopper panel factorization kernels — port of ``dhqr_tpu/ops/pallas_panel.py``.

The fused panel factorization (float32, and complex64) runs as a CUDA C++
kernel written for ``sm_90a`` (``csrc/panel_qr.cu``; its header says what
bounds it and how it is built). This module holds, per kernel:

* the **wrapper** :func:`_panel_qr_kernel` — checks the panel, transposes
  it into a contiguous (nb, m) buffer as the JAX side does, factors that
  buffer in place and returns ``(pf, alpha)``. A CUDA tensor launches the
  kernel or raises; only a CPU tensor takes the plain version (the
  counterpart of the Pallas interpreter). There is no fallback;
* the **plain versions** :func:`_panel_qr_plain` and
  :func:`_panel_qr_plain_c64` — the TPU kernels' algorithm step by step in
  eager PyTorch, including :func:`_sumsq_compensated` (eager PyTorch rounds
  every op on its own, so the Veltkamp split holds as written);
* the **launch counts** :data:`LAUNCHES`, one integer per kernel, which
  the wrapper raises by one per launch and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dhqr_tpu_torch.ops import _build

# Widest panel one launch takes (csrc/panel_qr.cu kMaxWidth); the blocked
# engine's recursion splits wider panels into kernel leaves of this width.
KERNEL_MAX_WIDTH = 128

KERNELS = {torch.float32: "panel_qr_f32", torch.complex64: "panel_qr_c64"}

LAUNCHES = {name: 0 for name in KERNELS.values()}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def panel_kernel_supported(m: int, nb: int, dtype) -> bool:
    """True when the kernel takes an (m, nb) panel of ``dtype``: float32 or
    complex64, 1 <= nb <= :data:`KERNEL_MAX_WIDTH`, m >= nb, and int32
    element indices. The panel stays in global memory, so there is no
    capacity gate beyond that."""
    return (dtype in KERNELS and 1 <= nb <= KERNEL_MAX_WIDTH and m >= nb
            and m * nb < 2**31)


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


# -- the kernels ------------------------------------------------------------

_LAUNCHERS: "dict[str, object]" = {}


def _launcher(name: str):
    if name not in _LAUNCHERS:
        lib = _build.load("panel_qr")
        lib.dhqr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dhqr_cuda_error_string.restype = ctypes.c_char_p
        for kname in KERNELS.values():
            fn = getattr(lib, f"dhqr_{kname}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _LAUNCHERS[kname] = (fn, lib.dhqr_cuda_error_string)
    return _LAUNCHERS[name]


def _launch(at: torch.Tensor, alpha: torch.Tensor, offset: int) -> None:
    name = KERNELS[at.dtype]
    fn, error_string = _launcher(name)
    nb, m = at.shape
    if not (at.is_contiguous() and alpha.is_contiguous()):
        raise ValueError("the panel kernel takes contiguous buffers")
    with torch.cuda.device(at.device):
        stream = torch.cuda.current_stream(at.device).cuda_stream
        err = fn(at.data_ptr(), alpha.data_ptr(), m, nb, offset, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"({error_string(err).decode()})")
    LAUNCHES[name] += 1


def _panel_qr_kernel(panel: torch.Tensor, offset: int):
    """Factor an (m, nb) panel whose reflector for local column jj starts at
    row ``offset + jj``; returns ``(pf, alpha)`` in the packed storage of
    ``householder._panel_qr_masked``. ``panel`` itself is not modified.

    A CUDA tensor launches the Hopper kernel; a CPU tensor runs the plain
    version. Anything the kernel does not take raises.
    """
    m, nb = panel.shape
    if not panel_kernel_supported(m, nb, panel.dtype):
        raise ValueError(
            f"the panel kernel takes float32/complex64 panels with m >= nb "
            f"and nb <= {KERNEL_MAX_WIDTH}, got {tuple(panel.shape)} "
            f"{panel.dtype}")
    if not 0 <= offset <= m - nb:
        raise ValueError(f"panel offset {offset} out of range for "
                         f"{tuple(panel.shape)}")
    at = torch.empty((nb, m), dtype=panel.dtype, device=panel.device)
    at.copy_(panel.T)  # (nb, m): panel column j -> row j
    if panel.device.type == "cuda":
        alpha = torch.empty(nb, dtype=panel.dtype, device=panel.device)
        _launch(at, alpha, int(offset))
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
