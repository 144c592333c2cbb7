#!/usr/bin/env python3
"""On-card smoke run of dhqr_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed N]
                          [--phases 0,1,2,3,4,5,6,8,9,10,11,12,13,14,15,16]
                          [--accuracy-seeds N]

Needs one CUDA card (an H100 for the bounds below); exits non-zero without
one, and without the port beside it. Phases, each of which fails the run
on any error (0-6 and 8-16 run by default, 7 on request):

0. setup: the card's name and power limit, the nvcc build of the port's
   kernels (timed as set-up), and the full-FP32 matmul check;
1. every kernel against its plain PyTorch version on the card, at the
   leading panel shapes of the main, TSQR and gradient paths, at the
   sharded ``lstsq``'s 125-wide panels (its first and last), and at the
   shapes that stress the kernel's grid (an
   offset inside a CTA's slice, a ragged last CTA, a panel on a few CTAs,
   the tall 64-wide leaf, 12-decade data over every SM, and panels too
   tall for shared memory, which the kernel streams, and the lookahead
   schedule's launches capped at ``LOOKAHEAD_CTAS`` SMs), with its grid,
   residency, shared memory, registers and spills, a bit-identical repeat
   launch, and at the main path's shapes and the streamed ones its time,
   the plain version's time, ``torch.geqrf``'s time on the same panel (a
   yardstick the port never calls) and the card's bound for the work;
2. main path, float32, square: ``qr`` and ``solve`` (each timed on its
   first call, which holds first-use set-up, and on a steady-state second
   call) and ``lstsq`` at 16384 x 16384, backward error and kernel launch
   counts;
3. main path, float32, tall: ``lstsq`` at 65536 x 256 and at 524288 x 128
   (streamed 16-wide leaves) against ``torch.linalg.lstsq`` (yardstick) on
   the normal-equations residual;
4. main path, complex64: ``qr`` (first and second call) -> ``solve`` at
   8192 x 4096;
5. the reference's criterion: ``lstsq`` at 4400 x 4000, float32 and
   complex64, within 8x of numpy's LAPACK QR on the normal-equations
   residual;
6. where the time goes: ``torch.profiler`` device time of one 16384^2
   float32 ``qr`` by kernel class (panel kernel, GEMM, triangular solve,
   other) and the device's busy share of the call's wall time;
7. (opt-in: ``--phases 0,7``) where a panel's time goes: the kernel's time
   per call at panels from 5 to 132 CTAs, and the SM cycles per column in
   each section of a column step (merge, column pass, trailing pass, grid
   barrier) from a second build with section timers
   (``-DDHQR_PANEL_PROFILE``);
8. precision: the ``"high"`` (3 bf16 passes) and ``"default"`` (1 pass)
   products of ``ops/gemm.py`` on the card against their plain versions at
   the trailing update's shapes, f32 and c64, with their times and the full
   FP32 product's; ``qr`` at 16384^2 f32 for each trailing precision
   (steady-state second call, backward error); ``lstsq`` at 4400 x 4000,
   f32 and c64, for every ``POLICY_LADDER`` cell and the three presets, as
   a ratio to numpy's LAPACK QR (``accurate`` must meet 8x, the other
   rungs must be finite and say whether they do), beside the same ratio of
   witnesses (``torch.linalg.lstsq``; the port's factors with Q^H b
   through an explicit Q); and the factor quality at 4400 x 4000, f32 and
   c64 (backward error and orthogonality in f64 on the card) of the
   kernel's factors, the plain panel loop's and the kernel's schedule in
   eager PyTorch (the grid model as the engine's leaf, on the card), the
   kernel within 2x of the plain loop, with their ``lstsq`` ratios
   (``--accuracy-seeds N`` repeats kernel and plain loop for N seeds);
9. engines at ``BASELINE.json``'s tall-skinny 65536 x 256 f32:
   ``tsqr_lstsq`` (8 leaves of 8192 x 256; and c64 at 32768 x 256),
   ``tsqr_r`` (Gram identity), ``cholesky_qr_lstsq`` (shift off and on) and
   ``lstsq(engine=...)`` for tsqr, cholqr2 and cholqr3, each against
   ``torch.linalg.lstsq`` (yardstick) under the 8x bar and timed; each
   TSQR call's kernel launches equal the port's panel plan;
10. gradients: ``lstsq_diff`` at 4096 x 512 f32 (and 2048 x 256 c64), the
   gradient of a scalar loss against the float64 normal-equations gradient
   autograd computes on the card (a yardstick the port never calls), the
   adjoint identity between ``jvp`` and ``backward``, forward + backward
   time against the forward alone, and the forward's kernel launches;
11. schedules: ``qr`` at 16384^2 f32 and 8192 x 4096 c64 by default, with
   ``lookahead=True`` and with ``agg_panels`` 2 and 4 (steady seconds,
   GFLOP/s, backward error, distance from the default's factors, launches
   = plan), the lookahead CTA cap swept over 16/33/66/132 with the
   ``torch.profiler`` device time in which a panel kernel and a GEMM ran
   at once, and ``lstsq`` at 4400 x 4000 per schedule under the 8x bar;
12. reconstruct: ``qr`` + ``solve`` with ``panel_impl="reconstruct"`` and
   ``"reconstruct:4096"`` at 16384 x 2048, f32 (plain panel path) and f64,
   beside the ``"loop"`` engine, and ``lstsq`` at 4400 x 4000 under 8x;
13. sketch: ``lstsq(engine="sketch")`` at 65536 x 256 and 131072 x 256 f32
   and 32768 x 256 c64 (SRHT by "auto"), and the count sketch at 65536 x
   256, against ``torch.linalg.lstsq`` (8x) beside it and ``cholqr2``,
   with the operator draws per call;
14. sharded: the distributed tier, its ranks spawned processes that share
   card 0 (``dhqr_tpu_torch/parallel/_ranks.py``; the compute mode must
   be Default and MPS off): (a) NCCL with one rank, ``qr`` + ``solve`` at
   16384^2 f32 on ``column_mesh``, default and ``lookahead``, beside the
   single-device ``lookahead`` factors, and one mesh ``solve`` traced with
   ``torch.profiler`` beside the single-device one (the card's busy time
   and the ops that take the most device and host time); (b) gloo with 4
   ranks, the same per
   layout (block, cyclic) and schedule (default, ``lookahead``,
   ``agg_panels=2``); (c) gloo with 2 ranks, c64 ``qr`` + ``solve`` at
   8192 x 4096; (d) gloo with 4 ranks, ``lstsq(mesh=)`` at the reference's
   4400 x 4000 f32 and c64 and at 4400 x 3998 f32 (padded) under 8x; (e)
   gloo with 4 ranks, TSQR and CholeskyQR2 on the row mesh at 65536 x 256
   f32 against ``torch.linalg.lstsq`` (8x). Each factorization's backward
   error, its distance from the single-device factors (H for the one-rank
   default, else R up to row signs, with the pivots that took the other
   sign and the first one's size), its solve's normal-equations residual
   against the single-device solve's (8x), and the launches summed over
   the ranks against the single-device plan (P times it for
   ``agg_panels``, every rank factoring each group; TSQR: P times a leaf
   and a combine). Gloo carries the
   collectives through the host and the ranks time-share one H100, so a
   time here is never a scaling number;
15. guarded: ``guarded_lstsq`` at 16384^2 f32 in the default "fallback"
   mode against the unguarded ``lstsq`` (x bit-identical, the same
   launches, the guard's cost in percent), the same under an injected
   ``numeric.breakdown`` (the policy rung answers within 8x of
   ``torch.linalg.lstsq``), ``engine="cholqr2"`` with ``guards="full"`` at
   65536 x 256 f32 of condition 1e5 (rung 0 breaks down, the answer meets
   the residual gate) and a schedule that lands on the tsqr rung (its
   launches the TSQR plan), ``guarded_qr`` at 8192 x 4096 c64 (launches,
   backward error; a zero column refused before any launch) and
   ``guards="full"`` at 4400 x 4000 f32; then ``UpdatableQR`` on a stream
   of 64 rank-1 steps at 65536 x 256 f32 (refactor reasons, 4 launches
   for the initial factorization and each refactor and none for any other
   step, the sweeps' R against the live A's Gram beside what a sweep that
   did nothing would read, solves within 8x of ``torch.linalg.lstsq``, an
   update/downdate round trip, ms per update and per solve, kernels per
   update from ``torch.profiler``, beside a fresh ``qr`` and ``lstsq``);
16. wire: the compressed wire, the two-tier pod mesh, the depth-k
   pipeline and pulse, ranks sharing card 0 as in 14: (a) NCCL with one
   rank, ``qr(mesh=)`` + ``solve`` at 16384^2 f32 at ``comms`` None,
   ``"bf16"`` and ``"int8"``; (b) gloo with 4 ranks at 16384^2 f32: None,
   flat bf16 and int8, a 2x2 ``pod_mesh`` hierarchical and flat at None
   and ``"dcn:bf16"``, ``overlap_depth`` 2 and 3 at None and bf16; each
   with its seconds, backward error (a compressed one above the
   uncompressed one's, and below 0.05 on the bf16 wire), launches summed over the ranks (the plan, 128,
   pipelines included) and the wire census by family and leg, every
   entry's bytes equal to ``wire_bytes_formula`` and their ratio to the
   uncompressed bytes printed; (c) ``lstsq(mesh=)`` at the reference's
   4400 x 4000 f32 at bf16 and int8 on the column mesh and dcn:bf16 and
   dcn:int8 on the 2x2 pod mesh, with the model tier's floor of sweeps (its
   ratio to numpy's LAPACK QR printed: the floor does not reach 8x at this
   condition, nor int8 at all) and bf16 / dcn:bf16 with ``refine=6``
   sweeps, under 8x; (d) TSQR
   and CholeskyQR2 on a 4-rank row mesh at 65536 x 256 f32 uncompressed
   and at bf16 and int8, under 8x of numpy's LAPACK QR (with
   ``torch.linalg.lstsq``'s ratio beside it); (e) gloo with 2 ranks, 8192 x
   4096 c64 at bf16: no complex payload compressed, H, alpha and x
   bit-identical to None's; (f) pulse armed around one ``qr`` + ``solve``
   of (a) and of (b): the measured collective families, the census, and
   DHQR306, which must read skip with its reason.

Launch counts are zeroed right before each counted path and read right
after it: the main path (phases 2-5), the precision path (8), the TSQR
path (9), the gradient path (10), the schedules path (11), the
reconstruct (12) and sketch (13) paths, which must launch no panel kernel,
the sharded path (14), whose ranks' counts of their mesh calls alone
(zeroed after the single-device references each rank computes) are added
to the parent's, the guarded path (15 (a)-(e), its guarded calls), the
update path (15 (f), the stream's calls), each of which must equal what
the phase's own calls counted; the yardsticks inside them (the unguarded
``lstsq`` of (a), the fresh ``qr`` / ``lstsq`` of (f)) are taken back out
of the counts, and the wire path (16), whose ranks' counts are added to
the parent's. The ``kernels`` line sums the paths.
Phases 6 and 7 are measurements and are not counted. Each phase prints
JSON lines; then the ``kernels`` line, the card's ``nvidia-smi`` name and
power limit, and last the result line. Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 SIMT FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# Stated tolerances.
TOL_F32 = 2e-5       # kernel vs plain, f32: relative to max|.| of the plain result
TOL_C64 = 5e-5       # kernel vs plain, c64
TOL_DECADES = 5e-7   # |alpha_0| vs the f64 column norm on 12-decade data
TOL_BACKWARD_F32 = 1e-5   # ||QR - A|| / ||A||, float32 (BASELINE.json)
TOL_BACKWARD_C64 = 5e-5   # the same, complex64
TOL_SOLVE_AGREE = 1e-5    # ||x - x2|| / ||x2||, qr().solve vs lstsq
CRITERION = 8.0           # normal-equations residual factor (reference)
TOL_BF16 = 1e-5      # bf16 pass vs plain: max|diff| / max(|C| + |A||B|)
TOL_GRAM = 2e-5      # ||R^H R - A^H A|| / ||A^H A||, f32 R (TSQR, sweeps)
TOL_GRAD = 1e-4      # f32 gradient vs the f64 normal-equations gradient
TOL_ADJOINT = 1e-4   # |<w, J u> - <J^T w, u>| / |<w, J u>|, f32

KERNEL_SOURCE = "dhqr_tpu_torch/csrc/panel_qr.cu"
REPLACES = {"panel_qr_f32": "dhqr_tpu/ops/pallas_panel.py:192",
            "panel_qr_c64": "dhqr_tpu/ops/pallas_panel.py:247"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def wall(fn):
    """(result, seconds) of ``fn`` ending in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def panel_bound(m: int, nb: int, complex_: bool):
    """(ms, "bytes" | "operations"): the least time for one (m, nb) panel,
    the larger of reading + writing the panel (and alpha) over HBM and
    ~2 m nb^2 FP32 operations (x4 complex) over the SIMT peak."""
    words = 2 if complex_ else 1
    t_bytes = (2 * m * nb + nb) * 4 * words / HBM_BYTES_PER_S
    t_ops = 2 * m * nb * nb * (4 if complex_ else 1) / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def random_panel(rng, m, nb, dtype, decades=False):
    x = rng.standard_normal((m, nb))
    if decades:
        x = x * np.logspace(-6, 6, m)[:, None]
    if dtype == torch.complex64:
        x = x + 1j * rng.standard_normal((m, nb))
        return torch.from_numpy(x.astype(np.complex64)).cuda()
    return torch.from_numpy(x.astype(np.float32)).cuda()


def random_problem(m, n, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = (rng.random((m, n)) + 1j * rng.random((m, n))).astype(dtype)
        b = (rng.random(m) + 1j * rng.random(m)).astype(dtype)
    else:
        A = rng.random((m, n)).astype(dtype)
        b = rng.random(m).astype(dtype)
    return A, b


_LAPACK = {}


def lapack_problem(m, n, dtype, seed):
    """(A, b, numpy's LAPACK solution) of ``random_problem``, solved once
    per process: phases 5, 8, 11 and 12 share the reference's problems."""
    key = (m, n, np.dtype(dtype).name, seed)
    if key not in _LAPACK:
        from dhqr_tpu_torch.utils.testing import lapack_lstsq

        A, b = random_problem(m, n, dtype, seed)
        _LAPACK[key] = (A, b, lapack_lstsq(A, b))
    return _LAPACK[key]


def oracle_of(m, n, dtype, seed):
    """(A, b, the oracle's normal-equations residual)."""
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    A, b, x = lapack_problem(m, n, dtype, seed)
    return A, b, normal_equations_residual(A, x, b)


# -- phases ------------------------------------------------------------------

def phase_setup():
    from dhqr_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    from dhqr_tpu_torch.ops.hopper_panel import _library

    _library()
    assert torch.backends.cuda.matmul.allow_tf32 is False, \
        "TF32 matmuls are on: precision='highest' needs full FP32"
    assert torch.get_float32_matmul_precision() == "highest"
    emit({"phase": 0, "name": "setup", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "libraries": sorted(p.name for p in paths.values()),
          "ptxas": [ln.strip() for name in paths
                    for ln in _build.build_log(name).splitlines()
                    if "Used" in ln or "spill" in ln]})
    return smi


def phase_kernels(seed):
    from dhqr_tpu_torch.ops import hopper_panel as hp

    rng = np.random.default_rng(seed)
    cases = [  # (kernel, m, nb, offset, 12-decade data, main-path shape,
        #        slice resident in shared memory)
        ("panel_qr_f32", 16384, 128, 0, False, True, True),
        ("panel_qr_f32", 16384, 128, 64, False, False, True),  # mid-slice
        ("panel_qr_f32", 8193, 128, 0, False, False, True),    # ragged last
        ("panel_qr_f32", 129, 128, 0, False, False, True),     # a few CTAs
        ("panel_qr_f32", 65536, 64, 0, False, False, True),    # the tall leaf
        ("panel_qr_f32", 4096, 32, 5, False, False, True),
        ("panel_qr_f32", 767, 8, 0, True, False, True),
        ("panel_qr_f32", 16384, 8, 0, True, False, True),      # 132 CTAs
        ("panel_qr_f32", 65536, 128, 0, False, False, False),  # streamed
        ("panel_qr_f32", 524288, 16, 0, False, False, False),  # streamed leaf
        # the leading panels of the TSQR path (phase 9: leaves of 8192 rows,
        # a 2048-row combine on 64 and 60 CTAs) and of the gradient path
        # (phase 10: 4096 rows)
        ("panel_qr_f32", 8192, 128, 0, False, False, True),
        ("panel_qr_f32", 8064, 128, 0, False, False, True),
        ("panel_qr_f32", 2048, 128, 0, False, False, True),
        ("panel_qr_f32", 1920, 128, 0, False, False, True),
        ("panel_qr_f32", 4096, 128, 0, False, False, True),
        # the sharded lstsq's panels (phase 14: 4400 x 4000 on 4 ranks,
        # nb = 125, one leaf each): the first and the last
        ("panel_qr_f32", 4400, 125, 0, False, False, True),
        ("panel_qr_f32", 525, 125, 0, False, False, True),
        ("panel_qr_c64", 8192, 128, 0, False, True, True),
        ("panel_qr_c64", 4096, 32, 5, False, False, True),
        ("panel_qr_c64", 131, 128, 3, False, False, True),
        ("panel_qr_c64", 32768, 128, 7, False, False, False),  # streamed
        ("panel_qr_c64", 262144, 16, 3, False, False, False),  # streamed leaf
        # TSQR (leaves of 4096 rows, a 2048-row combine) and gradient
        # (2048 rows) panels
        ("panel_qr_c64", 4096, 128, 0, False, False, True),
        ("panel_qr_c64", 3968, 128, 0, False, False, True),
        ("panel_qr_c64", 2048, 128, 0, False, False, True),
        ("panel_qr_c64", 1920, 128, 0, False, False, True),
        ("panel_qr_c64", 4400, 125, 0, False, False, True),
        ("panel_qr_c64", 525, 125, 0, False, False, True),
    ]
    # the last field: the CTA cap; the lookahead schedule's capped launches
    # at the main path's panels (phase 11)
    cap = hp.LOOKAHEAD_CTAS
    cases = [case + (None,) for case in cases] + [
        ("panel_qr_f32", 16384, 128, 0, False, False, True, cap),
        ("panel_qr_c64", 8192, 128, 0, False, False, True, cap)]
    stats = {}
    for name, m, nb, off, decades, main_shape, resident, sms in cases:
        dtype = torch.float32 if name.endswith("f32") else torch.complex64
        tol = TOL_F32 if dtype == torch.float32 else TOL_C64
        grid = hp.kernel_launch_info(m, nb, off, dtype, sms=sms)
        panel = random_panel(rng, m, nb, dtype, decades)
        pf, alpha = hp._panel_qr_kernel(panel, off, sms)
        pf2, alpha2 = hp._panel_qr_kernel(panel, off, sms)  # fixed order
        torch.cuda.synchronize()
        repeat_equal = bool(torch.equal(pf, pf2) and torch.equal(alpha, alpha2))
        at = panel.T.contiguous()
        alpha_p = hp._PLAIN[dtype](at, off)
        pf_p = at.T
        err_pf = rel_err(pf, pf_p)
        err_alpha = rel_err(alpha, alpha_p)
        abs_err = float(max((pf - pf_p).abs().max(),
                            (alpha - alpha_p).abs().max()))
        kept = bool(torch.equal(pf[:off], panel[:off]))  # rows above offset
        finite = bool(torch.isfinite(torch.view_as_real(pf) if pf.is_complex()
                                     else pf).all())
        row = {"phase": 1, "kernel": name, "m": m, "nb": nb, "offset": off,
               "cta_cap": sms,
               "grid": grid, "rel_err_pf": err_pf, "rel_err_alpha": err_alpha,
               "max_abs_err": abs_err, "tol": tol, "rows_above_kept": kept,
               "repeat_bit_identical": repeat_equal, "finite": finite}
        ok = (err_pf <= tol and err_alpha <= tol and kept and finite
              and repeat_equal and grid["resident"] == resident)
        if m <= 1024:  # the schedule model at the kernel's grid
            at_m = panel.T.contiguous()
            alpha_m = hp._panel_qr_grid_model(at_m, off, grid["ctas"])
            row["rel_err_vs_grid_model"] = max(rel_err(pf, at_m.T),
                                               rel_err(alpha, alpha_m))
            ok = ok and row["rel_err_vs_grid_model"] <= tol
        if decades:
            s64 = float(np.linalg.norm(panel[:, 0].double().cpu().numpy()))
            dev = abs(abs(float(alpha[0])) - s64) / s64
            row.update(alpha0_rel_dev=dev, tol_decades=TOL_DECADES)
            ok = ok and dev < TOL_DECADES
        if main_shape or not resident or sms:
            row["ms"] = cuda_ms(lambda: hp._panel_qr_kernel(panel, off, sms),
                                5)
            at2 = panel.T.contiguous()
            row["plain_ms"] = cuda_ms(
                lambda: hp._PLAIN[dtype](at2.copy_(panel.T), off),
                2 if main_shape else 1)
            row["library_ms"] = cuda_ms(lambda: torch.geqrf(panel), 5)
            row["bound_ms"], row["bound_by"] = panel_bound(
                m, nb, dtype == torch.complex64)
            del at2
        row["ok"] = ok
        emit(row)
        if not ok:
            raise AssertionError(f"kernel check failed: {row}")
        st = stats.setdefault(name, {"max_abs_err": 0.0})
        st["max_abs_err"] = max(st["max_abs_err"], abs_err)
        if main_shape:
            st.update({k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")})
        del panel, pf, pf2, at, pf_p
    torch.cuda.empty_cache()
    return stats


def expected_launches(m, n, dtype):
    """Kernel leaves the blocked engine's own routing chooses for (m, n)."""
    from dhqr_tpu_torch.ops import blocked

    from dhqr_tpu_torch.ops import hopper_panel as hp

    nb = blocked.DEFAULT_BLOCK_SIZE
    cuda = torch.device("cuda")
    kernel = blocked._resolve_kernel("auto", m, dtype, cuda)
    plan = blocked.panel_plan(m, n, nb, kernel, dtype, cuda)
    off = [k for k, w, leaf in plan if not leaf]
    if off:
        print(f"panels not on the kernel for {m}x{n} {dtype}: columns {off}",
              flush=True)
    limits = hp.device_limits(cuda)
    streamed = [k for k, w, leaf in plan
                if leaf and not hp.kernel_resident(m - k, leaf, dtype, *limits)]
    print(f"kernel leaf widths for {m}x{n} {dtype}: "
          f"{sorted({leaf for k, w, leaf in plan if leaf})}; panels streamed: "
          f"{len(streamed)} of {len(plan)}", flush=True)
    return sum(blocked.kernel_leaves(w, leaf) for k, w, leaf in plan if leaf)


def phase_square(dt, hp, seed, n=16384):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.rand((n, n), generator=g, device="cuda", dtype=torch.float32)
    b = torch.rand((n,), generator=g, device="cuda", dtype=torch.float32)
    expect = expected_launches(n, n, torch.float32)
    l0 = hp.LAUNCHES["panel_qr_f32"]
    fact, t_factor_first = wall(lambda: dt.qr(A))  # first-use set-up inside
    l_qr = hp.LAUNCHES["panel_qr_f32"] - l0
    del fact
    fact, t_factor = wall(lambda: dt.qr(A))
    x, t_solve_first = wall(lambda: fact.solve(b))  # first-use set-up inside
    x, t_solve = wall(lambda: fact.solve(b))
    x2, t_lstsq = wall(lambda: dt.lstsq(A, b))
    l_all = hp.LAUNCHES["panel_qr_f32"] - l0
    R = fact.r_matrix()
    QR = fact.matmul_q(R)
    backward = float(torch.linalg.vector_norm((QR - A).double())
                     / torch.linalg.vector_norm(A.double()))
    del QR, R
    agree = float(torch.linalg.vector_norm((x - x2).double())
                  / torch.linalg.vector_norm(x2.double()))
    finite = bool(torch.isfinite(x).all() and torch.isfinite(fact.H).all())
    del fact
    torch.cuda.empty_cache()
    torch.geqrf(A[:256, :256])  # solver handle warm-up
    _, t_geqrf = wall(lambda: torch.geqrf(A))
    flops = 4.0 / 3.0 * n ** 3
    row = {"phase": 2, "name": "main_f32_square", "shape": [n, n],
           "factor_first_s": t_factor_first, "factor_s": t_factor,
           "solve_first_s": t_solve_first,
           "solve_s": t_solve, "lstsq_s": t_lstsq,
           "gflops": flops / t_factor / 1e9, "geqrf_s": t_geqrf,
           "geqrf_gflops": flops / t_geqrf / 1e9,
           "backward_error": backward, "tol_backward": TOL_BACKWARD_F32,
           "x_vs_lstsq": agree, "bit_equal": bool(torch.equal(x, x2)),
           "launches_qr": l_qr, "launches_qr_lstsq": l_all,
           "expected_per_factorization": expect, "finite": finite}
    row["ok"] = (backward < TOL_BACKWARD_F32 and agree <= TOL_SOLVE_AGREE
                 and finite and expect >= 1 and l_qr == expect
                 and l_all == 3 * expect)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"main path f32 square failed: {row}")


def phase_tall(dt, hp, seed, shapes=((65536, 256), (524288, 128))):
    """The second shape is too tall for any leaf's slices to fit shared
    memory: its panel runs as streamed 16-wide leaves."""
    for i, (m, n) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(seed + 1 + 10 * i)
        A = torch.rand((m, n), generator=g, device="cuda", dtype=torch.float32)
        b = torch.rand((m,), generator=g, device="cuda", dtype=torch.float32)
        expect = expected_launches(m, n, torch.float32)
        l0 = hp.LAUNCHES["panel_qr_f32"]
        x, t_lstsq = wall(lambda: dt.lstsq(A, b))
        l_run = hp.LAUNCHES["panel_qr_f32"] - l0
        x_ref, t_ref = wall(
            lambda: torch.linalg.lstsq(A, b[:, None]).solution[:, 0])
        A64, b64 = A.double(), b.double()

        def ne_res(xx):
            return float(torch.linalg.vector_norm(
                A64.T @ (A64 @ xx.double() - b64)))

        res, res_ref = ne_res(x), ne_res(x_ref)
        row = {"phase": 3, "name": "main_f32_tall", "shape": [m, n],
               "lstsq_s": t_lstsq, "torch_lstsq_s": t_ref,
               "normal_eq_residual": res, "torch_lstsq_residual": res_ref,
               "ratio": res / res_ref, "criterion": CRITERION,
               "launches": l_run, "expected": expect}
        row["ok"] = bool(np.isfinite(res)) and res <= CRITERION * res_ref \
            and l_run == expect
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"main path f32 tall failed: {row}")
        del A, b, A64, b64, x, x_ref
        torch.cuda.empty_cache()


def phase_complex(dt, hp, seed, m=8192, n=4096):
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    A = torch.complex(torch.rand((m, n), generator=g, device="cuda"),
                      torch.rand((m, n), generator=g, device="cuda"))
    b = torch.complex(torch.rand((m,), generator=g, device="cuda"),
                      torch.rand((m,), generator=g, device="cuda"))
    expect = expected_launches(m, n, torch.complex64)
    l0 = hp.LAUNCHES["panel_qr_c64"]
    fact, t_factor_first = wall(lambda: dt.qr(A))  # first-use set-up inside
    l_qr = hp.LAUNCHES["panel_qr_c64"] - l0
    del fact
    fact, t_factor = wall(lambda: dt.qr(A))
    x, t_solve = wall(lambda: fact.solve(b))
    R = torch.cat([fact.r_matrix(), A.new_zeros((m - n, n))])
    QR = fact.matmul_q(R)
    backward = float(torch.linalg.vector_norm((QR - A).to(torch.complex128))
                     / torch.linalg.vector_norm(A.to(torch.complex128)))
    finite = bool(torch.isfinite(torch.view_as_real(x)).all())
    row = {"phase": 4, "name": "main_c64", "shape": [m, n],
           "factor_first_s": t_factor_first, "factor_s": t_factor,
           "solve_s": t_solve,
           "gflops_real": 4 * (2 * m * n * n - 2.0 / 3.0 * n ** 3) / t_factor / 1e9,
           "backward_error": backward, "tol_backward": TOL_BACKWARD_C64,
           "launches_qr": l_qr, "expected": expect, "finite": finite}
    row["ok"] = backward < TOL_BACKWARD_C64 and finite and l_qr == expect
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"main path c64 failed: {row}")


def phase_reference(dt, hp, seed, m=4400, n=4000):
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    for dtype, name in ((np.float32, "panel_qr_f32"),
                        (np.complex64, "panel_qr_c64")):
        A, b, oracle = oracle_of(m, n, dtype, seed + 3)
        l0 = hp.LAUNCHES[name]
        x, t = wall(lambda: dt.lstsq(A, b))
        l_run = hp.LAUNCHES[name] - l0
        x = x.cpu().numpy()
        res = normal_equations_residual(A, x, b)
        row = {"phase": 5, "name": "reference_criterion",
               "dtype": np.dtype(dtype).name, "shape": [m, n], "lstsq_s": t,
               "normal_eq_residual": res, "lapack_residual": oracle,
               "ratio": res / oracle, "criterion": CRITERION,
               "launches": l_run}
        row["ok"] = bool(np.isfinite(res)) and res < CRITERION * oracle \
            and l_run >= 1
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"reference criterion failed: {row}")


def phase_breakdown(dt, seed, n=16384):
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.rand((n, n), generator=g, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t_wall = wall(lambda: dt.qr(A))
    classes = {"panel_kernel": 0.0, "gemm": 0.0, "triangular_solve": 0.0,
               "other": 0.0}
    launches_by_class = dict.fromkeys(classes, 0)
    for evt in prof.key_averages():
        name = evt.key.lower()
        cls = ("panel_kernel" if "panel_qr" in name else
               "gemm" if "gemm" in name else
               "triangular_solve" if "trsm" in name else "other")
        classes[cls] += evt.self_device_time_total / 1e6  # us -> s
        launches_by_class[cls] += evt.count
    busy = sum(classes.values())
    row = {"phase": 6, "name": "breakdown_f32_square", "shape": [n, n],
           "wall_s": t_wall, "device_busy_s": busy if busy else None,
           "device_busy_share": busy / t_wall if busy else None,
           "device_s_by_class": classes, "launches_by_class": launches_by_class}
    if not busy:
        row["note"] = "torch.profiler recorded no device time: not measured"
    emit(row)


def phase_kernel_profile(seed):
    from dhqr_tpu_torch.ops import hopper_panel as hp

    rng = np.random.default_rng(seed + 7)
    for name, m, nb in (("panel_qr_f32", 129, 128), ("panel_qr_f32", 4224, 128),
                        ("panel_qr_f32", 16384, 128), ("panel_qr_f32", 65536, 64),
                        ("panel_qr_c64", 8192, 128),
                        ("panel_qr_f32", 65536, 128),  # streamed
                        ("panel_qr_f32", 524288, 16)):  # streamed leaf
        dtype = torch.float32 if name.endswith("f32") else torch.complex64
        panel = random_panel(rng, m, nb, dtype)
        grid = hp.kernel_launch_info(m, nb, 0, dtype)
        ms = cuda_ms(lambda: hp._panel_qr_kernel(panel, 0), 10)
        cycles = hp.kernel_section_cycles(panel)
        emit({"phase": 7, "name": "kernel_profile", "kernel": name, "m": m,
              "nb": nb, "ctas": grid["ctas"], "rows_per_cta": grid["rows_per_cta"],
              "resident": grid["resident"],
              "ms": ms, "us_per_column": 1e3 * ms / nb,
              "cycles_per_column": cycles})
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": 7, "name": "sm_clocks", "clocks_sm_now_and_max": clocks})


# -- phase 8: precision -----------------------------------------------------

def magnitude(a, b, c=None):
    """max over entries of |a||b| (+ |c|): the scale a product's rounding
    is measured against."""
    mag = torch.matmul(a.abs(), b.abs())
    if c is not None:
        mag += c.abs()
    return float(mag.max())


def phase_precision_gemms(seed, m=16384, k=128, n=16256):
    """The bf16 passes on the card against their plain versions, at the
    trailing update's shapes: the update product Y Z, the in-place update
    C - Y Z and the product Y^H C."""
    from dhqr_tpu_torch.ops import gemm

    g = torch.Generator(device="cuda").manual_seed(seed + 8)
    for dtype in (torch.float32, torch.complex64):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda", dtype=dtype)

        Y, Z, C = rnd(m, k), rnd(k, n), rnd(m, n)
        Yh = Y.mH
        ops = {  # name: (card, plain, full FP32, scale)
            "Y@Z": (lambda p: gemm.matmul(Y, Z, p),
                    lambda p: gemm.matmul_plain(Y, Z, p),
                    lambda: torch.matmul(Y, Z), magnitude(Y, Z)),
            "C-=Y@Z": (lambda p: gemm.addmm(D, Y, Z, p, inplace=True),
                       lambda p: gemm.addmm_plain(D, Y, Z, p, inplace=True),
                       lambda: D.addmm_(Y, Z, alpha=-1), magnitude(Y, Z, C)),
            "Y^H@C": (lambda p: gemm.matmul(Yh, C, p),
                      lambda p: gemm.matmul_plain(Yh, C, p),
                      lambda: torch.matmul(Yh, C), magnitude(Yh, C)),
        }
        for op, (card, plain, full, scale) in ops.items():
            for prec in ("high", "default"):
                D = C.clone()
                got = card(prec)
                D = C.clone()
                want = plain(prec)
                err = float((got - want).abs().max()) / scale
                row = {"phase": 8, "name": "bf16_gemm", "op": op,
                       "dtype": str(dtype).split(".")[-1], "precision": prec,
                       "shape": [m, k, n], "err_vs_plain": err,
                       "tol": TOL_BF16, "out_dtype": str(got.dtype),
                       "ms": cuda_ms(lambda: card(prec), 5),
                       "plain_ms": cuda_ms(lambda: plain(prec), 2),
                       "highest_ms": cuda_ms(full, 5)}
                row["ok"] = err <= TOL_BF16 and got.dtype == dtype
                emit(row)
                if not row["ok"]:
                    raise AssertionError(f"bf16 pass check failed: {row}")
                del got, want, D
        del Y, Z, C, Yh
        torch.cuda.empty_cache()


def phase_precision_qr(dt, hp, seed, n=16384):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.rand((n, n), generator=g, device="cuda", dtype=torch.float32)
    expect = expected_launches(n, n, torch.float32)
    for trailing in ("highest", "high", "default"):
        l0 = hp.LAUNCHES["panel_qr_f32"]
        fact, t_first = wall(lambda: dt.qr(A, trailing_precision=trailing))
        del fact
        fact, t_factor = wall(lambda: dt.qr(A, trailing_precision=trailing))
        launches = hp.LAUNCHES["panel_qr_f32"] - l0
        R = fact.r_matrix()
        QR = fact.matmul_q(R)
        backward = float(torch.linalg.vector_norm((QR - A).double())
                         / torch.linalg.vector_norm(A.double()))
        del QR, R, fact
        torch.cuda.empty_cache()
        row = {"phase": 8, "name": "qr_trailing_precision", "shape": [n, n],
               "trailing_precision": trailing, "factor_first_s": t_first,
               "factor_s": t_factor,
               "gflops": 4.0 / 3.0 * n ** 3 / t_factor / 1e9,
               "backward_error": backward, "tol_backward": TOL_BACKWARD_F32,
               "meets_tol": backward < TOL_BACKWARD_F32,
               "launches": launches, "expected": 2 * expect}
        row["ok"] = (bool(np.isfinite(backward)) and launches == 2 * expect
                     and (trailing != "highest" or row["meets_tol"]))
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"qr trailing precision failed: {row}")


def phase_precision_lstsq(dt, seed, m=4400, n=4000):
    """Every POLICY_LADDER cell and preset at the reference's largest size,
    on the reference's criterion: the normal-equations residual evaluated
    with numpy in the input's precision (``utils/testing.py``; A^H A and
    A^H b are formed once per dtype, the same operations in the same
    order), as a ratio to numpy's LAPACK QR solution's. The same ratio
    evaluated in float64 on the card is printed beside it (printed only:
    it moves tenfold with summation order, see :func:`phase_factor_quality`),
    and both ratios of two witnesses: ``torch.linalg.lstsq`` on the card (a
    yardstick the port never calls) and the port's own factors with Q^H b
    through an explicit Q. The plain panel loop's ratios are printed by
    :func:`phase_factor_quality`."""
    from dhqr_tpu_torch.precision import POLICY_LADDER, PRECISION_POLICIES

    cells = [(f"highest/{p.resolved_trailing()}/r{p.refine}", p)
             for p in POLICY_LADDER] + list(PRECISION_POLICIES.items())
    for dtype in (np.float32, np.complex64):
        A, b, x_lapack = lapack_problem(m, n, dtype, seed + 3)
        Ah = A.conj().T
        gram, rhs = Ah @ A, Ah @ b
        At, bt = torch.from_numpy(A).cuda(), torch.from_numpy(b).cuda()
        wide = torch.complex128 if At.is_complex() else torch.float64
        A64, b64 = At.to(wide), bt.to(wide)

        def ne(x):  # normal_equations_residual(A, x, b)
            return float(np.linalg.norm(gram @ x - rhs))

        def ne64(x):
            x = torch.as_tensor(x, device="cuda").to(wide)
            return float(torch.linalg.vector_norm(A64.mH @ (A64 @ x - b64)))

        oracle, oracle64 = ne(x_lapack), ne64(x_lapack)
        for name, pol in cells:
            x, t = wall(lambda: dt.lstsq(At, bt, policy=pol))
            finite = bool(torch.isfinite(torch.view_as_real(x) if x.is_complex()
                                         else x).all())
            ratio = ne(x.cpu().numpy()) / oracle
            row = {"phase": 8, "name": "lstsq_policy", "policy": name,
                   "dtype": np.dtype(dtype).name, "shape": [m, n],
                   "lstsq_s": t, "ratio_to_lapack": ratio,
                   "ratio_to_lapack_f64_eval": ne64(x) / oracle64,
                   "criterion": CRITERION, "meets_8x": ratio < CRITERION,
                   "finite": finite}
            row["ok"] = finite and (name != "accurate" or row["meets_8x"])
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"lstsq policy cell failed: {row}")

        def explicit_q():  # the port's factors, Q^H b through Q formed whole
            fact = dt.qr(At)
            c = fact.q_columns().mH @ bt
            return torch.linalg.solve_triangular(
                fact.r_matrix(), c[:, None], upper=True)[:, 0]

        witnesses = {  # second opinions on the f64-evaluated ratio
            "torch_linalg_lstsq": lambda: torch.linalg.lstsq(
                At, bt[:, None]).solution[:, 0],
            "port_qr_explicit_q": explicit_q}  # the plain loop: factor_quality
        for name, fn in witnesses.items():
            x, t = wall(fn)
            emit({"phase": 8, "name": "lstsq_witness", "solver": name,
                  "dtype": np.dtype(dtype).name, "shape": [m, n], "s": t,
                  "ratio_to_lapack": ne(x.cpu().numpy()) / oracle,
                  "ratio_to_lapack_f64_eval": ne64(x) / oracle64})
        del At, bt, A64, b64
        torch.cuda.empty_cache()


def factor_quality(H, alpha, A, nb):
    """(||A - Q R|| / ||A||, ||I - Q^H Q||_F) of packed factors, evaluated
    in float64 (complex128) on the card: Q formed from the stored
    reflectors in double precision, R from H and alpha."""
    from dhqr_tpu_torch.ops import blocked, solve

    wide = torch.complex128 if H.is_complex() else torch.float64
    m, n = H.shape
    eye = torch.eye(m, n, dtype=wide, device=H.device)
    Q = blocked._apply_q_impl(H.to(wide), eye, nb)
    R = solve.r_matrix(H, alpha).to(wide)
    A64 = A.to(wide)
    backward = float(torch.linalg.matrix_norm(A64 - Q @ R)
                     / torch.linalg.matrix_norm(A64))
    orth = float(torch.linalg.matrix_norm(eye[:n] - Q.mH @ Q))
    return backward, orth


def phase_factor_quality(dt, hp, seed, n_seeds=1, m=4400, n=4000):
    """Queue C item 1: are the f32 (and c64) kernel's factors as good as
    the plain panel loop's? For the 4400 x 4000 problems of phase 8, the
    backward error and orthogonality (f64 on the card) and the ratio to
    numpy's LAPACK residual (in the input's precision, and in f64) of
    three sets of factors: the kernel's (the default route), the plain
    panel loop's (``use_pallas="never"``) and the kernel's schedule in
    eager PyTorch (``hopper_panel._panel_qr_grid_leaf`` as the blocked
    engine's leaf, on the card). The kernel must stay within 2x of the
    plain loop on both factor measures. ``n_seeds`` > 1 repeats the kernel
    and the plain loop, f32, for the next problem seeds."""
    from dhqr_tpu_torch.ops import blocked

    nb = blocked.DEFAULT_BLOCK_SIZE
    runs = [(np.float32, seed + 3 + i) for i in range(n_seeds)]
    runs.insert(1, (np.complex64, seed + 3))
    for k, (dtype, pseed) in enumerate(runs):
        A, b, x_lapack = lapack_problem(m, n, dtype, pseed)
        At, bt = torch.from_numpy(A).cuda(), torch.from_numpy(b).cuda()
        wide = torch.complex128 if At.is_complex() else torch.float64
        A64, b64 = At.to(wide), bt.to(wide)
        Ah = A.conj().T
        gram, rhs = Ah @ A, Ah @ b

        def ne64(x):
            x = torch.as_tensor(x, device="cuda").to(wide)
            return float(torch.linalg.vector_norm(A64.mH @ (A64 @ x - b64)))

        def ne(x):
            return float(np.linalg.norm(gram @ x - rhs))

        oracle, oracle64 = ne(x_lapack), ne64(x_lapack)
        sets = {"plain_loop": lambda: dt.qr(At, use_pallas="never"),
                "kernel": lambda: dt.qr(At)}
        if k < 2:  # the grid model on the base seed, f32 and c64
            sets["grid_model"] = lambda: dt.QRFactorization(
                *blocked._blocked_qr_impl(At.clone(), nb, kernel=True,
                                          leaf=hp._panel_qr_grid_leaf),
                block_size=nb)
        quality = {}
        for name, make in sets.items():
            fact, t = wall(make)
            backward, orth = factor_quality(fact.H, fact.alpha, At, nb)
            x = fact.solve(bt)
            quality[name] = (backward, orth)
            row = {"phase": 8, "name": "factor_quality", "factors": name,
                   "dtype": np.dtype(dtype).name, "shape": [m, n],
                   "problem_seed": pseed, "factor_s": t,
                   "backward_error_f64": backward,
                   "orthogonality_f64": orth,
                   "ratio_to_lapack": ne(x.cpu().numpy()) / oracle,
                   "ratio_to_lapack_f64_eval": ne64(x) / oracle64}
            if name != "plain_loop":
                row["vs_plain_loop"] = [backward / quality["plain_loop"][0],
                                        orth / quality["plain_loop"][1]]
            emit(row)
            del fact, x
        kb, ko = quality["kernel"]
        pb, po = quality["plain_loop"]
        ok = kb <= 2 * pb and ko <= 2 * po
        emit({"phase": 8, "name": "factor_quality_verdict",
              "dtype": np.dtype(dtype).name, "problem_seed": pseed,
              "kernel_over_plain_backward": kb / pb,
              "kernel_over_plain_orthogonality": ko / po, "bar": 2.0,
              "ok": ok})
        if not ok:
            raise AssertionError("the kernel's factors are more than 2x "
                                 "worse than the plain panel loop's")
        del At, bt, A64, b64
        torch.cuda.empty_cache()


# -- phase 9: the tall-skinny engines -----------------------------------------

def tsqr_expected_launches(m, n, n_blocks, dtype):
    """Kernel leaves of one TSQR call by the port's own panel plans for its
    leaves and its combine."""
    from dhqr_tpu_torch.ops import blocked, tsqr

    cuda = torch.device("cuda")
    kernel = blocked._resolve_kernel("auto", m // n_blocks, dtype, cuda)
    return sum(count * sum(blocked.kernel_leaves(w, leaf)
                           for _, w, leaf in plan if leaf)
               for plan, count in tsqr.tsqr_panel_plans(
                   m, n, n_blocks, blocked.DEFAULT_BLOCK_SIZE, kernel, dtype,
                   cuda))


def phase_engines(dt, hp, seed, shapes=((65536, 256, torch.float32),
                                        (32768, 256, torch.complex64))):
    for i, (m, n, dtype) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(seed + 9 + i)
        A = torch.rand((m, n), generator=g, device="cuda", dtype=dtype)
        b = torch.rand((m,), generator=g, device="cuda", dtype=dtype)
        kname = hp.KERNELS[dtype]
        wide = torch.complex128 if A.is_complex() else torch.float64
        A64, b64 = A.to(wide), b.to(wide)

        def ne(x):
            return float(torch.linalg.vector_norm(
                A64.mH @ (A64 @ x.to(wide) - b64)))

        ref = lambda: torch.linalg.lstsq(A, b[:, None]).solution[:, 0]  # noqa: E731
        wall(ref)
        x_ref, t_ref = wall(ref)
        res_ref = ne(x_ref)
        tsqr = tsqr_expected_launches(m, n, 8, dtype)
        cases = [("tsqr_lstsq", lambda: dt.tsqr_lstsq(A, b, n_blocks=8), tsqr),
                 ("lstsq_engine_tsqr", lambda: dt.lstsq(A, b, engine="tsqr"),
                  tsqr)]
        if dtype == torch.float32:
            cases += [
                ("cholesky_qr_lstsq", lambda: dt.cholesky_qr_lstsq(A, b), 0),
                ("cholesky_qr_lstsq_shift",
                 lambda: dt.cholesky_qr_lstsq(A, b, shift=True), 0),
                ("lstsq_engine_cholqr2",
                 lambda: dt.lstsq(A, b, engine="cholqr2"), 0),
                ("lstsq_engine_cholqr3",
                 lambda: dt.lstsq(A, b, engine="cholqr3"), 0)]
        for name, fn, expect in cases:
            l0 = hp.LAUNCHES[kname]
            x, t_first = wall(fn)
            launches = hp.LAUNCHES[kname] - l0
            x, t = wall(fn)
            res = ne(x)
            row = {"phase": 9, "name": name, "dtype": str(dtype).split(".")[-1],
                   "shape": [m, n], "first_s": t_first, "s": t,
                   "torch_lstsq_s": t_ref, "normal_eq_residual": res,
                   "torch_lstsq_residual": res_ref, "ratio": res / res_ref,
                   "criterion": CRITERION, "launches": launches,
                   "expected": expect}
            row["ok"] = (bool(np.isfinite(res)) and res <= CRITERION * res_ref
                         and launches == expect)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"engine check failed: {row}")
        l0 = hp.LAUNCHES[kname]
        R, t_first = wall(lambda: dt.tsqr_r(A, n_blocks=8))
        launches = hp.LAUNCHES[kname] - l0
        R, t = wall(lambda: dt.tsqr_r(A, n_blocks=8))
        G = A64.mH @ A64
        R64 = R.to(wide)
        gram = float(torch.linalg.matrix_norm(R64.mH @ R64 - G)
                     / torch.linalg.matrix_norm(G))
        row = {"phase": 9, "name": "tsqr_r", "dtype": str(dtype).split(".")[-1],
               "shape": [m, n], "first_s": t_first, "s": t,
               "gram_rel_err": gram, "tol_gram": TOL_GRAM,
               "launches": launches, "expected": tsqr}
        row["ok"] = gram <= TOL_GRAM and launches == tsqr
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"tsqr_r check failed: {row}")
        del A, b, A64, b64, G, R, R64
        torch.cuda.empty_cache()


# -- phase 10: gradients ------------------------------------------------------

def phase_gradients(dt, hp, seed, shapes=((4096, 512, torch.float32),
                                          (2048, 256, torch.complex64))):
    for i, (m, n, dtype) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(seed + 10 + i)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda", dtype=dtype)

        A, b, w, dA, db = rnd(m, n), rnd(m), rnd(n), rnd(m, n), rnd(m)
        kname = hp.KERNELS[dtype]
        expect = expected_launches(m, n, dtype)

        def grads(A, b, solve):
            At = A.detach().clone().requires_grad_()
            bt = b.detach().clone().requires_grad_()
            x = solve(At, bt)
            torch.real(torch.vdot(w.to(x.dtype), x)).backward()
            return x, At.grad, bt.grad

        l0 = hp.LAUNCHES[kname]
        x, gA, gb = grads(A, b, dt.lstsq_diff)
        launches = hp.LAUNCHES[kname] - l0
        wide = torch.complex128 if A.is_complex() else torch.float64

        def normal_equations(A, b):  # the yardstick, float64 autograd
            return torch.linalg.solve(A.mH @ A, A.mH @ b)

        _, gA64, gb64 = grads(A.to(wide), b.to(wide), normal_equations)
        err = max(rel_err(gA.to(wide), gA64), rel_err(gb.to(wide), gb64))
        _, Ju = torch.func.jvp(dt.lstsq_diff, (A, b), (dA, db))
        lhs = float(torch.real(torch.vdot(w, Ju)))
        rhs = float(torch.real(torch.vdot(gA.flatten(), dA.flatten())
                               + torch.vdot(gb, db)))
        adjoint = abs(lhs - rhs) / abs(lhs)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: dt.lstsq_diff(A, b), 3)
        fwd_bwd_ms = cuda_ms(lambda: grads(A, b, dt.lstsq_diff), 3)
        row = {"phase": 10, "name": "lstsq_diff_gradient",
               "dtype": str(dtype).split(".")[-1], "shape": [m, n],
               "grad_rel_err_vs_f64": err, "tol_grad": TOL_GRAD,
               "adjoint_rel_err": adjoint, "tol_adjoint": TOL_ADJOINT,
               "forward_ms": fwd_ms, "forward_backward_ms": fwd_bwd_ms,
               "backward_over_forward": fwd_bwd_ms / fwd_ms - 1.0,
               "launches_forward": launches, "expected": expect}
        row["ok"] = (err <= TOL_GRAD and adjoint <= TOL_ADJOINT
                     and launches == expect)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"gradient check failed: {row}")


# -- phase 11: the lookahead and aggregated schedules -------------------------

SCHEDULES = (("lookahead", {"lookahead": True}), ("agg2", {"agg_panels": 2}),
             ("agg4", {"agg_panels": 4}))
LOOKAHEAD_CAPS = (16, 33, 66, 132)


def schedule_launches(m, n, dtype, lookahead_ctas=None):
    """Kernel leaves of one factorization by the engine's own plan (the
    lookahead schedule's side-stream panels planned on ``lookahead_ctas``
    SMs)."""
    from dhqr_tpu_torch.ops import blocked

    cuda = torch.device("cuda")
    kernel = blocked._resolve_kernel("auto", m, dtype, cuda)
    plan = blocked.panel_plan(m, n, blocked.DEFAULT_BLOCK_SIZE, kernel, dtype,
                              cuda, lookahead_ctas)
    return sum(blocked.kernel_leaves(w, leaf) for _, w, leaf in plan if leaf)


def backward_error(fact, A):
    """||Q R - A|| / ||A|| with Q R formed by the factorization's own apply."""
    m, n = A.shape
    R = torch.cat([fact.r_matrix(), A.new_zeros((m - n, n))])
    QR = fact.matmul_q(R)
    wide = torch.complex128 if A.is_complex() else torch.float64
    return float(torch.linalg.vector_norm((QR - A).to(wide))
                 / torch.linalg.vector_norm(A.to(wide)))


def overlap_profile(fn):
    """(wall s, panel-kernel device s, GEMM device s, s where a panel kernel
    and a GEMM ran at once, device busy s) of one call of ``fn`` under
    ``torch.profiler``; None for the device figures when the profiler
    recorded no kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t_wall = wall(fn)
    spans = {"panel": [], "gemm": [], "all": []}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        iv = (evt.time_range.start, evt.time_range.end)
        name = evt.name.lower()
        spans["all"].append(iv)
        if "panel_qr" in name:
            spans["panel"].append(iv)
        elif "gemm" in name:
            spans["gemm"].append(iv)

    def union(ivs):
        out = []
        for lo, hi in sorted(ivs):
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return out

    def length(ivs):
        return sum(hi - lo for lo, hi in ivs) / 1e6  # us -> s

    if not spans["all"]:
        return t_wall, None, None, None, None
    gemm = union(spans["gemm"])
    both = [(max(lo, g0), min(hi, g1)) for lo, hi in union(spans["panel"])
            for g0, g1 in gemm if min(hi, g1) > max(lo, g0)]
    return (t_wall, length(union(spans["panel"])), length(gemm),
            length(both), length(union(spans["all"])))


def phase_schedules(dt, hp, seed, cases=((16384, 16384, torch.float32),
                                         (8192, 4096, torch.complex64))):
    """``qr`` in each schedule against the default: steady seconds,
    GFLOP/s, backward error, distance of the factors from the default's,
    launches against the plan; for lookahead the CTA cap sweep and the
    profiler's overlap; then ``lstsq`` at 4400 x 4000 in each schedule on
    the reference's criterion."""
    from dhqr_tpu_torch.ops import blocked
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    for i, (m, n, dtype) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(seed + 11 + i)
        A = torch.rand((m, n), generator=g, device="cuda", dtype=dtype)
        kname = hp.KERNELS[dtype]
        tol = TOL_BACKWARD_F32 if dtype == torch.float32 else TOL_BACKWARD_C64
        real_flops = (1 if dtype == torch.float32 else 4) * (
            2 * m * n * n - 2.0 / 3.0 * n ** 3)
        dt.qr(A)
        ref, t_ref = wall(lambda: dt.qr(A))
        emit({"phase": 11, "name": "schedule", "schedule": "default",
              "dtype": str(dtype).split(".")[-1], "shape": [m, n],
              "factor_s": t_ref, "gflops": real_flops / t_ref / 1e9,
              "backward_error": backward_error(ref, A)})
        for sched, kw in SCHEDULES:
            expect = schedule_launches(
                m, n, dtype, hp.LOOKAHEAD_CTAS if "lookahead" in kw else None)
            l0 = hp.LAUNCHES[kname]
            fact, t_first = wall(lambda: dt.qr(A, **kw))
            launches = hp.LAUNCHES[kname] - l0
            del fact
            fact, t = wall(lambda: dt.qr(A, **kw))
            row = {"phase": 11, "name": "schedule", "schedule": sched,
                   "dtype": str(dtype).split(".")[-1], "shape": [m, n],
                   "factor_first_s": t_first, "factor_s": t,
                   "default_s": t_ref, "gflops": real_flops / t / 1e9,
                   "backward_error": backward_error(fact, A), "tol": tol,
                   "rel_diff_H": rel_err(fact.H, ref.H),
                   "rel_diff_alpha": rel_err(fact.alpha, ref.alpha),
                   "launches": launches, "expected": expect}
            row["ok"] = (row["backward_error"] < tol and launches == expect
                         and expect >= 1 and row["rel_diff_H"] < 1e-3)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"schedule check failed: {row}")
            del fact
        for cap in LOOKAHEAD_CAPS:  # the side-stream grid's CTA cap
            run = lambda: blocked._blocked_qr_impl(  # noqa: E731
                A.clone(), blocked.DEFAULT_BLOCK_SIZE, kernel=True,
                lookahead=True, lookahead_ctas=cap)
            run()
            l0 = hp.LAUNCHES[kname]
            _, t = wall(run)
            launches = hp.LAUNCHES[kname] - l0
            t_wall, panel_s, gemm_s, both_s, busy_s = overlap_profile(run)
            row = {"phase": 11, "name": "lookahead_cap", "ctas": cap,
                   "dtype": str(dtype).split(".")[-1], "shape": [m, n],
                   "factor_s": t, "default_s": t_ref,
                   "profiled_wall_s": t_wall, "panel_device_s": panel_s,
                   "gemm_device_s": gemm_s, "overlap_device_s": both_s,
                   "device_busy_s": busy_s,
                   "launches": launches,
                   "expected": schedule_launches(m, n, dtype, cap)}
            if panel_s is None:
                row["note"] = "torch.profiler recorded no kernels: not measured"
            row["ok"] = launches == row["expected"]
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"lookahead cap check failed: {row}")
        t_wall, panel_s, gemm_s, both_s, busy_s = overlap_profile(
            lambda: dt.qr(A))
        emit({"phase": 11, "name": "default_profile",
              "dtype": str(dtype).split(".")[-1], "shape": [m, n],
              "profiled_wall_s": t_wall, "panel_device_s": panel_s,
              "gemm_device_s": gemm_s, "overlap_device_s": both_s,
              "device_busy_s": busy_s})
        del A, ref
        torch.cuda.empty_cache()
    for dtype, name in ((np.float32, "panel_qr_f32"),
                        (np.complex64, "panel_qr_c64")):
        A, b, oracle = oracle_of(4400, 4000, dtype, seed + 3)
        for sched, kw in SCHEDULES:
            l0 = hp.LAUNCHES[name]
            x, t = wall(lambda: dt.lstsq(A, b, **kw))
            res = normal_equations_residual(A, x.cpu().numpy(), b)
            row = {"phase": 11, "name": "schedule_criterion",
                   "schedule": sched, "dtype": np.dtype(dtype).name,
                   "shape": [4400, 4000], "lstsq_s": t,
                   "ratio": res / oracle, "criterion": CRITERION,
                   "launches": hp.LAUNCHES[name] - l0}
            row["ok"] = bool(np.isfinite(res)) and res < CRITERION * oracle \
                and row["launches"] >= 1
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"schedule criterion failed: {row}")


# -- phase 12: the reconstruct panel engine -----------------------------------

TOL_BACKWARD_F64 = 1e-12


def phase_reconstruct(dt, hp, seed, m=16384, n=2048):
    """``qr`` + ``solve`` with ``panel_impl="reconstruct"`` and
    ``"reconstruct:4096"``, f32 on the plain panel path and f64, beside the
    ``"loop"`` engine; then ``lstsq`` at 4400 x 4000 on the reference's
    criterion. No panel kernel runs here."""
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    for i, dtype in enumerate((torch.float32, torch.float64)):
        g = torch.Generator(device="cuda").manual_seed(seed + 12 + i)
        A = torch.rand((m, n), generator=g, device="cuda", dtype=dtype)
        b = torch.rand((m,), generator=g, device="cuda", dtype=dtype)
        tol = TOL_BACKWARD_F32 if dtype == torch.float32 else TOL_BACKWARD_F64
        kw = {"use_pallas": "never"} if dtype == torch.float32 else {}
        _, t_loop = wall(lambda: dt.qr(A, **kw))
        for impl in ("reconstruct", "reconstruct:4096"):
            dt.qr(A, panel_impl=impl, **kw)
            fact, t = wall(lambda: dt.qr(A, panel_impl=impl, **kw))
            x, t_solve = wall(lambda: fact.solve(b))
            row = {"phase": 12, "name": "reconstruct", "panel_impl": impl,
                   "dtype": str(dtype).split(".")[-1], "shape": [m, n],
                   "factor_s": t, "solve_s": t_solve, "loop_factor_s": t_loop,
                   "backward_error": backward_error(fact, A), "tol": tol,
                   "finite": bool(torch.isfinite(x).all())}
            row["ok"] = row["backward_error"] < tol and row["finite"]
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"reconstruct check failed: {row}")
            del fact, x
        del A, b
        torch.cuda.empty_cache()
    for dtype in (np.float32, np.float64):
        A, b, oracle = oracle_of(4400, 4000, dtype, seed + 3)
        kw = {"use_pallas": "never"} if dtype == np.float32 else {}
        for impl in ("reconstruct", "reconstruct:4096"):
            x, t = wall(lambda: dt.lstsq(A, b, panel_impl=impl, **kw))
            res = normal_equations_residual(A, x.cpu().numpy(), b)
            row = {"phase": 12, "name": "reconstruct_criterion",
                   "panel_impl": impl, "dtype": np.dtype(dtype).name,
                   "shape": [4400, 4000], "lstsq_s": t,
                   "ratio": res / oracle, "criterion": CRITERION}
            row["ok"] = bool(np.isfinite(res)) and res < CRITERION * oracle
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"reconstruct criterion failed: {row}")


# -- phase 13: the sketched solver --------------------------------------------

def phase_sketch(dt, seed, cases=((65536, 256, torch.float32),
                                  (131072, 256, torch.float32),
                                  (32768, 256, torch.complex64))):
    """``lstsq(engine="sketch")`` (the operator by "auto": SRHT at these
    power-of-two heights) and, at 65536 x 256, ``sketched_lstsq`` with the
    count sketch, against ``torch.linalg.lstsq`` (yardstick) on the
    normal-equations residual, timed beside it and ``engine="cholqr2"``;
    each new (operator, m, s, seed) draws its operator once."""
    from dhqr_tpu_torch.solvers import sketch

    for i, (m, n, dtype) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(seed + 13 + i)
        A = torch.rand((m, n), generator=g, device="cuda", dtype=dtype)
        b = torch.rand((m,), generator=g, device="cuda", dtype=dtype)
        wide = torch.complex128 if A.is_complex() else torch.float64
        A64, b64 = A.to(wide), b.to(wide)

        def ne(x):
            return float(torch.linalg.vector_norm(
                A64.mH @ (A64 @ x.to(wide) - b64)))

        ref = lambda: torch.linalg.lstsq(A, b[:, None]).solution[:, 0]  # noqa: E731
        wall(ref)
        x_ref, t_ref = wall(ref)
        res_ref = ne(x_ref)
        dt.lstsq(A, b, engine="cholqr2")
        _, t_chol = wall(lambda: dt.lstsq(A, b, engine="cholqr2"))
        calls = [("lstsq_engine_sketch", "auto",
                  lambda: dt.lstsq(A, b, engine="sketch"))]
        if i == 0:
            calls.append(("sketched_lstsq", "countsketch",
                          lambda: dt.sketched_lstsq(A, b,
                                                    operator="countsketch")))
        for name, op, fn in calls:
            d0 = sketch.COUNTERS.get("sketch_operator_draws")
            x, t_first = wall(fn)
            d1 = sketch.COUNTERS.get("sketch_operator_draws")
            x, t = wall(fn)
            d2 = sketch.COUNTERS.get("sketch_operator_draws")
            res = ne(x)
            row = {"phase": 13, "name": name, "operator":
                   sketch.resolve_operator(op, m),
                   "dtype": str(dtype).split(".")[-1], "shape": [m, n],
                   "s": t, "first_s": t_first, "torch_lstsq_s": t_ref,
                   "cholqr2_s": t_chol, "normal_eq_residual": res,
                   "torch_lstsq_residual": res_ref, "ratio": res / res_ref,
                   "criterion": CRITERION, "operator_draws_first": d1 - d0,
                   "operator_draws_second": d2 - d1}
            row["ok"] = (bool(np.isfinite(res)) and res <= CRITERION * res_ref
                         and d1 - d0 <= 1 and d2 == d1)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"sketch check failed: {row}")
        del A, b, A64, b64
        torch.cuda.empty_cache()


# -- phase 14: the sharded tier ------------------------------------------------
#
# Each case runs in P spawned processes (dhqr_tpu_torch/parallel/_ranks.py)
# that share card 0: NCCL with one rank runs the NCCL code path end to end;
# gloo with 2 and 4 ranks runs real multi-rank collectives, carried through
# the host. Times are P processes time-sharing one H100, never a scaling
# number. The rank worker below runs in those processes.

SHARDED_SCHEDULES = (("block", "default", {}),
                     ("cyclic", "default", {}),
                     ("block", "lookahead", {"lookahead": True}),
                     ("cyclic", "lookahead", {"lookahead": True}),
                     ("block", "agg2", {"agg_panels": 2}),
                     ("cyclic", "agg2", {"agg_panels": 2}))
TOL_SHARDED_H = 1e-5   # max|H - H_single| / max|H_single| (one rank, the
# default), and max||R| - |R_single|| / max|R_single|, R up to row signs


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _solve_profile(fn, device):
    """One call of ``fn`` under ``torch.profiler`` (host and card): wall
    seconds, the card's busy seconds and idle share, kernels launched,
    and the ops that took the most device and host time."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, t = _timed(fn, device)
    events = prof.key_averages()
    # kernels only: an op on the host also carries its kernels' time
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    ops = [e for e in events if e.device_type.name == "CPU"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6

    def top(events, key):
        rows = sorted(events, key=lambda e: -getattr(e, key))[:6]
        return [[e.key[:60], getattr(e, key) / 1e6, e.count] for e in rows]

    return {"wall_s": t, "device_busy_s": busy if busy else None,
            "device_idle_share": 1 - busy / t if busy else None,
            "kernels": sum(e.count for e in kernels),
            "top_device_s": top(kernels, "self_device_time_total"),
            "top_host_s": top(ops, "self_cpu_time_total")}


def _rank_qr_case(dt, parallel, hp, device, seed, m, n, dtype, runs,
                  steady=True, probe=False, profile=False):
    """``qr`` + ``solve`` on this rank's column mesh, per (layout, schedule):
    seconds, launches, this rank's part of the backward error and of the
    distance from the single-device factors. ``probe`` also sets the
    single-device ``lookahead=True`` factors beside the default's (pivot
    sign flips, H distance) as the first row; ``profile`` traces the
    single-device solve and the first run's mesh solve. The kernel counts
    are zeroed after the single-device references: what the worker reads
    after the case is the mesh path's alone."""
    from dhqr_tpu_torch.ops import blocked
    from dhqr_tpu_torch.parallel import sharded_qr

    dtype = getattr(torch, dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype.is_complex:
        real = torch.float32
        A = torch.complex(torch.rand((m, n), generator=g, device=device,
                                     dtype=real),
                          torch.rand((m, n), generator=g, device=device,
                                     dtype=real))
        b = torch.complex(torch.rand((m,), generator=g, device=device,
                                     dtype=real),
                          torch.rand((m,), generator=g, device=device,
                                     dtype=real))
    else:
        A = torch.rand((m, n), generator=g, device=device, dtype=dtype)
        b = torch.rand((m,), generator=g, device=device, dtype=dtype)
    mesh = parallel.column_mesh(device=device)
    single = dt.qr(A, device=device)
    H_single, alpha_single = single.H, single.alpha
    wide = torch.complex128 if A.is_complex() else torch.float64
    A64, b64 = A.to(wide), b.to(wide)

    def ne(x):  # the normal-equations residual, in double
        return float(torch.linalg.vector_norm(
            A64.mH @ (A64 @ x.to(wide) - b64)))

    ne_single = ne(single.solve(b))
    single_profile = _solve_profile(lambda: single.solve(b), device) \
        if profile else None
    del single
    unit = lambda a: a / a.abs().clamp_min(1e-30)  # noqa: E731
    rows = []
    if probe:
        la = dt.qr(A, device=device, lookahead=True)
        rows.append({"single_lookahead_flips": int(
            ((unit(la.alpha) - unit(alpha_single)).abs() > 1e-3).sum()),
            "single_lookahead_h_diff": float(
                (la.H - H_single).abs().max() / H_single.abs().max())})
        del la
    hp.reset_launches()  # the mesh path starts here
    for i, (layout, sched, kw) in enumerate(runs):
        l0 = dict(hp.LAUNCHES)
        fact, t_first = _timed(lambda: dt.qr(A, mesh=mesh, layout=layout,
                                             **kw), device)
        launches = {k: hp.LAUNCHES[k] - l0[k] for k in l0}
        t = None
        if steady:
            del fact
            fact, t = _timed(lambda: dt.qr(A, mesh=mesh, layout=layout,
                                           **kw), device)
        x, t_solve = _timed(lambda: fact.solve(b), device)
        profiles = {"single_solve_profile": single_profile,
                    "mesh_solve_profile": _solve_profile(
                        lambda: fact.solve(b), device)} \
            if profile and i == 0 else {}
        nb = fact.block_size
        mine = sharded_qr._local_block(H_single, mesh, n, nb, layout)
        Hn = fact.natural_H()
        gidx = torch.as_tensor(sharded_qr._local_gidx(
            mesh.rank, n, n // mesh.size, nb, layout), device=device)
        upper = torch.arange(m, device=device)[:, None] < gidx
        R_mine = torch.where(upper, mine, 0).abs()
        Rp = torch.where(torch.arange(n, device=device)[:, None] < gidx,
                         Hn[:n].index_select(1, gidx), 0)
        Rp[gidx, torch.arange(gidx.numel(), device=device)] = \
            fact.alpha[gidx]
        QRp = blocked._apply_q_impl(Hn, torch.cat([Rp, Rp.new_zeros(
            (m - n, Rp.shape[1]))]), nb, fact.precision)
        Ap = A.index_select(1, gidx)
        # The first column whose pivot took the other sign, and on its
        # owner |a_jj| / ||x_j|| = |v_jj|^2 - 1 of both factorizations
        # (v the stored reflector, ||v||^2 = 2): near zero for a near-tie.
        flipped = ((unit(fact.alpha) - unit(alpha_single)).abs() > 1e-3)
        first = int(flipped.nonzero()[0]) if bool(flipped.any()) else None
        pivot = None
        if first is not None and first in gidx.tolist():
            jl = gidx.tolist().index(first)
            pivot = [float(fact.H[first, jl].abs() ** 2 - 1),
                     float(mine[first, jl].abs() ** 2 - 1)]
        rows.append({
            "layout": layout, "schedule": sched, "nb": nb,
            "first_s": t_first, "s": t, "solve_s": t_solve,
            "launches": launches,
            "backward_sq": float(torch.linalg.vector_norm(
                (QRp - Ap).to(wide)) ** 2),
            "a_sq": float(torch.linalg.vector_norm(Ap.to(wide)) ** 2),
            "h_diff": float((fact.H - mine).abs().max()),
            "h_max": float(mine.abs().max()),
            "r_diff": max(float((torch.where(upper, fact.H, 0).abs()
                                 - R_mine).abs().max()),
                          float((fact.alpha.abs() - alpha_single.abs())
                                .abs().max())),
            "r_max": max(float(R_mine.max()),
                         float(alpha_single.abs().max())),
            "sign_flips": int(flipped.sum()), "first_flip": first,
            "first_flip_pivot": pivot,
            "solve_residual": ne(x), "single_residual": ne_single,
            "finite": bool(torch.isfinite(torch.view_as_real(x)).all()
                           if x.is_complex() else torch.isfinite(x).all()),
            **profiles})
        del fact, x, Hn, Rp, QRp, Ap, mine, R_mine, upper
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def _rank_lstsq_case(dt, parallel, hp, device, seed, m, n, dtype, cols):
    """``lstsq(mesh=)`` of the reference's problem (numpy, from the seed),
    on its first ``cols`` columns; x comes back for the parent's LAPACK
    oracle."""
    A, b = random_problem(m, n, np.dtype(dtype), seed)
    A = np.ascontiguousarray(A[:, :cols])
    mesh = parallel.column_mesh(device=device)
    l0 = dict(hp.LAUNCHES)
    x, t = _timed(lambda: dt.lstsq(A, b, mesh=mesh), device)
    return [{"s": t, "x": x.cpu().numpy(),
             "launches": {k: hp.LAUNCHES[k] - l0[k] for k in l0}}]


def _rank_rows_case(dt, parallel, hp, device, seed, m, n, dtype, engines):
    """``lstsq(engine=..., mesh=row mesh)``; rank 0 also times
    ``torch.linalg.lstsq`` (yardstick) and both normal-equations
    residuals, in double."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.rand((m, n), generator=g, device=device, dtype=dtype)
    b = torch.rand((m,), generator=g, device=device, dtype=dtype)
    mesh = parallel.row_mesh(device=device)
    A64, b64 = A.double(), b.double()

    def ne(x):
        return float(torch.linalg.vector_norm(
            A64.T @ (A64 @ x.double() - b64)))

    rows = []
    for engine in engines:
        l0 = dict(hp.LAUNCHES)
        x, t_first = _timed(lambda: dt.lstsq(A, b, mesh=mesh, engine=engine),
                            device)
        launches = {k: hp.LAUNCHES[k] - l0[k] for k in l0}
        x, t = _timed(lambda: dt.lstsq(A, b, mesh=mesh, engine=engine),
                      device)
        rows.append({"engine": engine, "first_s": t_first, "s": t,
                     "launches": launches, "residual": ne(x)})
    if mesh.rank == 0:
        x_ref, t_ref = _timed(
            lambda: torch.linalg.lstsq(A, b[:, None]).solution[:, 0], device)
        for row in rows:
            row["torch_lstsq_residual"] = ne(x_ref)
            row["torch_lstsq_s"] = t_ref
    return rows


_RANK_CASES = {"qr": _rank_qr_case, "lstsq": _rank_lstsq_case,
               "rows": _rank_rows_case}


def sharded_worker(device, cases):
    """One rank of phase 14 (run by ``run_ranks``): each case on this
    rank's mesh; returns {"cases": per-case rows, "launches": this rank's
    kernel launches on the mesh path}. The counts are zeroed before each
    case (and by a case after its single-device references) and summed
    after it."""
    import dhqr_tpu_torch as dt
    from dhqr_tpu_torch import parallel
    from dhqr_tpu_torch.ops import hopper_panel as hp

    out = []
    launches = dict.fromkeys(hp.KERNELS.values(), 0)
    for case in cases:
        case = dict(case)
        hp.reset_launches()
        out.append(_RANK_CASES[case.pop("kind")](dt, parallel, hp, device,
                                                 **case))
        for name, count in hp.LAUNCHES.items():
            launches[name] += count
    return {"cases": out, "launches": launches}


def sharded_plan(m, n, dtype, P, nb=None):
    """Kernel launches of one single-device factorization of the (padded)
    (m, n) matrix by the mesh engine's panel width (``plan_padding``)."""
    from dhqr_tpu_torch.ops import blocked
    from dhqr_tpu_torch.parallel.layout import plan_padding

    nb, n_pad = plan_padding(n, P, nb or blocked.DEFAULT_BLOCK_SIZE)
    cuda = torch.device("cuda")
    m_pad = m + n_pad - n
    plan = blocked.panel_plan(m_pad, n_pad, nb, True, dtype, cuda)
    return sum(blocked.kernel_leaves(w, leaf) for _, w, leaf in plan if leaf)


def _mps_running() -> bool:
    import glob

    for path in glob.glob("/proc/[0-9]*/comm"):
        try:
            with open(path) as f:
                if f.read().startswith("nvidia-cuda-mps"):
                    return True
        except OSError:
            continue
    return False


def phase_sharded(hp, seed):
    """The sharded tier on one card: (a) NCCL with one rank, ``qr`` +
    ``solve`` at 16384^2 f32; (b) gloo, 4 ranks on card 0, ``qr`` +
    ``solve`` at 16384^2 f32 per layout and schedule, (d) ``lstsq`` at the
    reference's 4400 x 4000 (and 4400 x 3998, padded) f32 and c64 under
    8x, (e) TSQR and CholeskyQR2 on the row mesh at 65536 x 256 f32; (c)
    gloo, 2 ranks, c64 ``qr`` + ``solve`` at 8192 x 4096. Launches of every
    rank are added into the parent's counts."""
    from dhqr_tpu_torch.parallel._ranks import run_ranks
    from dhqr_tpu_torch.utils.testing import lapack_lstsq, \
        normal_equations_residual

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    mps = _mps_running()
    emit({"phase": 14, "name": "sharded_setup", "compute_mode": mode,
          "mps_running": mps, "card": torch.cuda.get_device_name(0)})
    if mps or mode != "Default":
        raise AssertionError(f"phase 14 shares card 0 between processes "
                             f"and needs compute mode Default without MPS: "
                             f"{mode}, MPS running: {mps}")
    torch.cuda.empty_cache()
    device = "cuda:0"
    f32, c64 = "float32", "complex64"
    square = {"kind": "qr", "m": 16384, "n": 16384, "dtype": f32,
              "seed": seed + 14}
    reference = {"kind": "lstsq", "m": 4400, "n": 4000, "seed": seed + 3}
    runs = [
        ("a", "nccl", 1, [dict(square, probe=True, profile=True,
                               runs=[("block", "default", {}),
                                     ("block", "lookahead",
                                      {"lookahead": True})])]),
        ("c", "gloo", 2, [{"kind": "qr", "m": 8192, "n": 4096, "dtype": c64,
                           "seed": seed + 15,
                           "runs": [("cyclic", "default", {})]}]),
        ("bde", "gloo", 4, [
            dict(square, runs=list(SHARDED_SCHEDULES)),
            dict(reference, dtype=f32, cols=4000),
            dict(reference, dtype=f32, cols=3998),
            dict(reference, dtype=c64, cols=4000),
            {"kind": "rows", "m": 65536, "n": 256, "dtype": f32,
             "seed": seed + 16, "engines": ["tsqr", "cholqr2"]}]),
    ]
    for label, backend, P, cases in runs:
        t0 = time.perf_counter()
        ranks = run_ranks(sharded_worker, P, backend=backend, device=device,
                          timeout_s=420, cases=cases)
        wall_s = time.perf_counter() - t0
        for r in ranks:
            for name, count in r["launches"].items():
                hp.LAUNCHES[name] += count
        where = {"backend": backend, "ranks": P, "ranks_per_card": P,
                 "rank_device": device}
        for i, case in enumerate(cases):
            per_rank = [r["cases"][i] for r in ranks]
            if case["kind"] == "qr":
                _check_sharded_qr(case, per_rank, P, where)
            elif case["kind"] == "lstsq":
                dtype = np.dtype(case["dtype"])
                A, b, _ = lapack_problem(case["m"], case["n"], dtype,
                                         case["seed"])
                A = A[:, :case["cols"]]
                oracle = normal_equations_residual(
                    A, lapack_lstsq(A, b), b) if case["cols"] != case["n"] \
                    else oracle_of(case["m"], case["n"], dtype,
                                   case["seed"])[2]
                row0 = per_rank[0][0]
                res = normal_equations_residual(A, row0["x"], b)
                launches = sum(sum(r[0]["launches"].values())
                               for r in per_rank)
                expect = sharded_plan(case["m"], case["cols"],
                                      getattr(torch, case["dtype"]), P)
                row = {"phase": 14, "name": "sharded_lstsq", **where,
                       "dtype": dtype.name, "shape": [case["m"], case["cols"]],
                       "s": max(r[0]["s"] for r in per_rank),
                       "normal_eq_residual": res, "lapack_residual": oracle,
                       "ratio": res / oracle, "criterion": CRITERION,
                       "launches": launches, "expected": expect}
                row["ok"] = bool(np.isfinite(res)) and \
                    res < CRITERION * oracle and launches == expect
                emit(row)
                if not row["ok"]:
                    raise AssertionError(f"sharded lstsq failed: {row}")
            else:
                _check_sharded_rows(case, per_rank, P, where)
        emit({"phase": 14, "name": "sharded_run", "case": label, **where,
              "wall_s": wall_s})


def _check_sharded_qr(case, per_rank, P, where):
    from dhqr_tpu_torch.ops import hopper_panel as hp_

    m, n = case["m"], case["n"]
    dtype = getattr(torch, case["dtype"])
    tol = TOL_BACKWARD_F32 if dtype == torch.float32 else TOL_BACKWARD_C64
    plan = sharded_plan(m, n, dtype, P)
    if case.get("probe"):  # the single-device lookahead beside the default
        emit({"phase": 14, "name": "single_device_lookahead_probe",
              "shape": [m, n], **per_rank[0][0]})
        per_rank = [r[1:] for r in per_rank]
    for j, (layout, sched, kw) in enumerate(case["runs"]):
        rows = [r[j] for r in per_rank]
        backward = (sum(r["backward_sq"] for r in rows)
                    / sum(r["a_sq"] for r in rows)) ** 0.5
        launches = sum(r["launches"][hp_.KERNELS[dtype]] for r in rows)
        expect = plan * (P if "agg_panels" in kw else 1)
        row = {"phase": 14, "name": "sharded_qr", **where,
               "dtype": case["dtype"], "shape": [m, n], "layout": layout,
               "schedule": sched, "nb": rows[0]["nb"],
               "factor_first_s": max(r["first_s"] for r in rows),
               "factor_s": max(r["s"] for r in rows)
               if rows[0]["s"] is not None else None,
               "solve_s": max(r["solve_s"] for r in rows),
               "backward_error": backward, "tol_backward": tol,
               "rel_diff_H_single": max(r["h_diff"] for r in rows)
               / max(r["h_max"] for r in rows),
               "rel_diff_R_up_to_signs": max(r["r_diff"] for r in rows)
               / max(r["r_max"] for r in rows),
               "alpha_sign_flips": rows[0]["sign_flips"],
               "first_flip_column": rows[0]["first_flip"],
               "first_flip_pivot_over_norm": next(
                   (r["first_flip_pivot"] for r in rows
                    if r["first_flip_pivot"] is not None), None),
               "tol_diff": TOL_SHARDED_H,
               "solve_normal_eq_residual": rows[0]["solve_residual"],
               "single_device_residual": rows[0]["single_residual"],
               "solve_ratio": rows[0]["solve_residual"]
               / rows[0]["single_residual"], "criterion": CRITERION,
               "launches": launches, "expected": expect}
        # The default schedule on one rank runs the single-device engine's
        # panels and GEMMs in order: its H must match. Other schedules and
        # several ranks split the GEMMs otherwise, and at 16384^2 a pivot
        # within roundoff of zero can take the other sign (then that
        # reflector and everything after it differ, H by percents): those
        # are held to R, unique up to row signs, and to the backward error.
        dist = row["rel_diff_H_single"] if (P, sched) == (1, "default") \
            else row["rel_diff_R_up_to_signs"]
        row["ok"] = (backward < tol and all(r["finite"] for r in rows)
                     and dist < TOL_SHARDED_H
                     and row["solve_ratio"] <= CRITERION
                     and expect >= 1 and launches == expect)
        emit(row)
        if "mesh_solve_profile" in rows[0]:
            emit({"phase": 14, "name": "sharded_solve_profile", **where,
                  "shape": [m, n], "layout": layout, "schedule": sched,
                  **{k: rows[0][k] for k in ("single_solve_profile",
                                             "mesh_solve_profile")}})
        if not row["ok"]:
            raise AssertionError(f"sharded qr failed: {row}")


def _check_sharded_rows(case, per_rank, P, where):
    from dhqr_tpu_torch.ops import blocked, hopper_panel as hp_

    m, n = case["m"], case["n"]
    dtype = getattr(torch, case["dtype"])
    cuda = torch.device("cuda")
    nb = min(blocked.DEFAULT_BLOCK_SIZE, n)
    leaf = blocked.panel_plan(m // P, n, nb, True, dtype, cuda)
    combine = blocked.panel_plan(P * n, n, nb, True, dtype, cuda)
    per_rank_plan = sum(blocked.kernel_leaves(w, lw)
                        for _, w, lw in leaf + combine if lw)
    for j, engine in enumerate(case["engines"]):
        rows = [r[j] for r in per_rank]
        launches = sum(r["launches"][hp_.KERNELS[dtype]] for r in rows)
        expect = P * per_rank_plan if engine == "tsqr" else 0
        ref = rows[0]["torch_lstsq_residual"]
        row = {"phase": 14, "name": "sharded_rows", **where,
               "engine": engine, "dtype": case["dtype"], "shape": [m, n],
               "first_s": max(r["first_s"] for r in rows),
               "s": max(r["s"] for r in rows),
               "torch_lstsq_s": rows[0]["torch_lstsq_s"],
               "normal_eq_residual": rows[0]["residual"],
               "torch_lstsq_residual": ref,
               "ratio": rows[0]["residual"] / ref, "criterion": CRITERION,
               "launches": launches, "expected": expect}
        row["ok"] = (bool(np.isfinite(rows[0]["residual"]))
                     and rows[0]["residual"] <= CRITERION * ref
                     and launches == expect)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"sharded row engine failed: {row}")


# -- phase 15: the guarded path and the updatable QR -------------------------

TOL_ROUND_TRIP = 1e-3   # ||R' - R|| / ||R||, rows to a positive diagonal,
# after an update and a downdate with the same vectors (f32)


def _ne_in(A, x, b) -> float:
    """||A^H (A x - b)|| evaluated on the card in the input's precision."""
    return float(torch.linalg.vector_norm(A.mH @ (A @ x - b)))


def _torch_lstsq(A, b):
    return torch.linalg.lstsq(A, b[:, None]).solution[:, 0]


def _path_of(res):
    return [[a.engine, a.outcome, a.policy, a.detail] for a in res.attempts]


def _launches_of(hp, fn):
    """(fn(), {kernel: launches during it}, seconds)."""
    l0 = dict(hp.LAUNCHES)
    out, t = wall(fn)
    return out, {k: hp.LAUNCHES[k] - l0[k] for k in l0}, t


def _counted(hp, fn, tally):
    """:func:`_launches_of`, adding the launches to ``tally``, the phase's
    own account of what its path launched."""
    out, launched, t = _launches_of(hp, fn)
    for k, n in launched.items():
        tally[k] = tally.get(k, 0) + n
    return out, launched, t


def _uncounted(hp, fn):
    """:func:`_launches_of` for a yardstick run inside a counted path (the
    unguarded call a guarded one is held to, a fresh factorization an
    update is timed against): its launches are taken back out of the
    counts, so that the path's count holds the path's own calls only."""
    out, launched, t = _launches_of(hp, fn)
    for k, n in launched.items():
        hp.LAUNCHES[k] -= n
    return out, launched, t


def _ill_conditioned(m, n, cond, seed):
    """A Gaussian (m, n) f32 matrix with singular values scaled by a
    geometric ladder from 1 to 1/cond (cond(A) within a small factor of
    ``cond``), and b, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn((m, n), generator=g, device="cuda", dtype=torch.float32)
    V, _ = torch.linalg.qr(torch.randn((n, n), generator=g, device="cuda",
                                       dtype=torch.float64))
    s = torch.logspace(0, -np.log10(cond), n, device="cuda",
                       dtype=torch.float64)
    A = (G.double() @ (s[:, None] * V.T)).float()
    b = torch.randn((m,), generator=g, device="cuda", dtype=torch.float32)
    return A, b


def phase_guarded(dt, hp, seed, card):
    """(a) ``guarded_lstsq`` at 16384^2 f32 in the default "fallback"
    mode against the unguarded ``lstsq``: the same x bit for bit, one "ok"
    attempt, the same launches, and the guard's cost; (b) the same under an
    injected ``numeric.breakdown:1.0:1``, which escalates to the policy
    rung (the fault fires before rung 0 runs, so one factorization
    launches), within 8x of ``torch.linalg.lstsq`` in the input's
    precision; (c) ``engine="cholqr2"``, ``guards="full"`` at 65536 x 256
    f32 with cond 1e5 (past CholeskyQR2's window, inside the shifted
    form's): rung 0 breaks down, the answer meets the residual gate; then a
    ``numeric.breakdown:1.0:2`` schedule that lands on the tsqr rung, its
    launches the TSQR plan; (d) ``guarded_qr`` at 8192 x 4096 c64 (32
    launches, backward error), and the same with a zero column, refused
    before any launch; (e) ``guards="full"`` at the reference's 4400 x 4000
    f32. Returns the launches of its guarded calls; the unguarded calls of
    (a) are yardsticks and stay out of the path's count."""
    from dhqr_tpu_torch import faults
    from dhqr_tpu_torch.numeric import guards, ladder
    from dhqr_tpu_torch.utils.config import FaultConfig

    f32 = "panel_qr_f32"
    n = 16384
    g = torch.Generator(device="cuda").manual_seed(seed + 15)
    A = torch.rand((n, n), generator=g, device="cuda", dtype=torch.float32)
    b = torch.rand((n,), generator=g, device="cuda", dtype=torch.float32)
    expect = expected_launches(n, n, torch.float32)
    tally = {}  # the launches of this phase's guarded calls
    _uncounted(hp, lambda: dt.lstsq(A, b))  # warm-up of both paths
    _counted(hp, lambda: ladder.guarded_lstsq(A, b), tally)
    times = {"unguarded": [], "guarded": []}
    for _ in range(2):
        x0, l_u, t = _uncounted(hp, lambda: dt.lstsq(A, b))
        times["unguarded"].append(t)
        res, l_g, t = _counted(hp, lambda: ladder.guarded_lstsq(A, b), tally)
        times["guarded"].append(t)
    l_u, l_g = l_u[f32], l_g[f32]
    t_u, t_g = min(times["unguarded"]), min(times["guarded"])
    row = {"phase": 15, "name": "guarded_lstsq_square", "shape": [n, n],
           "card": card, "mode": "fallback", "unguarded_s": times["unguarded"],
           "guarded_s": times["guarded"],
           "overhead_pct": 100.0 * (t_g - t_u) / t_u,
           "bit_equal": bool(torch.equal(x0, res.x)),
           "attempts": _path_of(res), "launches_unguarded": l_u,
           "launches_guarded": l_g, "expected": expect}
    row["ok"] = (row["bit_equal"] and [a.outcome for a in res.attempts]
                 == ["ok"] and l_u == l_g == expect)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded square check failed: {row}")
    del x0
    with faults.injected(FaultConfig(sites=(("numeric.breakdown", 1.0, 1),))):
        res, launches, t = _counted(
            hp, lambda: ladder.guarded_lstsq(A, b), tally)
    launches = launches[f32]
    x_ref, t_ref = wall(lambda: _torch_lstsq(A, b))
    ratio = _ne_in(A, res.x, b) / _ne_in(A, x_ref, b)
    row = {"phase": 15, "name": "guarded_lstsq_injected", "shape": [n, n],
           "s": t, "attempts": _path_of(res), "launches": launches,
           "expected": expect, "ratio_to_torch_lstsq": ratio,
           "torch_lstsq_s": t_ref, "criterion": CRITERION}
    row["ok"] = ([(a.outcome, a.detail) for a in res.attempts]
                 == [("breakdown", "injected numeric.breakdown"),
                     ("ok", None)]
                 and res.escalations == 1 and launches == expect
                 and ratio <= CRITERION)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded injected check failed: {row}")
    del A, b, res, x_ref
    torch.cuda.empty_cache()

    m, k = 65536, 256
    A, b = _ill_conditioned(m, k, 1e5, seed + 16)
    tsqr_plan = tsqr_expected_launches(m, k, 8, torch.float32)
    x_ref, t_ref = wall(lambda: _torch_lstsq(A, b))
    res, launches, t = _counted(hp, lambda: ladder.guarded_lstsq(
        A, b, engine="cholqr2", guards="full"), tally)
    launches = launches[f32]
    _, t_probe = wall(lambda: guards.residual_ratio(A, b, res.x))
    row = {"phase": 15, "name": "guarded_cholqr2_ill_conditioned",
           "shape": [m, k], "cond": 1e5, "s": t, "probe_s": t_probe,
           "attempts": _path_of(res),
           "residual_ratio": res.residual_ratio, "launches": launches,
           "ratio_to_torch_lstsq": _ne_in(A, res.x, b) / _ne_in(A, x_ref, b),
           "torch_lstsq_s": t_ref, "criterion": CRITERION}
    row["ok"] = (res.attempts[0].outcome == "breakdown"
                 and res.residual_ratio is not None
                 and res.residual_ratio <= CRITERION)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded cholqr2 check failed: {row}")
    with faults.injected(FaultConfig(sites=(("numeric.breakdown", 1.0, 2),))):
        res, launches, t = _counted(hp, lambda: ladder.guarded_lstsq(
            A, b, engine="cholqr2"), tally)
    launches = launches[f32]
    row = {"phase": 15, "name": "guarded_to_tsqr_rung", "shape": [m, k],
           "s": t, "attempts": _path_of(res), "launches": launches,
           "expected": tsqr_plan,
           "ratio_to_torch_lstsq": _ne_in(A, res.x, b) / _ne_in(A, x_ref, b)}
    row["ok"] = res.engine == "tsqr" and launches == tsqr_plan == 18
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded tsqr rung check failed: {row}")
    del A, b, res, x_ref
    torch.cuda.empty_cache()

    m, k = 8192, 4096
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    A = torch.rand((m, k), generator=g, device="cuda", dtype=torch.complex64)
    expect = expected_launches(m, k, torch.complex64)
    res, launches, t = _counted(
        hp, lambda: ladder.guarded_qr(A, guards="full"), tally)
    launches = launches["panel_qr_c64"]
    back = backward_error(res.factorization, A)
    A[:, 7] = 0
    refused = []

    def refuse():
        try:
            ladder.guarded_qr(A, guards="full")
        except dt.IllConditioned as exc:
            refused.append(str(exc)[:80])

    _, l_zero, _ = _counted(hp, refuse, tally)
    refused = refused[0] if refused else None
    l_zero = sum(l_zero.values())
    row = {"phase": 15, "name": "guarded_qr_c64", "shape": [m, k], "s": t,
           "attempts": _path_of(res), "cond_estimate": res.cond_estimate,
           "launches": launches, "expected": expect,
           "backward_error": back, "tol_backward": TOL_BACKWARD_C64,
           "zero_column_refused": refused, "zero_column_launches": l_zero}
    row["ok"] = (launches == expect == 32 and back < TOL_BACKWARD_C64
                 and refused is not None and l_zero == 0)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded qr c64 check failed: {row}")
    del A, res
    torch.cuda.empty_cache()

    A, b = random_problem(4400, 4000, np.float32, seed + 3)
    res, launches, t = _counted(hp, lambda: ladder.guarded_lstsq(
        A, b, guards="full"), tally)
    launches = launches[f32]
    row = {"phase": 15, "name": "guarded_lstsq_reference", "shape":
           [4400, 4000], "s": t, "attempts": _path_of(res),
           "residual_ratio": res.residual_ratio, "launches": launches,
           "criterion": CRITERION}
    row["ok"] = (res.residual_ratio is not None
                 and res.residual_ratio <= CRITERION and launches >= 1)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded reference check failed: {row}")
    return tally


def _positive_rows(R):
    """R with each row scaled to a positive diagonal (R is unique up to
    those signs)."""
    d = torch.diagonal(R)
    return R * (d.abs() / d)[:, None].conj()


def _gram_gap(R, A) -> float:
    """||R^H R - A^H A||_F / ||A^H A||_F in double: how far R is from a
    QR factor of A, whatever the signs of its rows."""
    R64, A64 = R.double(), A.double()
    G = A64.mH @ A64
    return float(torch.linalg.matrix_norm(R64.mH @ R64 - G)
                 / torch.linalg.matrix_norm(G))


GRAM_STEPS = (7, 15, 23, 30, 47, 63)  # steps of phase 15 (f) that sweep
# (no refactor), 30 the last before the threshold refactor at 31


def phase_update(dt, hp, seed, card, m=65536, n=256, steps=64):
    """``UpdatableQR`` at ``BASELINE.json``'s tall-skinny shape: a seeded
    stream of 64 rank-1 steps (update and downdate in turn) with the
    default refactor policy (after 32) and one injected
    ``numeric.breakdown`` refactor (step 40). Holds the initial
    factorization and each refactor to the blocked plan's launches and
    every other step to none; at :data:`GRAM_STEPS` the sweeps' R against
    the live A (``_gram_gap`` within ``TOL_GRAM``), beside the gap that R
    from before the step would read (a sweep that left R as it was), which
    must lie past the limit; every 8 steps ``solve`` on the live A within
    8x of ``torch.linalg.lstsq`` of that A (in the input's precision); an
    update and a downdate with the same vectors bring R back within 1e-3.
    Times per update and per solve, the kernels one update launches
    (``torch.profiler``), and, as yardsticks outside the path's count, a
    fresh ``qr`` and a fresh ``lstsq`` at the shape. Returns the launches
    of the stream's calls."""
    from dhqr_tpu_torch import faults
    from dhqr_tpu_torch.utils.config import FaultConfig

    f32 = "panel_qr_f32"
    tally = {}
    expect = expected_launches(m, n, torch.float32)
    g = torch.Generator(device="cuda").manual_seed(seed + 18)
    A = torch.rand((m, n), generator=g, device="cuda", dtype=torch.float32)
    b = torch.rand((m,), generator=g, device="cuda", dtype=torch.float32)
    live, l_init, t_init = _counted(hp, lambda: dt.UpdatableQR(A), tally)
    reasons = [[-1, live.last_refactor["reason"]]]
    refactor_launches = [l_init[f32]]
    stray = 0  # launches of the steps that did not refactor, and of solves
    t_steps, solves, worst, grams = [], [], 0.0, []
    for step in range(steps):
        u = 0.01 * torch.randn((m,), generator=g, device="cuda")
        v = torch.randn((n,), generator=g, device="cuda")
        op = live.update if step % 2 == 0 else live.downdate
        R_before = live.r_matrix().clone() if step in GRAM_STEPS else None
        if step == 40:
            with faults.injected(FaultConfig(
                    sites=(("numeric.breakdown", 1.0, 1),))):
                info, launched, t = _counted(hp, lambda: op(u, v), tally)
        else:
            info, launched, t = _counted(hp, lambda: op(u, v), tally)
        if info["refactored"]:
            reasons.append([step, info["reason"]])
            refactor_launches.append(launched[f32])
        else:
            t_steps.append(t)
            stray += sum(launched.values())
        if R_before is not None:
            grams.append([step, _gram_gap(live.r_matrix(), live.matrix),
                          _gram_gap(R_before, live.matrix)])
            del R_before
        if step % 8 == 7:
            x, launched, t_solve = _counted(hp, lambda: live.solve(b), tally)
            stray += sum(launched.values())
            solves.append(t_solve)
            Al = live.matrix
            ratio = _ne_in(Al, x, b) / _ne_in(Al, _torch_lstsq(Al, b), b)
            worst = max(worst, ratio)
    R0 = _positive_rows(live.r_matrix())
    u = 0.01 * torch.randn((m,), generator=g, device="cuda")
    v = torch.randn((n,), generator=g, device="cuda")
    _, launched, _ = _counted(
        hp, lambda: (live.update(u, v), live.downdate(u, v)), tally)
    stray += sum(launched.values())
    drift = float(torch.linalg.matrix_norm(_positive_rows(live.r_matrix())
                                           - R0)
                  / torch.linalg.matrix_norm(R0))
    prof, launched, _ = _counted(
        hp, lambda: _solve_profile(lambda: live.update(u, v), "cuda"), tally)
    stray += sum(launched.values())
    _uncounted(hp, lambda: dt.qr(A))  # warm-up
    _, _, t_qr = _uncounted(hp, lambda: dt.qr(A))
    _, _, t_lstsq = _uncounted(hp, lambda: dt.lstsq(A, b))
    row = {"phase": 15, "name": "updatable_qr_stream", "shape": [m, n],
           "card": card, "steps": steps, "init_s": t_init,
           "refactors": reasons, "refactor_launches": refactor_launches,
           "expected": expect, "stray_launches": stray,
           "update_ms_median": 1e3 * float(np.median(t_steps)),
           "update_ms_min": 1e3 * min(t_steps),
           "solve_ms": [1e3 * t for t in solves],
           "worst_solve_ratio_to_torch_lstsq": worst,
           "criterion": CRITERION,
           "gram_step_sweep_noop": grams, "tol_gram": TOL_GRAM,
           "round_trip_r_drift": drift, "tol_round_trip": TOL_ROUND_TRIP,
           "update_kernels_profiled": prof["kernels"],
           "update_profiled_wall_s": prof["wall_s"],
           "update_device_busy_s": prof["device_busy_s"],
           "fresh_qr_s": t_qr, "fresh_lstsq_s": t_lstsq}
    row["ok"] = (reasons == [[-1, "initial"], [31, "threshold"],
                             [40, "injected_breakdown"]]
                 and refactor_launches == [expect] * 3 and expect == 4
                 and stray == 0
                 and len(grams) == len(GRAM_STEPS)
                 and all(sweep <= TOL_GRAM < noop for _, sweep, noop in grams)
                 and worst <= CRITERION and drift <= TOL_ROUND_TRIP)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"updatable QR check failed: {row}")
    return tally


# -- phase 16: the wire --------------------------------------------------------
#
# The compressed wire, the two-tier pod mesh, the depth-k pipeline and pulse,
# in spawned processes that share card 0 as phase 14's: one NCCL rank, then
# gloo with 4 and with 2 ranks. Each collective is read from the wire seam's
# census, whose bytes are held to ``wire_bytes_formula``; times are processes
# time-sharing one H100, never a scaling number.

WIRE_BACKWARD = 0.05   # a bf16-wire factor's backward error stays below
# this, and above the uncompressed one's (the compression is real): the
# JAX package's bound (tests/test_wire.py, bf16 comms backward error). An
# int8-wire factor's is printed and held above the uncompressed one's
# (0.041 at 1024^2 and 0.095 at 4096^2 on the CPU: no bound is claimed)
# Corrected semi-normal sweeps a caller adds to a bf16 column-mesh lstsq at
# the reference's 4400 x 4000 (condition ~2e3): the model tier's floor of 2
# (the JAX package's CSNE_MODEL_SWEEPS) leaves it ~100x off the 8x bar, as
# it leaves the JAX package's own solve; int8's sweeps diverge there. The
# floor runs are printed, the runs with these sweeps held to 8x.
WIRE_SWEEPS = 6
WIRE_RUNS_4 = (("none", "cols", {}),
               ("bf16", "cols", {"comms": "bf16"}),
               ("int8", "cols", {"comms": "int8"}),
               ("pod2x2", "pod:2x2", {}),
               ("pod2x2_dcn_bf16", "pod:2x2", {"comms": "dcn:bf16"}),
               ("pod2x2f", "pod:2x2", {"flat": True}),
               ("pod2x2f_dcn_bf16", "pod:2x2", {"flat": True,
                                                 "comms": "dcn:bf16"}),
               ("depth2", "cols", {"lookahead": True, "overlap_depth": 2}),
               ("depth3", "cols", {"lookahead": True, "overlap_depth": 3}),
               ("depth2_bf16", "cols", {"lookahead": True, "overlap_depth": 2,
                                        "comms": "bf16"}),
               ("depth3_bf16", "cols", {"lookahead": True, "overlap_depth": 3,
                                        "comms": "bf16"}))


def wire_bytes_formula(entry) -> int:
    """The bytes a census entry's collective must carry, from its parts'
    shapes alone: a word at its own size uncompressed and for complex
    payloads; 2 bytes under bf16 (and an int8 dense sum, which carries
    bf16); under int8 1 byte plus one word of the payload's dtype per
    (32-row block, column) of a matrix, per vector otherwise. A gather
    carries every rank's share."""
    itemsize = {"float32": 4, "float64": 8, "complex64": 8,
                "complex128": 16}[entry["dtype"]]
    comms = entry["comms"]
    mode = None if comms is None or entry["dtype"].startswith("complex") \
        else "int8" if comms == "int8" and entry["onehot"] else "bf16"
    total = 0
    for shape in entry["shapes"]:
        n = int(np.prod(shape))
        if mode is None:
            total += n * itemsize
        elif mode == "bf16":
            total += 2 * n
        else:
            if len(shape) == 2:
                r, c = shape
                scales = -(-r // min(32, max(r, 1))) * c
            else:
                scales = shape[-1] if len(shape) > 2 else 1
            total += n + scales * itemsize
    return total * (entry["ranks"] if entry["family"] == "all_gather" else 1)


def _census_summary(entries) -> dict:
    """Per family and per leg bytes of a census, its ratio to the same
    payloads uncompressed, and whether every entry carried exactly what
    :func:`wire_bytes_formula` says."""
    fams, legs = {}, {}
    for e in entries:
        row = fams.setdefault(e["family"], {"collectives": 0, "launches": 0,
                                            "bytes": 0, "raw_bytes": 0})
        row["collectives"] += 1
        row["launches"] += e["launches"]
        row["bytes"] += e["bytes"]
        row["raw_bytes"] += e["raw_bytes"]
        legs[e["leg"]] = legs.get(e["leg"], 0) + e["bytes"]
    total = sum(e["bytes"] for e in entries)
    raw = sum(e["raw_bytes"] for e in entries)
    return {"families": fams, "legs": legs, "bytes": total,
            "raw_bytes": raw, "ratio": total / raw if raw else None,
            "formula_bytes": sum(wire_bytes_formula(e) for e in entries),
            "formula_ok": all(e["bytes"] == wire_bytes_formula(e)
                              for e in entries),
            "complex_compressed": any(
                e["dtype"].startswith("complex") and e["wire"] != e["dtype"]
                for e in entries),
            "compressed": any(e["bytes"] != e["raw_bytes"] for e in entries),
            "int8": any("int8" in e["wire"] for e in entries)}


def _local_backward(fact, A):
    """(||(QR - A)[:, mine]||^2, ||A[:, mine]||^2), in double, over this
    rank's columns of a mesh factorization (summed over the ranks by the
    caller)."""
    from dhqr_tpu_torch.ops import blocked
    from dhqr_tpu_torch.parallel import sharded_qr

    m, n = A.shape
    mesh, nb = fact.mesh, fact.block_size
    gidx = torch.as_tensor(sharded_qr._local_gidx(
        mesh.rank, n, n // mesh.size, nb, fact.layout), device=A.device)
    Hn = fact.natural_H()
    Rp = torch.where(torch.arange(n, device=A.device)[:, None] < gidx,
                     Hn[:n].index_select(1, gidx), 0)
    Rp[gidx, torch.arange(gidx.numel(), device=A.device)] = fact.alpha[gidx]
    QRp = blocked._apply_q_impl(Hn, torch.cat([Rp, Rp.new_zeros(
        (m - n, Rp.shape[1]))]), nb, fact.precision)
    Ap = A.index_select(1, gidx)
    wide = torch.complex128 if A.is_complex() else torch.float64
    return (float(torch.linalg.vector_norm((QRp - Ap).to(wide)) ** 2),
            float(torch.linalg.vector_norm(Ap.to(wide)) ** 2))


def _wire_problem(m, n, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype.is_complex:
        def draw(shape):
            return torch.complex(
                torch.rand(shape, generator=g, device=device),
                torch.rand(shape, generator=g, device=device))
    else:
        def draw(shape):
            return torch.rand(shape, generator=g, device=device, dtype=dtype)
    return draw((m, n)), draw((m,))


def _wire_qr_case(ctx, m, n, dtype, seed, runs, pulse_run=None):
    """``qr`` + ``solve`` per run (label, mesh, knobs): seconds, launches,
    this rank's share of the backward error, the solve's normal-equations
    residual, and the census of both calls. ``pulse_run`` repeats one run
    with pulse armed and returns its reports (the dispatches run twice
    there: warm, then profiled)."""
    dt, hp, wire, pulse = ctx["dt"], ctx["hp"], ctx["wire"], ctx["pulse"]
    device, dtype = ctx["device"], getattr(torch, dtype)
    A, b = _wire_problem(m, n, dtype, seed, device)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    A64, b64 = A.to(wide), b.to(wide)
    # one untimed factorization first: the process's first call holds
    # cuBLAS's and the communicator's set-up
    dt.qr(A, mesh=ctx["mesh"](runs[0][1])).solve(b)
    rows = []
    for label, spec, kw in runs:
        mesh, kw = ctx["mesh"](spec), dict(kw)
        if kw.pop("flat", False):
            kw["mesh_axis"] = dataclasses.replace(
                ctx["tier"](spec), hierarchical=False)
        l0 = dict(hp.LAUNCHES)
        with wire.census() as cen_qr:
            fact, t = _timed(lambda: dt.qr(A, mesh=mesh, **kw), device)
        with wire.census() as cen_solve:
            x, t_solve = _timed(lambda: fact.solve(b), device)
        launches = {k: hp.LAUNCHES[k] - l0[k] for k in l0}
        census = _census_summary(cen_qr.entries + cen_solve.entries)
        factor = _census_summary(cen_qr.entries)
        census["factor_compressed"] = factor["compressed"]
        census["factor_int8"] = factor["int8"]
        bsq, asq = _local_backward(fact, A)
        rows.append({
            "run": label, "mesh": spec, "s": t, "solve_s": t_solve,
            "launches": launches, "backward_sq": bsq, "a_sq": asq,
            "residual": float(torch.linalg.vector_norm(
                A64.mH @ (A64 @ x.to(wide) - b64))),
            "finite": bool(torch.isfinite(torch.view_as_real(x)).all()
                           if x.is_complex() else torch.isfinite(x).all()),
            "census": census})
        del fact, x
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if pulse_run is not None:
        label, spec, kw = pulse_run
        mesh = ctx["mesh"](spec)
        with pulse.pulsed() as store:
            fact = dt.qr(A, mesh=mesh, **kw)
            fact.solve(b)
        rows.append({"run": label, "mesh": spec, "pulse": [
            r.to_json() for r in store.reports()]})
    return rows


def _wire_lstsq_case(ctx, m, n, seed, runs):
    """``lstsq(mesh=)`` of the reference's problem (numpy, from the seed)
    per (mesh, comms, refine): ``refine`` 0 leaves the model tier's floor
    of corrected semi-normal sweeps, more adds the caller's; x comes back
    for the parent's LAPACK oracle."""
    dt, hp, wire = ctx["dt"], ctx["hp"], ctx["wire"]
    A, b = random_problem(m, n, np.float32, seed)
    rows = []
    for spec, comms, refine in runs:
        mesh = ctx["mesh"](spec)
        l0 = dict(hp.LAUNCHES)
        with wire.census() as cen:
            x, t = _timed(lambda: dt.lstsq(A, b, mesh=mesh, comms=comms,
                                           refine=refine), ctx["device"])
        rows.append({"mesh": spec, "comms": comms, "refine": refine, "s": t,
                     "x": x.cpu().numpy(),
                     "launches": {k: hp.LAUNCHES[k] - l0[k] for k in l0},
                     "census": _census_summary(cen.entries)})
    return rows


def _wire_rows_case(ctx, m, n, seed, runs):
    """``lstsq(engine=..., comms=...)`` on the row mesh, of a problem made
    with numpy from the seed; x comes back for the parent's LAPACK oracle,
    and rank 0's ``torch.linalg.lstsq`` x beside it (a yardstick)."""
    dt, hp, wire, device = ctx["dt"], ctx["hp"], ctx["wire"], ctx["device"]
    A, b = (torch.from_numpy(a).to(device)
            for a in random_problem(m, n, np.float32, seed))
    mesh = ctx["mesh"]("rows")
    rows = []
    for engine, comms in runs:
        l0 = dict(hp.LAUNCHES)
        with wire.census() as cen:
            x, t = _timed(lambda: dt.lstsq(A, b, mesh=mesh, engine=engine,
                                           comms=comms), device)
        rows.append({"engine": engine, "comms": comms, "s": t,
                     "x": x.cpu().numpy(),
                     "launches": {k: hp.LAUNCHES[k] - l0[k] for k in l0},
                     "census": _census_summary(cen.entries)})
    if mesh.rank == 0:
        x_ref = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
        rows[0]["torch_lstsq_x"] = x_ref.cpu().numpy()
    return rows


def _wire_complex_case(ctx, m, n, seed):
    """c64 ``qr`` + ``solve`` at None and at bf16: complex payloads pass
    uncompressed, so the two runs agree bit for bit (H, alpha, x)."""
    dt, hp, wire, device = ctx["dt"], ctx["hp"], ctx["wire"], ctx["device"]
    A, b = _wire_problem(m, n, torch.complex64, seed, device)
    mesh = ctx["mesh"]("cols")
    out = {}
    for comms in (None, "bf16"):
        l0 = dict(hp.LAUNCHES)
        with wire.census() as cen:
            fact, t = _timed(lambda: dt.qr(A, mesh=mesh, comms=comms),
                             device)
            x = fact.solve(b)
        out[comms] = (fact.H, fact.alpha, x, t,
                      {k: hp.LAUNCHES[k] - l0[k] for k in l0},
                      _census_summary(cen.entries))
    (H0, a0, x0, _, _, _), (H1, a1, x1, t, launches, cen) = \
        out[None], out["bf16"]
    return [{"s": t, "launches": launches, "census": cen,
             "none_launches": out[None][4],
             "bit_identical": bool(torch.equal(H0, H1) and torch.equal(a0, a1)
                                   and torch.equal(x0, x1))}]


_WIRE_CASES = {"qr": _wire_qr_case, "lstsq": _wire_lstsq_case,
               "rows": _wire_rows_case, "complex": _wire_complex_case}


def wire_worker(device, cases):
    """One rank of phase 16 (run by ``run_ranks``): each case on this
    rank's meshes; returns {"cases": per-case rows, "launches": this
    rank's kernel launches in the cases}."""
    import dhqr_tpu_torch as dt
    from dhqr_tpu_torch import parallel
    from dhqr_tpu_torch.obs import pulse
    from dhqr_tpu_torch.ops import hopper_panel as hp
    from dhqr_tpu_torch.parallel import wire

    meshes, tiers = {}, {}

    def mesh_of(spec):
        if spec not in meshes:
            if spec.startswith("pod:"):
                meshes[spec], tiers[spec] = parallel.pod_mesh(
                    topo=spec[4:], device=device)
            elif spec == "rows":
                meshes[spec] = parallel.row_mesh(device=device)
            else:
                meshes[spec] = parallel.column_mesh(device=device)
        return meshes[spec]

    def tier_of(spec):
        mesh_of(spec)
        return tiers[spec]

    ctx = {"dt": dt, "hp": hp, "wire": wire, "pulse": pulse,
           "device": device, "mesh": mesh_of, "tier": tier_of}
    out = []
    launches = dict.fromkeys(hp.KERNELS.values(), 0)
    for case in cases:
        case = dict(case)
        hp.reset_launches()
        out.append(_WIRE_CASES[case.pop("kind")](ctx, **case))
        for name, count in hp.LAUNCHES.items():
            launches[name] += count
    return {"cases": out, "launches": launches}


def _wire_census_row(cen) -> dict:
    return {"census_bytes_by_family": {
                f: r["bytes"] for f, r in cen["families"].items()},
            "census_launches_by_family": {
                f: r["launches"] for f, r in cen["families"].items()},
            "census_bytes_by_leg": cen["legs"],
            "census_ratio": cen["ratio"], "census_bytes": cen["bytes"],
            "formula_bytes": cen["formula_bytes"],
            "formula_ok": cen["formula_ok"]}


def _check_wire_qr(case, per_rank, P, where):
    """Each run of a ``qr`` case: the launches summed over the ranks are
    the plan's, the census carried what the formula says, the backward
    error stays in its bound (a run whose factorization compressed a
    payload: below ``WIRE_BACKWARD`` and above the uncompressed run's; the
    flat pod schedule has no cross-host leg to compress, though its solve,
    on the default hierarchical axis, has); pulse rows
    print their reports, whose DHQR306 must read skip with the reason (no
    collective of one card crosses a link with a known bandwidth)."""
    from dhqr_tpu_torch.ops import hopper_panel as hp_

    m, n = case["m"], case["n"]
    dtype = getattr(torch, case["dtype"])
    plan = sharded_plan(m, n, dtype, P)
    base = None
    for j in range(len(per_rank[0])):
        rows = [r[j] for r in per_rank]
        if "pulse" in rows[0]:
            for rank, r in enumerate(rows):
                if len(r["pulse"]) != 2:  # the qr and the solve dispatch
                    raise AssertionError(f"pulse captured {r['pulse']}")
                for rep in r["pulse"]:
                    emit({"phase": 16, "name": "wire_pulse", **where,
                          "rank": rank, "run": r["run"],
                          "label": rep["label"],
                          "measured": rep["measured"],
                          "measured_unavailable": rep.get(
                              "measured_unavailable"),
                          "census": rep["analytic"],
                          "dhqr306": rep["dhqr306"]["status"],
                          "dhqr306_reason": rep["dhqr306"].get("reason"),
                          "comms": rep.get("comms")})
                    if rep["dhqr306"]["status"] != "skip" \
                            or not rep["dhqr306"].get("reason") \
                            or not rep["analytic"]:
                        raise AssertionError(f"pulse failed: {rep}")
            continue
        backward = (sum(r["backward_sq"] for r in rows)
                    / sum(r["a_sq"] for r in rows)) ** 0.5
        launches = sum(r["launches"][hp_.KERNELS[dtype]] for r in rows)
        cen = rows[0]["census"]
        comms = any(r["census"]["factor_compressed"] for r in rows)
        int8 = any(r["census"]["factor_int8"] for r in rows)
        if rows[0]["run"] == "none":
            base = backward
        row = {"phase": 16, "name": "wire_qr", **where, "run": rows[0]["run"],
               "mesh": rows[0]["mesh"], "dtype": case["dtype"],
               "shape": [m, n], "s": max(r["s"] for r in rows),
               "solve_s": max(r["solve_s"] for r in rows),
               "backward_error": backward,
               "solve_normal_eq_residual": rows[0]["residual"],
               "launches": launches, "expected": plan,
               "compressed": comms, "int8": int8,
               "uncompressed_backward_error": base,
               **_wire_census_row(cen),
               "formula_ok_all_ranks": all(r["census"]["formula_ok"]
                                           for r in rows)}
        bound = np.inf if int8 else WIRE_BACKWARD if comms \
            else TOL_BACKWARD_F32
        row["ok"] = (all(r["finite"] for r in rows) and launches == plan
                     and row["formula_ok_all_ranks"] and backward < bound
                     and (not comms or base is None or backward > base))
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"wire qr failed: {row}")


def phase_wire(hp, seed):
    """The wire on one card: (a) one NCCL rank, ``qr`` + ``solve`` at
    16384^2 f32 per wire format, then one run with pulse armed; (b) 4 gloo
    ranks at 16384^2 f32: flat bf16 and int8, a 2x2 pod mesh hierarchical
    and flat at None and dcn:bf16, the depth-2 and depth-3 pipeline at None
    and bf16, then one run with pulse armed; (c) ``lstsq`` 4400 x 4000 f32
    per wire format at the model tier's floor of sweeps (printed), and the
    bf16 formats with ``WIRE_SWEEPS`` under 8x; (d) 65536 x 256 f32 TSQR
    and CholeskyQR2 on the row mesh, uncompressed and at bf16 and int8,
    under 8x of numpy's LAPACK QR; (e) 2 gloo ranks, 8192 x 4096
    c64 at bf16: no complex payload compressed, every result bit-identical
    to None's. Launches of every rank are added into the parent's."""
    from dhqr_tpu_torch.parallel._ranks import run_ranks
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    torch.cuda.empty_cache()
    device = "cuda:0"
    square = {"kind": "qr", "m": 16384, "n": 16384, "dtype": "float32",
              "seed": seed + 16}
    runs = [
        ("a", "nccl", 1, [dict(
            square, runs=[("none", "cols", {}),
                          ("bf16", "cols", {"comms": "bf16"}),
                          ("int8", "cols", {"comms": "int8"})],
            pulse_run=("pulse_bf16", "cols", {"comms": "bf16"}))]),
        ("bcd", "gloo", 4, [
            dict(square, runs=list(WIRE_RUNS_4),
                 pulse_run=("pulse_bf16", "cols", {"comms": "bf16"})),
            {"kind": "lstsq", "m": 4400, "n": 4000, "seed": seed + 3,
             "runs": [("cols", "bf16", 0), ("cols", "int8", 0),
                      ("pod:2x2", "dcn:bf16", 0), ("pod:2x2", "dcn:int8", 0),
                      ("cols", "bf16", WIRE_SWEEPS),
                      ("pod:2x2", "dcn:bf16", WIRE_SWEEPS)]},
            {"kind": "rows", "m": 65536, "n": 256, "seed": seed + 17,
             "runs": [("tsqr", None), ("tsqr", "bf16"), ("tsqr", "int8"),
                      ("cholqr2", None), ("cholqr2", "bf16"),
                      ("cholqr2", "int8")]}]),
        ("e", "gloo", 2, [{"kind": "complex", "m": 8192, "n": 4096,
                           "seed": seed + 18}]),
    ]
    for label, backend, P, cases in runs:
        t0 = time.perf_counter()
        ranks = run_ranks(wire_worker, P, backend=backend, device=device,
                          timeout_s=420, cases=cases)
        wall_s = time.perf_counter() - t0
        for r in ranks:
            for name, count in r["launches"].items():
                hp.LAUNCHES[name] += count
        where = {"backend": backend, "ranks": P, "ranks_per_card": P}
        for i, case in enumerate(cases):
            per_rank = [r["cases"][i] for r in ranks]
            kind = case["kind"]
            if kind == "qr":
                _check_wire_qr(case, per_rank, P, where)
            elif kind == "lstsq":
                A, b, oracle = oracle_of(case["m"], case["n"], np.float32,
                                         case["seed"])
                expect = sharded_plan(case["m"], case["n"], torch.float32, P)
                for j, r0 in enumerate(per_rank[0]):
                    res = normal_equations_residual(A, r0["x"], b)
                    launches = sum(r[j]["launches"]["panel_qr_f32"]
                                   for r in per_rank)
                    row = {"phase": 16, "name": "wire_lstsq", **where,
                           "mesh": r0["mesh"], "comms": r0["comms"],
                           "refine": r0["refine"],
                           "shape": [case["m"], case["n"]],
                           "s": max(r[j]["s"] for r in per_rank),
                           "normal_eq_residual": res,
                           "lapack_residual": oracle,
                           "ratio": res / oracle, "criterion": CRITERION,
                           "launches": launches, "expected": expect,
                           **_wire_census_row(r0["census"])}
                    row["meets_criterion"] = bool(res < CRITERION * oracle)
                    row["ok"] = (bool(np.isfinite(res))
                                 and (row["meets_criterion"]
                                      or not r0["refine"])
                                 and launches == expect
                                 and all(r[j]["census"]["formula_ok"]
                                         for r in per_rank))
                    emit(row)
                    if not row["ok"]:
                        raise AssertionError(f"wire lstsq failed: {row}")
            elif kind == "rows":
                _check_wire_rows(case, per_rank, P, where,
                                 normal_equations_residual)
            else:
                r0 = per_rank[0][0]
                launches = sum(r[0]["launches"]["panel_qr_c64"]
                               for r in per_rank)
                expect = sharded_plan(case["m"], case["n"],
                                      torch.complex64, P)
                row = {"phase": 16, "name": "wire_complex", **where,
                       "comms": "bf16", "shape": [case["m"], case["n"]],
                       "s": max(r[0]["s"] for r in per_rank),
                       "launches": launches, "expected": expect,
                       "complex_compressed": any(
                           r[0]["census"]["complex_compressed"]
                           for r in per_rank),
                       "any_compressed": any(r[0]["census"]["compressed"]
                                             for r in per_rank),
                       "bit_identical_to_none": all(r[0]["bit_identical"]
                                                    for r in per_rank),
                       **_wire_census_row(r0["census"])}
                row["ok"] = (not row["complex_compressed"]
                             and not row["any_compressed"]
                             and row["bit_identical_to_none"]
                             and launches == expect
                             and sum(r[0]["none_launches"]["panel_qr_c64"]
                                     for r in per_rank) == expect)
                emit(row)
                if not row["ok"]:
                    raise AssertionError(f"wire complex failed: {row}")
        emit({"phase": 16, "name": "wire_run", "case": label, **where,
              "wall_s": wall_s})


def _check_wire_rows(case, per_rank, P, where, ne):
    """Each row-engine run against numpy's LAPACK QR (the reference's
    criterion), ``torch.linalg.lstsq``'s ratio printed beside it; the
    launches summed over the ranks are TSQR's plan (none for CholeskyQR)."""
    from dhqr_tpu_torch.ops import blocked

    m, n = case["m"], case["n"]
    A, b, oracle = oracle_of(m, n, np.float32, case["seed"])
    cuda = torch.device("cuda")
    nb = min(blocked.DEFAULT_BLOCK_SIZE, n)
    leaf = blocked.panel_plan(m // P, n, nb, True, torch.float32, cuda)
    combine = blocked.panel_plan(P * n, n, nb, True, torch.float32, cuda)
    per_rank_plan = sum(blocked.kernel_leaves(w, lw)
                        for _, w, lw in leaf + combine if lw)
    torch_ratio = ne(A, per_rank[0][0]["torch_lstsq_x"], b) / oracle
    for j, r0 in enumerate(per_rank[0]):
        rows = [r[j] for r in per_rank]
        launches = sum(r["launches"]["panel_qr_f32"] for r in rows)
        expect = P * per_rank_plan if r0["engine"] == "tsqr" else 0
        res = ne(A, r0["x"], b)
        row = {"phase": 16, "name": "wire_rows", **where,
               "engine": r0["engine"], "comms": r0["comms"],
               "shape": [m, n], "s": max(r["s"] for r in rows),
               "normal_eq_residual": res, "lapack_residual": oracle,
               "ratio": res / oracle, "torch_lstsq_ratio": torch_ratio,
               "criterion": CRITERION, "launches": launches,
               "expected": expect, **_wire_census_row(r0["census"])}
        row["ok"] = (bool(np.isfinite(res)) and res < CRITERION * oracle
                     and launches == expect
                     and all(r["census"]["formula_ok"] for r in rows))
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"wire row engine failed: {row}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="0,1,2,3,4,5,6,8,9,10,11,12,13,14,15,16",
                    help="comma-separated phases to run (0 always runs; 7, "
                         "the section timers, only on request)")
    ap.add_argument("--accuracy-seeds", type=int, default=1,
                    help="problem seeds of phase 8's factor-quality check "
                         "(kernel and plain loop, f32; default 1)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")} | {0}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import dhqr_tpu_torch as dt
        from dhqr_tpu_torch.ops import hopper_panel as hp
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2

    smi = phase_setup()
    stats = phase_kernels(args.seed) if 1 in phases else {}
    paths = {}  # launches per counted path: zeroed before it, read after

    def main_path():
        if 2 in phases:
            phase_square(dt, hp, args.seed)
        if 3 in phases:
            phase_tall(dt, hp, args.seed)
        if 4 in phases:
            phase_complex(dt, hp, args.seed)
        if 5 in phases:
            phase_reference(dt, hp, args.seed)

    def counted(key, drive):
        hp.reset_launches()
        drive()
        paths[key] = dict(hp.LAUNCHES)

    if phases & {2, 3, 4, 5}:
        counted("main", main_path)
    if 6 in phases:
        phase_breakdown(dt, args.seed)
    if 7 in phases:
        phase_kernel_profile(args.seed)
    if 8 in phases:
        counted("precision", lambda: (
            phase_precision_gemms(args.seed),
            phase_precision_qr(dt, hp, args.seed),
            phase_precision_lstsq(dt, args.seed),
            phase_factor_quality(dt, hp, args.seed, args.accuracy_seeds)))
    if 9 in phases:
        counted("tsqr", lambda: phase_engines(dt, hp, args.seed))
    if 10 in phases:
        counted("gradients", lambda: phase_gradients(dt, hp, args.seed))
    if 11 in phases:
        counted("schedules", lambda: phase_schedules(dt, hp, args.seed))
    if 12 in phases:
        counted("reconstruct", lambda: phase_reconstruct(dt, hp, args.seed))
    if 13 in phases:
        counted("sketch", lambda: phase_sketch(dt, args.seed))
    if 14 in phases:
        counted("sharded", lambda: phase_sharded(hp, args.seed))
    if 15 in phases:
        tallies = {}  # each path's launches as its own calls counted them
        counted("guarded", lambda: tallies.update(
            guarded=phase_guarded(dt, hp, args.seed, smi)))
        counted("update", lambda: tallies.update(
            update=phase_update(dt, hp, args.seed, smi)))
        for key, tally in tallies.items():
            if any(paths[key][k] != tally.get(k, 0) for k in paths[key]):
                raise AssertionError(f"the {key} path's count {paths[key]} "
                                     f"is not its calls' {tally}")
    if 16 in phases:
        counted("wire", lambda: phase_wire(hp, args.seed))
    emit({"launches_by_path": paths})
    for key in ("reconstruct", "sketch"):  # paths with no panel kernel on them
        if key in paths and any(paths[key].values()):
            raise AssertionError(f"the {key} path launched a panel kernel: "
                                 f"{paths[key]}")
    kernels = []
    on_paths = ("main", "tsqr", "gradients", "schedules", "sharded",
                "guarded", "wire")
    for name in hp.KERNELS.values():
        st = stats.get(name, {})
        for key in on_paths + (("update",) if name == "panel_qr_f32" else ()):
            if key in paths and paths[key][name] < 1:
                raise AssertionError(f"{name} never launched on the {key} "
                                     "path")
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in paths.values()),
            "max_abs_err": st.get("max_abs_err"), "ms": st.get("ms"),
            "plain_ms": st.get("plain_ms"), "bound_ms": st.get("bound_ms"),
            "bound_by": st.get("bound_by"),
            "library_ms": st.get("library_ms")})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
