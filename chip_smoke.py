#!/usr/bin/env python3
"""On-card smoke run of dhqr_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed N] [--phases 0,1,2,3,4,5,6,8,9,10]

Needs one CUDA card (an H100 for the bounds below); exits non-zero without
one, and without the port beside it. Phases, each of which fails the run
on any error (0-6 and 8-10 run by default, 7 on request):

0. setup: the card's name and power limit, the nvcc build of the port's
   kernels (timed as set-up), and the full-FP32 matmul check;
1. every kernel against its plain PyTorch version on the card, at the
   leading panel shapes of the main, TSQR and gradient paths and at the
   shapes that stress the kernel's grid (an
   offset inside a CTA's slice, a ragged last CTA, a panel on a few CTAs,
   the tall 64-wide leaf, 12-decade data over every SM, and panels too
   tall for shared memory, which the kernel streams), with its grid,
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
   three witnesses (``torch.linalg.lstsq``; the port's factors with Q^H b
   through an explicit Q; the port on the plain panel loop);
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
   time against the forward alone, and the forward's kernel launches.

Launch counts are zeroed right before each counted path and read right
after it: the main path (phases 2-5), the precision path (8), the TSQR
path (9) and the gradient path (10); the ``kernels`` line sums them.
Phases 6 and 7 are measurements and are not counted. Each phase prints
JSON lines; then the ``kernels`` line, the card's ``nvidia-smi`` name and
power limit, and last the result line. Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
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
TOL_GRAM = 2e-5      # ||R^H R - A^H A|| / ||A^H A||, f32 TSQR R
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
    ]
    stats = {}
    for name, m, nb, off, decades, main_shape, resident in cases:
        dtype = torch.float32 if name.endswith("f32") else torch.complex64
        tol = TOL_F32 if dtype == torch.float32 else TOL_C64
        grid = hp.kernel_launch_info(m, nb, off, dtype)
        panel = random_panel(rng, m, nb, dtype, decades)
        pf, alpha = hp._panel_qr_kernel(panel, off)
        pf2, alpha2 = hp._panel_qr_kernel(panel, off)  # fixed-order merges
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
        if main_shape or not resident:
            row["ms"] = cuda_ms(lambda: hp._panel_qr_kernel(panel, off), 5)
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
    from dhqr_tpu_torch.utils.testing import (
        normal_equations_residual,
        oracle_residual,
    )

    for dtype, name in ((np.float32, "panel_qr_f32"),
                        (np.complex64, "panel_qr_c64")):
        A, b = random_problem(m, n, dtype, seed + 3)
        l0 = hp.LAUNCHES[name]
        x, t = wall(lambda: dt.lstsq(A, b))
        l_run = hp.LAUNCHES[name] - l0
        x = x.cpu().numpy()
        res = normal_equations_residual(A, x, b)
        oracle = oracle_residual(A, b)
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
    evaluated in float64 on the card is printed beside it, and both ratios
    of three witnesses: ``torch.linalg.lstsq`` on the card (a yardstick the
    port never calls), the port's own factors with Q^H b through an
    explicit Q, and the port with its panels on the plain panel loop
    (``use_pallas="never"``)."""
    from dhqr_tpu_torch.precision import POLICY_LADDER, PRECISION_POLICIES
    from dhqr_tpu_torch.utils.testing import lapack_lstsq

    cells = [(f"highest/{p.resolved_trailing()}/r{p.refine}", p)
             for p in POLICY_LADDER] + list(PRECISION_POLICIES.items())
    for dtype in (np.float32, np.complex64):
        A, b = random_problem(m, n, dtype, seed + 3)
        x_lapack = lapack_lstsq(A, b)
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
            "port_qr_explicit_q": explicit_q,
            "port_plain_panels": lambda: dt.lstsq(At, bt, use_pallas="never")}
        for name, fn in witnesses.items():
            x, t = wall(fn)
            emit({"phase": 8, "name": "lstsq_witness", "solver": name,
                  "dtype": np.dtype(dtype).name, "shape": [m, n], "s": t,
                  "ratio_to_lapack": ne(x.cpu().numpy()) / oracle,
                  "ratio_to_lapack_f64_eval": ne64(x) / oracle64})
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,8,9,10",
                    help="comma-separated phases to run (0 always runs; 7, "
                         "the section timers, only on request)")
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
        counted("precision", lambda: (phase_precision_gemms(args.seed),
                                      phase_precision_qr(dt, hp, args.seed),
                                      phase_precision_lstsq(dt, args.seed)))
    if 9 in phases:
        counted("tsqr", lambda: phase_engines(dt, hp, args.seed))
    if 10 in phases:
        counted("gradients", lambda: phase_gradients(dt, hp, args.seed))
    emit({"launches_by_path": paths})
    kernels = []
    for name in hp.KERNELS.values():
        st = stats.get(name, {})
        for key in ("main", "tsqr", "gradients"):
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
