#!/usr/bin/env python3
"""On-card smoke run of dhqr_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed N] [--phases 0,1,2,3,4,5,6]

Needs one CUDA card (an H100 for the bounds below); exits non-zero without
one, and without the port beside it. Phases, each of which fails the run
on any error:

0. setup: the card's name and power limit, the nvcc build of the port's
   kernels (timed as set-up), and the full-FP32 matmul check;
1. every kernel against its plain PyTorch version on the card, at the main
   path's panel shapes, with its time, the plain version's time,
   ``torch.geqrf``'s time on the same panel (a yardstick the port never
   calls) and the card's bound for the work;
2. main path, float32, square: ``qr`` -> ``solve`` and ``lstsq`` at
   16384 x 16384, backward error and kernel launch counts;
3. main path, float32, tall: ``lstsq`` at 65536 x 256 against
   ``torch.linalg.lstsq`` (yardstick) on the normal-equations residual;
4. main path, complex64: ``qr`` -> ``solve`` at 8192 x 4096;
5. the reference's criterion: ``lstsq`` at 4400 x 4000, float32 and
   complex64, within 8x of numpy's LAPACK QR on the normal-equations
   residual;
6. where the time goes: ``torch.profiler`` device time of one 16384^2
   float32 ``qr`` by kernel class (panel kernel, GEMM, triangular solve,
   other) and the device's busy share of the call's wall time.

Launch counts are zeroed right before phase 2 and read right after
phase 5 (phase 6 is a measurement and is not counted). Each phase prints one JSON line; then the ``kernels`` line, the
card's ``nvidia-smi`` name and power limit, and last the result line.
Imports nothing of JAX or of the JAX package.
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


# -- the reference's oracle (a copy of dhqr_tpu/utils/testing.py's) ----------

def normal_equations_residual(A, x, b) -> float:
    Ah = A.conj().T
    return float(np.linalg.norm(Ah @ A @ x - Ah @ b))


def oracle_residual(A, b) -> float:
    import scipy.linalg

    Q, R = np.linalg.qr(A, mode="reduced")
    x = scipy.linalg.solve_triangular(R, Q.conj().T @ b, lower=False)
    return normal_equations_residual(A, x, b)


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
    from dhqr_tpu_torch.ops.hopper_panel import _launcher, KERNELS

    for name in KERNELS.values():
        _launcher(name)
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
    cases = [  # (kernel, m, nb, offset, 12-decade data, main-path shape)
        ("panel_qr_f32", 16384, 128, 0, False, True),
        ("panel_qr_f32", 8193, 128, 0, False, False),
        ("panel_qr_f32", 4096, 32, 5, False, False),
        ("panel_qr_f32", 767, 8, 0, True, False),
        ("panel_qr_c64", 8192, 128, 0, False, True),
        ("panel_qr_c64", 4096, 32, 5, False, False),
    ]
    stats = {}
    for name, m, nb, off, decades, main_shape in cases:
        dtype = torch.float32 if name.endswith("f32") else torch.complex64
        tol = TOL_F32 if dtype == torch.float32 else TOL_C64
        panel = random_panel(rng, m, nb, dtype, decades)
        pf, alpha = hp._panel_qr_kernel(panel, off)
        torch.cuda.synchronize()
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
               "rel_err_pf": err_pf, "rel_err_alpha": err_alpha,
               "max_abs_err": abs_err, "tol": tol, "rows_above_kept": kept,
               "finite": finite}
        ok = err_pf <= tol and err_alpha <= tol and kept and finite
        if decades:
            s64 = float(np.linalg.norm(panel[:, 0].double().cpu().numpy()))
            dev = abs(abs(float(alpha[0])) - s64) / s64
            row.update(alpha0_rel_dev=dev, tol_decades=TOL_DECADES)
            ok = ok and dev < TOL_DECADES
        if main_shape:
            row["ms"] = cuda_ms(lambda: hp._panel_qr_kernel(panel, off), 5)
            at2 = panel.T.contiguous()
            row["plain_ms"] = cuda_ms(
                lambda: hp._PLAIN[dtype](at2.copy_(panel.T), off), 2)
            row["library_ms"] = cuda_ms(lambda: torch.geqrf(panel), 5)
            row["bound_ms"], row["bound_by"] = panel_bound(
                m, nb, dtype == torch.complex64)
        row["ok"] = ok
        emit(row)
        if not ok:
            raise AssertionError(f"kernel check failed: {row}")
        st = stats.setdefault(name, {"max_abs_err": 0.0})
        st["max_abs_err"] = max(st["max_abs_err"], abs_err)
        if main_shape:
            st.update({k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")})
        del panel, pf, at, pf_p
    torch.cuda.empty_cache()
    return stats


def expected_launches(m, n, dtype):
    """Kernel leaves the blocked engine's own routing chooses for (m, n)."""
    from dhqr_tpu_torch.ops import blocked

    nb = blocked.DEFAULT_BLOCK_SIZE
    kernel = blocked._resolve_kernel("auto", m, min(nb, n), dtype,
                                     torch.device("cuda"))
    plan = blocked.panel_plan(m, n, nb, kernel, dtype)
    off = [k for k, w, on in plan if not on]
    if off:
        print(f"panels not on the kernel for {m}x{n} {dtype}: columns {off}",
              flush=True)
    return sum(blocked.kernel_leaves(w) for k, w, on in plan if on)


def phase_square(dt, hp, seed, n=16384):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.rand((n, n), generator=g, device="cuda", dtype=torch.float32)
    b = torch.rand((n,), generator=g, device="cuda", dtype=torch.float32)
    expect = expected_launches(n, n, torch.float32)
    l0 = hp.LAUNCHES["panel_qr_f32"]
    fact, t_factor = wall(lambda: dt.qr(A))
    l_qr = hp.LAUNCHES["panel_qr_f32"] - l0
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
           "factor_s": t_factor, "solve_s": t_solve, "lstsq_s": t_lstsq,
           "gflops": flops / t_factor / 1e9, "geqrf_s": t_geqrf,
           "geqrf_gflops": flops / t_geqrf / 1e9,
           "backward_error": backward, "tol_backward": TOL_BACKWARD_F32,
           "x_vs_lstsq": agree, "bit_equal": bool(torch.equal(x, x2)),
           "launches_qr": l_qr, "launches_qr_lstsq": l_all,
           "expected_per_factorization": expect, "finite": finite}
    row["ok"] = (backward < TOL_BACKWARD_F32 and agree <= TOL_SOLVE_AGREE
                 and finite and expect >= 1 and l_qr == expect
                 and l_all == 2 * expect)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"main path f32 square failed: {row}")


def phase_tall(dt, hp, seed, m=65536, n=256):
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    A = torch.rand((m, n), generator=g, device="cuda", dtype=torch.float32)
    b = torch.rand((m,), generator=g, device="cuda", dtype=torch.float32)
    expect = expected_launches(m, n, torch.float32)
    l0 = hp.LAUNCHES["panel_qr_f32"]
    x, t_lstsq = wall(lambda: dt.lstsq(A, b))
    l_run = hp.LAUNCHES["panel_qr_f32"] - l0
    x_ref, t_ref = wall(lambda: torch.linalg.lstsq(A, b[:, None]).solution[:, 0])
    A64, b64 = A.double(), b.double()

    def ne_res(xx):
        return float(torch.linalg.vector_norm(A64.T @ (A64 @ xx.double() - b64)))

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


def phase_complex(dt, hp, seed, m=8192, n=4096):
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    A = torch.complex(torch.rand((m, n), generator=g, device="cuda"),
                      torch.rand((m, n), generator=g, device="cuda"))
    b = torch.complex(torch.rand((m,), generator=g, device="cuda"),
                      torch.rand((m,), generator=g, device="cuda"))
    expect = expected_launches(m, n, torch.complex64)
    l0 = hp.LAUNCHES["panel_qr_c64"]
    fact, t_factor = wall(lambda: dt.qr(A))
    l_qr = hp.LAUNCHES["panel_qr_c64"] - l0
    x, t_solve = wall(lambda: fact.solve(b))
    R = torch.cat([fact.r_matrix(), A.new_zeros((m - n, n))])
    QR = fact.matmul_q(R)
    backward = float(torch.linalg.vector_norm((QR - A).to(torch.complex128))
                     / torch.linalg.vector_norm(A.to(torch.complex128)))
    finite = bool(torch.isfinite(torch.view_as_real(x)).all())
    row = {"phase": 4, "name": "main_c64", "shape": [m, n],
           "factor_s": t_factor, "solve_s": t_solve,
           "gflops_real": 4 * (2 * m * n * n - 2.0 / 3.0 * n ** 3) / t_factor / 1e9,
           "backward_error": backward, "tol_backward": TOL_BACKWARD_C64,
           "launches_qr": l_qr, "expected": expect, "finite": finite}
    row["ok"] = backward < TOL_BACKWARD_C64 and finite and l_qr == expect
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"main path c64 failed: {row}")


def phase_reference(dt, hp, seed, m=4400, n=4000):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="0,1,2,3,4,5,6",
                    help="comma-separated phases to run (0 always runs)")
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
    hp.reset_launches()  # counts from here on are the main path's
    if 2 in phases:
        phase_square(dt, hp, args.seed)
    if 3 in phases:
        phase_tall(dt, hp, args.seed)
    if 4 in phases:
        phase_complex(dt, hp, args.seed)
    if 5 in phases:
        phase_reference(dt, hp, args.seed)
    counts = dict(hp.LAUNCHES)
    if 6 in phases:
        phase_breakdown(dt, args.seed)
    main_path = phases & {2, 3, 4, 5}
    kernels = []
    for name in hp.KERNELS.values():
        st = stats.get(name, {})
        if main_path and counts[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
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
