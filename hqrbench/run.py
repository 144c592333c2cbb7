"""Run one cell of the benchmark once and print its result line.

    python3 -m hqrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (import, CUDA context, the port's kernel libraries, the cell's
inputs and warm-up calls) is timed as ``setup_s``; then the cell's calls
run for ``--seconds``. ``--trace 0`` prints the cell's end-to-end
metrics; ``--trace 1`` profiles a steady sub-window of whole calls
(``trace_seconds`` of the traffic file) and prints its per-layer metrics.
After the window the judge compares sampled outputs with the plain
reference; each number compared is printed beside its limit, last on
standard error and as the result line's last key, ``check``.

It runs on a CUDA card and nowhere else: without one (or with fewer than
the cell asks for) it exits non-zero and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Modules no run may hold once its window has closed, by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "dhqr_tpu")


def fixed_caches() -> None:
    """Every compile cache of the program in fixed directories inside the
    checkout, before the program is imported (the port's own nvcc
    libraries already go to ``build/``)."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> "list[str]":
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _finite(value):
    return value if isinstance(value, (int, float)) and math.isfinite(value) \
        else None


def run_cell(cell, seed: int, seconds: float, trace: bool, prog, device,
             t0: float) -> dict:
    """One run of ``cell`` (a :class:`hqrbench.spec.Cell`) against ``prog``
    on ``device``: the result line's fields, and ``notes`` for standard
    error (failed calls' errors, set-up steps, the window, the judge's
    time, the trace's classes by span)."""
    import torch

    from hqrbench import check, work
    from hqrbench.loop import TrafficLoop

    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    loop = TrafficLoop(cfg, traffic, prog, seed, device)
    marks = {"before_setup": time.perf_counter() - t0}
    loop.setup(marks, t0)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        seconds = min(seconds, float(traffic["trace_seconds"]))
    setup_s = time.perf_counter() - t0
    window = loop.window(seconds=seconds)
    if prof is not None:
        prof.stop()

    notes = {"errors": window.errors, "setup": marks, "window": {
        "seconds": window.seconds, "calls": window.completed,
        "peak_bytes": window.peak_bytes,
        "a_bytes": loop.inputs.m * loop.inputs.n * loop.inputs.dtype.itemsize,
        "mean_call_ms": 1e3 * sum(window.latencies)
        / max(1, window.completed)}}
    result = {"attempted": window.attempted, "failed": window.failed,
              "metrics": {}, "notes": notes}
    m, n = loop.inputs.m, loop.inputs.n
    if not trace:
        from hqrbench.stats import percentile

        values = {"setup_s": setup_s}
        if window.latencies:
            flops = loop.entry.flops(m, n) * window.completed
            values["gflops"] = flops / window.seconds / 1e9
            values["p90_solve_ms"] = percentile(window.latencies, 90) * 1e3
        for metric in cell.end_to_end:
            if metric["name"] in values:
                result["metrics"][metric["name"]] = {
                    "value": values[metric["name"]], "unit": metric["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": window.peak_bytes}
    if prof is not None:
        from hqrbench import spec, trace as tr

        t_read = time.perf_counter()
        view = tr.TraceView(tr.from_profiler(prof), window.completed, {
            "m": m, "n": n, "item": loop.inputs.dtype.itemsize,
            "peak": work.peaks()})
        del prof
        for metric in cell.per_layer:
            value = spec.reader(metric["name"])(view)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value,
                                                     "unit": metric["unit"]}
        device_info["busy_s"] = view.busy_seconds()
        device_info["window_s"] = view.window_seconds()
        result["breakdown"] = {"device_ops": view.top_device_ops(),
                               "idle_gaps": view.idle_gaps()}
        notes["trace"] = {
            "span_class_seconds": view.span_class_seconds(),
            "other_ops": [o for o in view.top_device_ops(40)
                          if o[0].startswith("[other]")][:12],
            "unattributed_ops": view.unattributed,
            "reduction_s": time.perf_counter() - t_read}
    result["device"] = device_info

    # The judge, once the window has closed and the peak is read; it keeps
    # only the sampled outputs (and the set-up factorization they used).
    loop.fact = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    found = check.numbers(loop.entry, loop.inputs, window)
    notes["judge_s"] = time.perf_counter() - t_judge
    ok, checks = check.verdict(found, cell.limits)
    result["correct"] = bool(ok and window.attempted > 0
                             and window.failed == 0)
    result["check"] = checks
    return result


def _power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err}"
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m hqrbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_caches()

    import torch

    from hqrbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"hqrbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import dhqr_tpu_torch

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      dhqr_tpu_torch, "cuda", _T0)
    notes = result.pop("notes")
    leaked = forbidden_modules()
    if leaked:
        print(f"hqrbench: the run loaded {leaked}", file=sys.stderr)
        return 3
    for err in notes.pop("errors"):
        print(f"hqrbench: failed {err}", file=sys.stderr)
    for key, value in notes.items():
        print(f"hqrbench: {key} {json.dumps(value)}", file=sys.stderr)
    print(f"hqrbench: card {_power()}", file=sys.stderr)
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": result["device"]}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["check"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                     for k, v in result["check"].items()}
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
