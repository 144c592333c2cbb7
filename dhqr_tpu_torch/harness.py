"""Correctness + benchmark harness — the reference's de-facto CLI, ported
from ``dhqr_tpu/harness.py``.

The reference's only operational entry point is ``julia test/runtests.jl
<np>`` (reference test/runtests.jl:4): it spins up ``np`` workers, sweeps
problem sizes and element types, checks the normal-equations residual
against LAPACK with tolerance factor 8, and prints slowdown ratios
(runtests.jl:41-93). This module is that harness on the port:

    python -m dhqr_tpu_torch.harness [n_ranks]
        [--sizes 110x100,1100x1000] [--dtypes float32,float64,complex128]
        [--layout block|cyclic] [--engine ...] [--bench]
        [--profile-dir DIR] [--device cpu]

``n_ranks`` plays the role of ``ARGS[1] = np``. One rank runs the
single-device path (``mesh=None``); more spawn that many processes
(:func:`~dhqr_tpu_torch.parallel._ranks.run_ranks`, the reference's
``addprocs(np)``), NCCL when every rank has a card of its own, else gloo
(the CPU, or ranks sharing the card). Rank 0's results are printed.

The device follows the port's rule: the CUDA card unless ``--device cpu``
asks for the CPU; without CUDA and without ``--device cpu`` the harness
exits non-zero with the rule's message. Every dtype given runs (float64 /
complex128 take the plain panel path; the JAX package skips them on a
TPU).

Engine options take a CLI flag first, then the ``DHQR_*`` variables
(:meth:`DHQRConfig.from_env`), then the default, with the JAX harness's
warnings and usage errors for the combinations an engine refuses.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

#: A multi-rank sweep's time limit (the spawn, every size, the profile).
RANKS_TIMEOUT_S = 3600.0


def _parse_sizes(text: str):
    out = []
    for tok in text.split(","):
        m, n = tok.lower().split("x")
        out.append((int(m), int(n)))
    return out


def _panel_impl_arg(raw: str) -> str:
    # Parse-time validation mirroring the model's panel_impl check, so the
    # reconstruct:<chunk> spelling is CLI-reachable and a typo dies as a
    # usage error before any device work.
    if raw in ("loop", "recursive"):
        return raw
    if raw.startswith("reconstruct"):
        from dhqr_tpu_torch.ops.blocked import _reconstruct_chunk

        try:
            _reconstruct_chunk(raw)
        except ValueError as e:
            raise argparse.ArgumentTypeError(str(e))
        return raw
    raise argparse.ArgumentTypeError(
        f"must be loop, recursive, reconstruct or reconstruct:<chunk>, "
        f"got {raw!r}")


def _agg_panels_arg(raw: str) -> int:
    # "0" means off, matching the DHQR_AGG_PANELS spelling; it survives to
    # the overrides merge (an explicit --agg-panels 0 cancels an ambient
    # env value) and is normalized to None after.
    v = int(raw)
    if v == 1 or v < 0:
        raise argparse.ArgumentTypeError(f"must be 0 (off) or >= 2, got {v}")
    return v


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m dhqr_tpu_torch.harness",
        description="Correctness sweep + LAPACK-relative benchmark "
        "(the reference's runtests.jl harness, on the PyTorch port).",
    )
    parser.add_argument(
        "n_ranks", nargs="?", type=int, default=2,
        help="mesh size (reference ARGS[1] = worker count; default 2)",
    )
    parser.add_argument(
        "--sizes", default="110x100,550x500,1100x1000",
        help="comma-separated mxn problem sizes (reference sweeps m=1.1n)",
    )
    parser.add_argument(
        "--dtypes", default="float64,complex128",
        help="comma-separated dtypes (reference: Float64, ComplexF64)",
    )
    # None sentinels: precedence is CLI flag > DHQR_* > library default.
    parser.add_argument("--layout", default=None, choices=["block", "cyclic"])
    parser.add_argument(
        "--engine", default=None,
        choices=["householder", "tsqr", "cholqr2", "cholqr3"],
        help="least-squares engine family (tsqr/cholqr shard ROWS; their "
        "mesh uses the same rank count)",
    )
    parser.add_argument("--block-size", type=int, default=None)
    parser.add_argument(
        "--panel-impl", default=None, type=_panel_impl_arg,
        help="panel-interior algorithm for the blocked householder "
        "engines: loop, recursive, reconstruct, or reconstruct:<chunk>",
    )
    parser.add_argument(
        "--trailing-precision", default=None,
        choices=["default", "high", "highest"],
        help="matmul precision for the trailing-update GEMMs only (blocked "
        "householder engines; 'high'/'default' are 3/1 bf16 passes)",
    )
    parser.add_argument(
        "--lookahead", action="store_true", default=None,
        help="one-panel-lookahead schedule on the blocked householder "
        "engines (see DHQRConfig.lookahead)",
    )
    parser.add_argument(
        "--agg-panels", type=_agg_panels_arg, default=None,
        help="aggregate the trailing update over this many consecutive "
        "panels; 0 = off (blocked householder engines)",
    )
    parser.add_argument(
        "--guards", default=None, choices=["screen", "fallback", "full"],
        help="numeric guardrails for every solve in the sweep "
        "(dhqr_tpu_torch.numeric): a problem no rung answers fails TYPED",
    )
    parser.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler Chrome trace here (the @profilehtml "
        "analogue)",
    )
    parser.add_argument(
        "--bench", action="store_true",
        help="also time factor+solve and print slowdown vs numpy/LAPACK "
        "(reference runtests.jl:84-89)",
    )
    parser.add_argument(
        "--device", default=None,
        help="'cpu' runs the port's plain PyTorch path on the CPU; default "
        "the CUDA card",
    )
    return parser


def _resolve_config(parser, args, n_ranks: int):
    """The JAX harness's precedence and conflict rules: an explicit flag
    conflict is a usage error, an env-sourced one warns and is dropped."""
    from dhqr_tpu_torch.utils.config import DHQRConfig

    overrides = {k: v for k, v in {
        "layout": args.layout, "engine": args.engine,
        "block_size": args.block_size, "panel_impl": args.panel_impl,
        "trailing_precision": args.trailing_precision,
        "lookahead": args.lookahead,
        "agg_panels": args.agg_panels,
        "guards": args.guards,
    }.items() if v is not None}
    cfg = DHQRConfig.from_env(**overrides)
    if cfg.agg_panels == 0:  # explicit --agg-panels 0 = off
        cfg = dataclasses.replace(cfg, agg_panels=None)
    row_engine = cfg.engine != "householder"
    if row_engine and cfg.layout != "block":
        if args.layout is not None:
            parser.error(f"--layout={cfg.layout} applies to the householder "
                         f"engines only (engine={cfg.engine})")
        print(f"# warning: DHQR_LAYOUT={cfg.layout} ignored — layout "
              f"applies to the householder engines only "
              f"(engine={cfg.engine}); using 'block'", file=sys.stderr)
        cfg = dataclasses.replace(cfg, layout="block")
    why = (f"engine={cfg.engine}" if cfg.engine != "householder"
           else "blocked=False")
    blocked_hh = cfg.engine == "householder" and cfg.blocked
    if cfg.trailing_precision is not None and not blocked_hh:
        if args.trailing_precision is not None:
            parser.error(f"--trailing-precision applies to the blocked "
                         f"householder engines only ({why})")
        print(f"# warning: DHQR_TRAILING_PRECISION="
              f"{cfg.trailing_precision} ignored — it applies to the "
              f"blocked householder engines only ({why})", file=sys.stderr)
        cfg = dataclasses.replace(cfg, trailing_precision=None)
    if cfg.lookahead and not blocked_hh:
        if args.lookahead is not None:
            parser.error(f"--lookahead applies to the blocked householder "
                         f"engines only ({why})")
        print(f"# warning: DHQR_LOOKAHEAD ignored — it applies to the "
              f"blocked householder engines only ({why})", file=sys.stderr)
        cfg = dataclasses.replace(cfg, lookahead=False)
    if cfg.agg_panels and cfg.lookahead and n_ranks == 1:
        # Mutually exclusive on one device; a mesh composes them.
        if args.agg_panels is not None and args.lookahead is not None:
            parser.error("--agg-panels and --lookahead are mutually "
                         "exclusive schedules on one device (a mesh "
                         "composes them as grouped lookahead)")
        if args.agg_panels is not None:  # lookahead came from the env
            print("# warning: DHQR_LOOKAHEAD ignored — mutually exclusive "
                  "with the explicit --agg-panels on one device",
                  file=sys.stderr)
            cfg = dataclasses.replace(cfg, lookahead=False)
        else:
            print("# warning: DHQR_AGG_PANELS ignored — mutually exclusive "
                  "with lookahead on one device", file=sys.stderr)
            cfg = dataclasses.replace(cfg, agg_panels=None)
    if cfg.agg_panels and not blocked_hh:
        if args.agg_panels is not None:
            parser.error(f"--agg-panels applies to the blocked "
                         f"householder engines only ({why})")
        print(f"# warning: DHQR_AGG_PANELS ignored — it applies to the "
              f"blocked householder engines only ({why})", file=sys.stderr)
        cfg = dataclasses.replace(cfg, agg_panels=None)
    return cfg


def _plan_cases(args, cfg, n_ranks: int):
    """(dtype name, m, n, on the mesh, note) per sweep row, in order: the
    row engines' m rounded up to a multiple of the ranks, and a tsqr size
    whose row blocks would not stay tall run on one device."""
    row_engine = cfg.engine != "householder"
    cases = []
    for dtype_name in args.dtypes.split(","):
        dtype_name = dtype_name.strip()
        for m, n in _parse_sizes(args.sizes):
            if n_ranks > 1 and row_engine and m % n_ranks:
                m += n_ranks - m % n_ranks
            on_mesh, note = n_ranks > 1, None
            if on_mesh and cfg.engine == "tsqr" and m // n_ranks < n:
                note = f"# {m}x{n}: m/P < n, tsqr runs single-device"
                on_mesh = False
            cases.append((dtype_name, m, n, on_mesh, note))
    return cases


def _sweep(cases, cfg, bench: bool, profile_dir, device, meshes=None,
           rank: int = 0) -> list:
    """Solve every case; one row per case: ``{"x", "t", "t_warm"}`` or
    ``{"error": (class name, message)}`` for a typed numerical refusal.
    On a mesh every rank solves the mesh cases; a single-device case runs
    on rank 0 alone."""
    import numpy as np

    import dhqr_tpu_torch as dt
    from dhqr_tpu_torch.interop import to_numpy
    from dhqr_tpu_torch.utils.profiling import PhaseTimer, sync, trace
    from dhqr_tpu_torch.utils.testing import random_problem

    row_engine = cfg.engine != "householder"
    rows = []
    for dtype_name, m, n, on_mesh, _ in cases:
        mesh = None
        if on_mesh:
            mesh = meshes["rows" if row_engine else "cols"]
        elif rank != 0:
            rows.append(None)
            continue
        A, b = random_problem(m, n, np.dtype(dtype_name), seed=0)
        timer = PhaseTimer()
        try:
            with timer.measure("factor+solve"):
                x = dt.lstsq(A, b, config=cfg, mesh=mesh, device=device)
                timer.observe(x)
        except dt.NumericalError as e:
            rows.append({"error": (type(e).__name__, str(e))})
            continue
        row = {"x": to_numpy(x), "t": timer.total("factor+solve")}
        if bench:
            # warm run: the first one above holds first-use set-up
            with timer.measure("warm"):
                x = dt.lstsq(A, b, config=cfg, mesh=mesh, device=device)
                timer.observe(x)
            row["t_warm"] = timer.total("warm")
        rows.append(row)
    if profile_dir:
        A, b = random_problem(512, 256, np.float32, seed=1)
        with trace(profile_dir):
            x = dt.lstsq(A, b, mesh=None if meshes is None
                         else meshes["cols"], device=device)
            sync(x)
    return rows


def _rank_sweep(device, cases, cfg, bench, profile_dir, per_card):
    """One rank of a multi-rank sweep (run by ``run_ranks``): this rank's
    rows and its panel-kernel launches."""
    import torch
    import torch.distributed as dist

    from dhqr_tpu_torch import parallel
    from dhqr_tpu_torch.ops import hopper_panel as hp

    rank = dist.get_rank()
    if per_card:  # NCCL: every rank has a card of its own
        device = f"cuda:{rank}"
        torch.cuda.set_device(device)
    hp.reset_launches()
    meshes = {"cols": parallel.column_mesh(device=device),
              "rows": parallel.row_mesh(device=device)}
    rows = _sweep(cases, cfg, bench, profile_dir, device, meshes, rank)
    return {"rows": rows, "launches": dict(hp.LAUNCHES)}


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    n_ranks = args.n_ranks
    if n_ranks < 1:
        parser.error(f"n_ranks must be >= 1, got {n_ranks}")

    import numpy as np
    import torch

    from dhqr_tpu_torch.utils.device import resolve_device
    from dhqr_tpu_torch.utils.testing import (
        TOLERANCE_FACTOR,
        lapack_lstsq,
        normal_equations_residual,
        oracle_residual,
        random_problem,
    )

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"harness: {e}", file=sys.stderr)
        return 2
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _resolve_config(parser, args, n_ranks)
    row_engine = cfg.engine != "householder"

    from dhqr_tpu_torch.parallel._ranks import rank_backend

    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend, per_card = rank_backend(dev, n_ranks)
    backend = "none" if n_ranks == 1 else backend
    ranks_per_card = 1 if per_card or dev.type != "cuda" else n_ranks
    print(f"# devices: {cards or 1} ({dev.type}), mesh size: {n_ranks}, "
          f"backend: {backend}, ranks per card: {ranks_per_card}, "
          f"engine: {cfg.engine}"
          + ("" if row_engine else f", layout: {cfg.layout}"), flush=True)

    cases = _plan_cases(args, cfg, n_ranks)
    if n_ranks == 1:
        rows = _sweep(cases, cfg, args.bench, args.profile_dir, str(dev))
    else:
        # by its module's name: under ``python -m`` this file is __main__,
        # which a spawned rank cannot import
        from dhqr_tpu_torch.harness import _rank_sweep as worker
        from dhqr_tpu_torch.ops import hopper_panel as hp
        from dhqr_tpu_torch.parallel._ranks import run_ranks

        out = run_ranks(worker, n_ranks, backend=backend,
                        device="cuda:0" if dev.type == "cuda" else "cpu",
                        timeout_s=RANKS_TIMEOUT_S, cases=cases, cfg=cfg,
                        bench=args.bench, profile_dir=args.profile_dir,
                        per_card=per_card)
        # the ranks' launches count as this process's sweep
        for r in out:
            for name, count in r["launches"].items():
                hp.LAUNCHES[name] += count
        rows = out[0]["rows"]
        for i, row in enumerate(rows):  # the slowest rank's times
            if row is not None and "t" in row:
                row["t"] = max(r["rows"][i]["t"] for r in out)
                if "t_warm" in row:
                    row["t_warm"] = max(r["rows"][i]["t_warm"] for r in out)

    failures = 0
    for (dtype_name, m, n, _, note), row in zip(cases, rows):
        if note:
            print(note)
        if "error" in row:
            failures += 1
            print(f"FAIL  {m}x{n} {dtype_name:<10} typed "
                  f"{row['error'][0]}: {row['error'][1]}")
            continue
        A, b = random_problem(m, n, np.dtype(dtype_name), seed=0)
        res = normal_equations_residual(A, row["x"], b)
        ref = oracle_residual(A, b)
        # EXACTLY the reference's acceptance rule: normal-equations
        # residual < 8x LAPACK's (runtests.jl:62,81).
        tol = TOLERANCE_FACTOR * ref
        ok = res < tol
        failures += 0 if ok else 1
        print(f"{'ok' if ok else 'FAIL'}  {m}x{n} {dtype_name:<10} residual "
              f"{res:.3e} (LAPACK {ref:.3e}, tol {tol:.3e})  "
              f"t={row['t']:.3f}s")
        if args.bench:
            # dhqr: ignore[DHQR008] benchmarking the LAPACK oracle's real wall time — the CLI owns its clock
            t0 = time.perf_counter()
            lapack_lstsq(A, b)
            # dhqr: ignore[DHQR008] same measurement, closing read
            t_lapack = time.perf_counter() - t0
            # the reference prints "slowdown of distributed+threaded vs
            # stdlib" (runtests.jl:88); same ratio here
            print(f"      slowdown vs LAPACK (warm): "
                  f"{row['t_warm'] / max(t_lapack, 1e-9):.2f}x")
    if args.profile_dir:
        print(f"# profiler trace written to {args.profile_dir}")
    sys.stdout.flush()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
