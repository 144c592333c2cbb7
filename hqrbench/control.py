"""The control, and the run that sets each limit from readings.

The control is the plain reference put in the program's place with its
GEMMs in TF32, the precision just below the configurations' full FP32:
the judge has to find it not correct.

    python3 -m hqrbench.control --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6] [--calls N]

runs, in one process on the card, ``--calls`` calls (default: the mix's
``check_calls``) of the cell's traffic at its own sizes for each seed,
through the program and then through the control, and prints each seed's
numbers as JSON lines with the judge's verdict on them against the cell's
limits (``correct``), ending with the largest of the program's numbers,
the smallest of the control's, and each side's verdicts. The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from hqrbench.reference import householder as ref


class ControlFactorization:
    def __init__(self, H, alpha):
        self.H, self.alpha = H, alpha

    def solve(self, b):
        return ref.solve(self.H, self.alpha, b, tf32=True)


class Control:
    """``qr`` / ``lstsq`` / ``fact.solve`` of the reference, GEMMs in TF32."""

    @staticmethod
    def qr(A, device=None, **options):
        return ControlFactorization(*ref.qr(A, tf32=True))

    @staticmethod
    def lstsq(A, b, device=None, **options):
        return ref.lstsq(A, b, tf32=True)


def readings(cell, prog, seed: int, device, calls: "int | None" = None
             ) -> dict:
    """The judge's numbers for ``calls`` calls of ``cell`` through
    ``prog``, ``failed`` calls, and ``correct``: the verdict a run with
    these calls would print."""
    import torch

    from hqrbench import check
    from hqrbench.loop import TrafficLoop

    loop = TrafficLoop(cell.config, cell.traffic, prog, seed, device)
    loop.setup()
    window = loop.window(calls=calls or int(cell.traffic["check_calls"]))
    loop.fact = None
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    found = check.numbers(loop.entry, loop.inputs, window)
    ok, _ = check.verdict(found, cell.limits)
    found["failed"] = window.failed
    found["correct"] = bool(ok and window.failed == 0)
    return found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m hqrbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--calls", type=int, default=None)
    args = p.parse_args(argv)

    from hqrbench.run import fixed_caches

    fixed_caches()
    import torch

    from hqrbench import spec

    if not torch.cuda.is_available():
        print("hqrbench.control: no CUDA device", file=sys.stderr)
        return 2
    import dhqr_tpu_torch

    cell = spec.load_cell(args.workload)
    worst, least = {}, {}
    verdicts = {"program": [], "control": []}
    sides = [("program", dhqr_tpu_torch, args.seeds, worst, max),
             ("control", Control, args.control_seeds, least, min)]
    for side, prog, seeds, acc, pick in sides:
        for seed in (int(s) for s in seeds.split(",") if s):
            t = time.perf_counter()
            found = readings(cell, prog, seed, "cuda", args.calls)
            print(json.dumps({"side": side, "seed": seed, **found,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
            verdicts[side].append(found.pop("correct"))
            for k, v in found.items():
                acc[k] = v if k not in acc else pick(acc[k], v)
    print(json.dumps({"workload": args.workload, "program_max": worst,
                      "control_min": least, "limits": cell.limits,
                      "program_correct": verdicts["program"],
                      "control_correct": verdicts["control"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
