#!/usr/bin/env python3
"""Time the Hopper panel kernels of one checkout of dhqr_tpu_torch, so that
two checkouts can be compared in turns on one card.

    cd <checkout> && python3 <path to>/panel_ab.py TAG [--sections]

Imports ``dhqr_tpu_torch`` from the current directory (whichever checkout
that is: this script may live in another), builds its kernels, and prints
one JSON line ``{"tag": TAG, "rows": {...}}``: for each of ``chip_smoke.py``
phase 1's timed shapes, five device times in ms, each the mean of ten
launches of the kernel wrapper (CUDA events, after one warm-up); a checkout
whose kernels do not take a shape's type (float64 before it had a kernel)
leaves that shape out. With
``--sections`` it prints ``{"tag": TAG, "cycles": {...}}`` instead: the
SM cycles per column of each section of a column step (merge, column pass,
trailing pass, grid barrier), the mean over the CTAs, from three launches
of the timed build (``hopper_panel.kernel_section_cycles``) after one.
Run parent, change, change, parent in one call and compare medians. Needs
one CUDA card.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from dhqr_tpu_torch.ops import hopper_panel as hp  # noqa: E402

SHAPES = [("f32", 16384, 128, 0, None), ("f32", 65536, 128, 0, None),
          ("f32", 524288, 16, 0, None), ("c64", 8192, 128, 0, None),
          ("c64", 32768, 128, 7, None), ("c64", 262144, 16, 3, None),
          ("f32", 16384, 128, 0, 66), ("c64", 8192, 128, 0, 66),
          ("f32", 131072, 32, 0, None), ("f32", 131072, 32, 96, None),
          ("c64", 65536, 32, 3, None), ("f32", 65536, 64, 0, None),
          ("f32", 100000, 64, 0, None), ("c64", 100000, 32, 0, None),
          ("f64", 4400, 128, 0, None), ("f64", 4400, 128, 1984, None),
          ("f64", 4400, 128, 3968, None), ("f64", 16384, 128, 0, None),
          ("f64", 131072, 16, 0, None), ("f64", 131072, 32, 0, None),
          ("f64", 262144, 16, 3, None)]
DTYPES = {"f32": torch.float32, "c64": torch.complex64, "f64": torch.float64}
SECTION_SHAPES = [("f32", 16384, 128), ("c64", 8192, 128),
                  ("f32", 524288, 16), ("c64", 262144, 16),
                  ("f32", 131072, 32), ("c64", 65536, 32),
                  ("f32", 65536, 64)]


def _panel(g, name, m, nb):
    return torch.randn((m, nb), generator=g, device="cuda",
                       dtype=DTYPES[name])


def times(g) -> dict:
    out = {}
    for name, m, nb, off, cap in SHAPES:
        if DTYPES[name] not in hp.KERNELS:
            continue
        panel = _panel(g, name, m, nb)

        def launch():
            return hp._panel_qr_kernel(panel, off, cap)

        launch()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                launch()
            stop.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(stop) / 10)
        out[f"{name} {m}x{nb} off{off} cap{cap}"] = ts
    return out


def sections(g) -> dict:
    out = {}
    for name, m, nb in SECTION_SHAPES:
        panel = _panel(g, name, m, nb)
        reps = [hp.kernel_section_cycles(panel) for _ in range(4)][1:]
        out[f"{name} {m}x{nb}"] = {
            s: [round(r["mean"][s], 1) for r in reps]
            for s in hp.PROFILE_SECTIONS}
    return out


def main(argv) -> int:
    if len(argv) < 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(0)
    if "--sections" in argv[1:]:
        print(json.dumps({"tag": argv[0], "cycles": sections(g)}), flush=True)
    else:
        print(json.dumps({"tag": argv[0], "rows": times(g)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
