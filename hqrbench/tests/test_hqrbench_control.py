"""A run with the control (the plain reference, GEMMs in TF32) in the
program's place comes out not correct in every cell, at a size a test run
holds; the program itself comes out correct. The same control at the
cells' own sizes runs on the card: ``python3 -m hqrbench.control``."""

import time

import pytest

import dhqr_tpu_torch
from hqrbench import spec
from hqrbench.control import Control, readings
from hqrbench.run import run_cell

# BENCHMARK.json's cells, and lsq131k.resolve: no cell names its mix now
# (its runs spread with the host's speed), but its entry, traffic and
# limits stay for a later cell, so they stay proven here.
BENCH = spec.load_benchmark()
BENCH["workloads"].append({"name": "lsq131k.resolve", "config": "lsq131k_f32",
                           "traffic": "resolve", "chips": 1, "why": "kept"})
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"m": 1024, "n": 256}


def small(cell: str):
    c = spec.load_cell(cell, BENCH)
    c.config = dict(c.config, **SMALL)
    return c


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = run_cell(small(cell), 2 ** 35 + 17, 0.3, False, Control, "cpu",
                 time.perf_counter())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["correct"] is False
    failing = [k for k, v in r["check"].items() if not v["value"] <= v["limit"]]
    assert failing, r["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    r = run_cell(small(cell), 2 ** 35 + 17, 0.3, False, dhqr_tpu_torch, "cpu",
                 time.perf_counter())
    assert r["correct"] is True, r["check"]
    assert set(r["metrics"]) == {"setup_s", "gflops", "p90_solve_ms"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_run_gives_each_side_its_verdict(cell):
    c = small(cell)
    found = readings(c, dhqr_tpu_torch, 2 ** 35 + 19, "cpu")
    assert found["correct"] is True
    found = readings(c, Control, 2 ** 35 + 19, "cpu")
    assert found["failed"] == 0 and found["correct"] is False
